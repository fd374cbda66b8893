// The whole FMM evaluation phase in one launch: L2P, then P2P over the
// leaf strong (p2p) list, then M2P over the m2p list, into phi values
// held in registers per target and written once.
//
// Replaces the Pallas kernel repro/kernels/eval/fused.py
// (_eval_fused_pallas, pallas_call at :205; wrapper
// eval/ops.py:eval_fused_apply). Per target particle z of leaf box b:
//
//   phi  = sum_j b~_j t^j,  t = (z - z0_b)/rho_b       (L2P Horner seed)
//   phi += sum_{s in p2p(b)} sum_{x in s, rank x != rank z} G(z, x)
//          harmonic G = q/(x - z),  log G = q log(z - x)
//   phi += sum_{s in m2p(b)} [ sum_{j>=1} a~_j w^j  (+ a~_0 log(z - z0_s)) ]
//          w = rho_s/(z - z0_s), gated on rho_s > 0 as in fused.py:108-114
//
// Self-interaction is excluded by global particle rank, never by
// position, so distinct coincident particles keep their (non-finite)
// mutual term.
//
// Bound on the H100: operations. Each P2P pair is ~12 flops plus one
// reciprocal (harmonic) or a log and an atan2 (log); each M2P target
// costs ~8p flops per slot. Device-memory traffic is the particle planes
// once per list entry, far below the flop time.
//
// Design (the P2P stage, items 1-5, is csrc/pairs.cuh:near_sum, which
// the per-phase P2P kernel p2p.cu runs too):
// 1. One warp owns one target leaf (four leaves a block); every lane owns
//    two targets, t and t + 32, so each staged source feeds two pairs
//    from one shared-memory load. The warp reads its p2p and m2p list
//    rows once, coalesced, and compacts the occupied slots in list order
//    with a ballot: no dependent list load per slot.
// 2. Source leaves are staged as packed (x, y, q_r, q_i) records (one
//    16-byte shared load per source in f32, two in f64) in a ring of two
//    stages filled with cp.async: the next leaf arrives while the current
//    one is summed. Only warp barriers: a warp never waits on another.
// 3. Padded source slots are never read: the static leaf layout pads at
//    the tail (kernels/common.py:dense_rank_planes), so each staged
//    leaf's valid count (one ballot over its staged ranks) bounds the
//    loop. The rank test runs only in the slot whose source is the
//    target's own leaf, where it reduces to slot != target slot.
// 4. n = 64 (the paper's N_d = 45 gives n_max = 64) is a template
//    instantiation: a full leaf runs a loop of compile-time length 64,
//    unrolled by 16 (unrolled fully, its body no longer fits the
//    instruction cache and ran slower on the card); other n take the
//    generic loop (64 targets a pass). Launch bounds of five 4-warp
//    blocks an SM cap the registers at 102.
// 5. The harmonic reciprocal is rcp.approx plus Newton refinement (one
//    step in f32; in f64 one cubic step from the ~2^-22 seed) instead of
//    an IEEE division; a coincident pair of distinct particles still
//    gives a non-finite phi.
// 6. All occupied m2p rows (coefficients, center, radius) are staged in
//    one pass with one warp barrier, in the ring's space once the P2P
//    sums are done. The L2P and M2P Horner loops are unchanged. No
//    atomics: results are bitwise reproducible and a problem's row of a
//    batch equals its own apply.
// 7. The log kernel in f64 takes each pair's and each M2P target's
//    complex logarithm from clog.cuh (branch-free, two table rows; 41 f64
//    instructions of 99 a pair, within 2 ulp of log and atan2) instead of
//    the library's log and atan2 (a division, special-case branches, an
//    atan polynomial over [0, 1]), with which the log evaluation took 7.6
//    times the harmonic one on the same 2^20 plan. Its tables (6 KB) are
//    staged once a block into static shared memory before the warps part;
//    the dynamic staging regions fit beside them, and the launch opts in
//    above 48 KB where the two together pass it. In f32 the library's
//    logf and atan2f stay.
#include "pairs.cuh"

constexpr int WARPS = 4;       // target leaves per block, one warp each
                               // (fewer where a leaf's ring is large)

// The per-warp staging region in reals: the source ring, reused for the
// m2p rows (2P coefficients, center and radius each).
static __host__ __device__ int region_elems(int n, int P) {
  return ring_elems(n) > 2 * P + 3 ? ring_elems(n) : 2 * P + 3;
}

static __host__ __device__ size_t warp_bytes(size_t elem, int n, int P,
                                             int S, int Sm) {
  const size_t b = elem * (size_t)region_elems(n, P)
                   + sizeof(int32_t) * (size_t)(ring_ranks(n) + S + Sm);
  return (b + 15) / 16 * 16;
}

// Local-expansion Horner at the two pre-centered targets.
template <typename T>
__device__ __forceinline__ void l2p_seed(const T* __restrict__ cr,
                                         const T* __restrict__ ci, int P,
                                         T x0r, T x0i, T x1r, T x1i, T& h0r,
                                         T& h0i, T& h1r, T& h1i) {
  h0r = h1r = __ldg(cr + P - 1);
  h0i = h1i = __ldg(ci + P - 1);
  for (int j = P - 2; j >= 0; --j) {
    const T c = __ldg(cr + j), d = __ldg(ci + j);
    const T n0 = h0r * x0r - h0i * x0i + c;
    h0i = h0r * x0i + h0i * x0r + d;
    h0r = n0;
    const T n1 = h1r * x1r - h1i * x1i + c;
    h1i = h1r * x1i + h1i * x1r + d;
    h1r = n1;
  }
}

// One staged m2p row a = (a_r[P], a_i[P], center re, center im, rho) at
// one target z, added to (phr, phi).
template <typename T, bool LOG>
__device__ __forceinline__ void m2p_term(const T* __restrict__ a, int P,
                                         T zr, T zi, T& phr, T& phi) {
  const T* a_i = a + P;
  const T cr = a[2 * P], ci = a[2 * P + 1], rh = a[2 * P + 2];
  const T dxr = zr - cr, dxi = zi - ci;         // z - z0_src
  const T d2 = dxr * dxr + dxi * dxi;
  const bool ok = rh > T(0);
  const T k = ok ? T(1) / d2 : T(0);
  const T wr = rh * dxr * k, wi = -rh * dxi * k;   // rho / (z - z0)
  T hr = a[P - 1], hi = a_i[P - 1];
  for (int j = P - 2; j >= 1; --j) {
    const T nr = hr * wr - hi * wi + a[j];
    hi = hr * wi + hi * wr + a_i[j];
    hr = nr;
  }
  T fr = hr * wr - hi * wi, fi = hr * wi + hi * wr;
  if constexpr (LOG) {                          // + a_0 log(z - z0_src)
    T lr, li;
    if constexpr (sizeof(T) == 8) {
      const CLog l = clog_pair(-dxr, -dxi, d2);
      lr = ok ? l.re : T(0);
      li = ok ? l.im : T(0);
    } else {
      lr = ok ? T(0.5) * log(d2) : T(0);
      li = ok ? atan2(dxi, dxr) : T(0);
    }
    fr += a[0] * lr - a_i[0] * li;
    fi += a[0] * li + a_i[0] * lr;
  }
  if (ok) {
    phr += fr;
    phi += fi;
  }
}

template <typename T, bool LOG, int NF>
__global__ void __launch_bounds__(WARPS * 32, 5) eval_fused_kernel(
    const int32_t* __restrict__ p2p, int S, const int32_t* __restrict__ m2p,
    int Sm, const T* __restrict__ zr, const T* __restrict__ zi,
    const T* __restrict__ qr, const T* __restrict__ qi,
    const int32_t* __restrict__ rk, const T* __restrict__ tr,
    const T* __restrict__ ti, const T* __restrict__ br,
    const T* __restrict__ bi, const T* __restrict__ ar,
    const T* __restrict__ ai, const T* __restrict__ mcr,
    const T* __restrict__ mci, const T* __restrict__ mrho, int nb, int n_,
    int P, T* __restrict__ outr, T* __restrict__ outi) {
  const int n = NF > 0 ? NF : n_;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int box = blockIdx.x * (blockDim.x >> 5) + warp;
  if constexpr (LOG && sizeof(T) == 8) clog_stage();   // a block barrier
  if (box >= nb) return;                 // warp-uniform: warp barriers only
  const long long b = blockIdx.y, row = b * nb + box;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* region = reinterpret_cast<T*>(
      smem_raw + warp * warp_bytes(sizeof(T), n, P, S, Sm));
  Rec<T>* ring = reinterpret_cast<Rec<T>*>(region);
  const int relems = region_elems(n, P);
  int32_t* s_rank = reinterpret_cast<int32_t*>(region + relems);
  int32_t* s_list = s_rank + ring_ranks(n);

  // Read both lists once.
  const int np = compact(p2p + row * S, S, s_list, lane);
  const int nm = m2p != nullptr ? compact(m2p + row * Sm, Sm, s_list + S, lane)
                                : 0;

  for (int g0 = 0; g0 < n; g0 += GROUP) {
    const int t0 = g0 + lane, t1 = g0 + 32 + lane;
    const bool a0 = t0 < n, a1 = t1 < n;
    const T z0r = a0 ? zr[row * n + t0] : T(0);
    const T z0i = a0 ? zi[row * n + t0] : T(0);
    const T z1r = a1 ? zr[row * n + t1] : T(0);
    const T z1i = a1 ? zi[row * n + t1] : T(0);
    T p0r, p0i, p1r, p1i;
    l2p_seed(br + row * P, bi + row * P, P, a0 ? tr[row * n + t0] : T(0),
             a0 ? ti[row * n + t0] : T(0), a1 ? tr[row * n + t1] : T(0),
             a1 ? ti[row * n + t1] : T(0), p0r, p0i, p1r, p1i);

    // P2P: a two-stage cp.async ring over the compacted list.
    near_sum<T, LOG, NF>(s_list, np, box, b, nb, n, zr, zi, qr, qi, rk, ring,
                         s_rank, lane, t0, t1, z0r, z0i, z1r, z1i, p0r, p0i,
                         p1r, p1i);

    // M2P: stage the occupied rows (as many as the region holds; all of
    // them at the paper's sizes), then Horner per target.
    const int rowlen = 2 * P + 3;
    const int R = relems / rowlen;
    for (int m0 = 0; m0 < nm; m0 += R) {
      const int cm = min(R, nm - m0);
      for (int u = lane; u < cm * rowlen; u += 32) {
        const int i = u / rowlen, k = u - i * rowlen;
        const long long sr = b * nb + s_list[S + m0 + i];
        region[u] = k < P         ? ar[sr * P + k]
                    : k < 2 * P   ? ai[sr * P + k - P]
                    : k == 2 * P  ? mcr[sr]
                    : k == 2 * P + 1 ? mci[sr]
                                     : mrho[sr];
      }
      __syncwarp();
      for (int i = 0; i < cm; ++i) {
        m2p_term<T, LOG>(region + i * rowlen, P, z0r, z0i, p0r, p0i);
        m2p_term<T, LOG>(region + i * rowlen, P, z1r, z1i, p1r, p1i);
      }
      __syncwarp();                      // rows consumed before restaging
    }
    if (a0) {
      outr[row * n + t0] = p0r;
      outi[row * n + t0] = p0i;
    }
    if (a1) {
      outr[row * n + t1] = p1r;
      outi[row * n + t1] = p1i;
    }
  }
}

// Warps (target leaves) per block: WARPS, or fewer where their staging
// regions would not fit in a block's shared memory beside `reserve`
// bytes of static shared memory.
static int warps_per_block(size_t elem, int n, int P, int S, int Sm,
                           size_t reserve = 0) {
  return fit_warps(warp_bytes(elem, n, P, S, Sm), WARPS, reserve);
}

// Dynamic shared memory of one block: each warp's region.
static size_t smem_bytes(size_t elem, int n, int P, int S, int Sm,
                         size_t reserve = 0) {
  return warps_per_block(elem, n, P, S, Sm, reserve)
         * warp_bytes(elem, n, P, S, Sm);
}

template <typename T, bool LOG, int NF>
static int launch_one(dim3 grid, int wpb, size_t smem, cudaStream_t s,
                      const void* p2p, int S, const void* m2p, int Sm,
                      const void* zr, const void* zi, const void* qr,
                      const void* qi, const void* rk, const void* tr,
                      const void* ti, const void* br, const void* bi,
                      const void* ar, const void* ai, const void* mcr,
                      const void* mci, const void* mrho, int nb, int n,
                      int P, void* outr, void* outi) {
  const int rc = allow_smem(eval_fused_kernel<T, LOG, NF>, smem,
                           LOG && sizeof(T) == 8 ? CLOG_SMEM : 0);
  if (rc) return rc;
  eval_fused_kernel<T, LOG, NF><<<grid, wpb * 32, smem, s>>>(
      (const int32_t*)p2p, S, (const int32_t*)m2p, Sm, (const T*)zr,
      (const T*)zi, (const T*)qr, (const T*)qi, (const int32_t*)rk,
      (const T*)tr, (const T*)ti, (const T*)br, (const T*)bi, (const T*)ar,
      (const T*)ai, (const T*)mcr, (const T*)mci, (const T*)mrho, nb, n, P,
      (T*)outr, (T*)outi);
  return launch_status();
}

template <typename T>
static int launch(const void* p2p, int S, const void* m2p, int Sm,
                  const void* zr, const void* zi, const void* qr,
                  const void* qi, const void* rk, const void* tr,
                  const void* ti, const void* br, const void* bi,
                  const void* ar, const void* ai, const void* mcr,
                  const void* mci, const void* mrho, int B, int nb, int n,
                  int P, int log_kernel, void* outr, void* outi,
                  void* stream) {
  // the f64 log branch holds the clog tables in static shared memory
  const size_t reserve = log_kernel && sizeof(T) == 8 ? CLOG_SMEM : 0;
  const int wpb = warps_per_block(sizeof(T), n, P, S, Sm, reserve);
  if (n < 1 || P < 2 || S < 1 || wpb < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes(sizeof(T), n, P, S, Sm, reserve);
  const dim3 grid((nb + wpb - 1) / wpb, B);
  cudaStream_t s = (cudaStream_t)stream;
#define EVAL_ARGS                                                             \
  grid, wpb, smem, s, p2p, S, m2p, Sm, zr, zi, qr, qi, rk, tr, ti, br, bi, ar, ai, \
      mcr, mci, mrho, nb, n, P, outr, outi
  if (n == NFIX)
    return log_kernel ? launch_one<T, true, NFIX>(EVAL_ARGS)
                      : launch_one<T, false, NFIX>(EVAL_ARGS);
  return log_kernel ? launch_one<T, true, 0>(EVAL_ARGS)
                    : launch_one<T, false, 0>(EVAL_ARGS);
#undef EVAL_ARGS
}

#define EVAL_ENTRY(NAME, T)                                                   \
  extern "C" int NAME(const void* p2p, int S, const void* m2p, int Sm,        \
                      const void* zr, const void* zi, const void* qr,         \
                      const void* qi, const void* rk, const void* tr,         \
                      const void* ti, const void* br, const void* bi,         \
                      const void* ar, const void* ai, const void* mcr,        \
                      const void* mci, const void* mrho, int B, int nb,       \
                      int n, int P, int log_kernel, void* outr, void* outi,   \
                      void* stream) {                                         \
    return launch<T>(p2p, S, m2p, Sm, zr, zi, qr, qi, rk, tr, ti, br, bi, ar, \
                     ai, mcr, mci, mrho, B, nb, n, P, log_kernel, outr, outi, \
                     stream);                                                 \
  }
EVAL_ENTRY(eval_fused_f32, float)
EVAL_ENTRY(eval_fused_f64, double)

// ---------------------------------------------------------------------------
// K densities on one geometry (eval_block_kernel<T, LOG, KD>)
//
// The same phase for KD charge planes that share one plan (the density
// axis: a block solver's right-hand sides): particles, ranks, targets,
// lists, centres and radii are read once, the charges, the locals, the
// multipoles and the result carry KD rows. The design above, with:
// a. A staged source record holds its position once and its KD charges,
//    (x, y, q_r[0], q_i[0], ..., q_r[KD-1], q_i[KD-1]): one 16-byte
//    shared load a (q_r, q_i) pair in f64, every lane reading the same
//    record (a broadcast).
// b. A pair's geometry, its self test and its complex logarithm
//    (clog_pair in f64; logf and atan2f in f32) or reciprocal are taken
//    once and applied to the KD charges: a density adds one complex
//    multiply-add a pair. Each lane keeps KD complex sums for each of its
//    two targets, added to straight across the leaves (no per-leaf
//    partial sums: 4 KD of them would not fit beside the sums).
// c. L2P seeds KD Horner sums from the KD local rows at the target's one
//    pre-centred position; an m2p row is staged with its KD multipole
//    rows, and each target's w = rho/(z - z0) and log(z - z0) are taken
//    once for the KD Horner sums.
// d. KD is a template argument, instantiated at 8; the host runs K in
//    blocks of 8 and each density left over on eval_fused_kernel above
//    (kernels/common.py:density_chunks). The generic n loop only (the
//    K = 1 kernel's full-leaf loop is not instantiated here). Launch
//    bounds of two 4-warp blocks an SM leave the registers (the 4 KD
//    sums, the record) to the compiler.
// Results are deterministic (no atomics); they equal the K = 1 kernel's
// to rounding, not bitwise (a density's harmonic term is q (1/d), and
// the sums run across the leaves).

// A record's reals: position, then KD (q_r, q_i) pairs.
static __host__ __device__ int rec_elems(int kd) { return 2 + 2 * kd; }

static __host__ __device__ int block_region(int n, int P, int kd) {
  const int ring = NSTAGE * n * rec_elems(kd);
  const int row = 2 * kd * P + 3;
  return ring > row ? ring : row;
}

static __host__ __device__ size_t block_warp_bytes(size_t elem, int n, int P,
                                                   int S, int Sm, int kd) {
  const size_t b = elem * (size_t)block_region(n, P, kd)
                   + sizeof(int32_t) * (size_t)(ring_ranks(n) + S + Sm);
  return (b + 15) / 16 * 16;
}

// One pair's term for the KD charges of record `rc` at target z, added
// to (sr, si); `self` drops it (tested only where SELF).
template <typename T, bool LOG, bool SELF, int KD>
__device__ __forceinline__ void pair_block(const T* __restrict__ rc,
                                           bool self, T zr, T zi, T* sr,
                                           T* si) {
  const T dx = rc[0] - zr, dy = rc[1] - zi;      // z_src - z_tgt
  const T d2 = dx * dx + dy * dy;
  T gr, gi;        // log(z - x), or the conjugate of 1/(x - z) over d2
  if constexpr (LOG) {
    if constexpr (sizeof(T) == 8) {
      const CLog l = clog_pair(dx, dy, d2);
      gr = l.re;
      gi = l.im;
    } else {
      gr = T(0.5) * log(d2);
      gi = atan2(-dy, -dx);
    }
  } else {
    const T inv = fast_rcp(d2);                  // q/(dx + i dy)
    gr = dx * inv;
    gi = -dy * inv;
  }
  if (SELF && self) gr = gi = T(0);
#pragma unroll
  for (int k = 0; k < KD; ++k) {
    const T qr = rc[2 + 2 * k], qi = rc[3 + 2 * k];
    sr[k] += qr * gr - qi * gi;
    si[k] += qr * gi + qi * gr;
  }
}

// The near field of the target leaf `box` for KD densities: as
// near_sum, over records of rec_elems(KD) reals (charge planes
// (KD, nb, n) from `qr`, `qi`; particles and ranks (nb, n)).
template <typename T, bool LOG, int KD>
__device__ __forceinline__ void near_block(
    const int32_t* list, int np, int box, int nb, int n,
    const T* __restrict__ zr, const T* __restrict__ zi,
    const T* __restrict__ qr, const T* __restrict__ qi,
    const int32_t* __restrict__ rk, T* ring, int32_t* ranks, int lane,
    int t0, int t1, T z0r, T z0i, T z1r, T z1i, T* p0r, T* p0i, T* p1r,
    T* p1i) {
  constexpr int RE = 2 + 2 * KD;
  const long long plane = (long long)nb * n;
  auto issue = [&](int s) {
    const int src = list[s];
    const long long sb = (long long)src * n;
    T* dst = ring + (long long)(s % NSTAGE) * n * RE;
    int32_t* rdst = ranks + (s % NSTAGE) * n;
    for (int j = lane; j < n; j += 32) {
      T* r = dst + j * RE;
      cp_async(r, zr + sb + j);
      cp_async(r + 1, zi + sb + j);
#pragma unroll
      for (int k = 0; k < KD; ++k) {
        cp_async(r + 2 + 2 * k, qr + k * plane + sb + j);
        cp_async(r + 3 + 2 * k, qi + k * plane + sb + j);
      }
      cp_async(rdst + j, rk + sb + j);
    }
  };

  __syncwarp();                        // list written; ring free
  for (int s = 0; s < NSTAGE - 1; ++s) {
    if (s < np) issue(s);
    cp_async_commit();
  }
  for (int s = 0; s < np; ++s) {
    if (s + NSTAGE - 1 < np) issue(s + NSTAGE - 1);
    cp_async_commit();
    cp_async_wait<NSTAGE - 1>();
    __syncwarp();                      // every lane's copies landed
    const T* rec = ring + (long long)(s % NSTAGE) * n * RE;
    const int32_t* rks = ranks + (s % NSTAGE) * n;
    int cnt = 0;                       // valid sources: a prefix
    for (int j0 = 0; j0 < n; j0 += 32)
      cnt += __popc(__ballot_sync(0xffffffffu,
                                  j0 + lane < n && rks[j0 + lane] >= 0));
    if (list[s] == box) {              // the target's own leaf
      for (int j = 0; j < cnt; ++j) {
        pair_block<T, LOG, true, KD>(rec + j * RE, j == t0, z0r, z0i, p0r,
                                     p0i);
        pair_block<T, LOG, true, KD>(rec + j * RE, j == t1, z1r, z1i, p1r,
                                     p1i);
      }
    } else {
#pragma unroll 2
      for (int j = 0; j < cnt; ++j) {
        pair_block<T, LOG, false, KD>(rec + j * RE, false, z0r, z0i, p0r,
                                      p0i);
        pair_block<T, LOG, false, KD>(rec + j * RE, false, z1r, z1i, p1r,
                                      p1i);
      }
    }
    __syncwarp();                      // slot consumed before refill
  }
}

// One staged m2p row (KD multipole rows (a_r[P], a_i[P]), then centre re,
// im and rho) at one target z, added to the KD sums (phr, phi).
template <typename T, bool LOG, int KD>
__device__ __forceinline__ void m2p_block(const T* __restrict__ a, int P,
                                          T zr, T zi, T* phr, T* phi) {
  const T* g = a + 2 * KD * P;
  const T cr = g[0], ci = g[1], rh = g[2];
  const T dxr = zr - cr, dxi = zi - ci;         // z - z0_src
  const T d2 = dxr * dxr + dxi * dxi;
  const bool ok = rh > T(0);
  if (!ok) return;
  const T k = T(1) / d2;
  const T wr = rh * dxr * k, wi = -rh * dxi * k;   // rho / (z - z0)
  T lr = T(0), li = T(0);
  if constexpr (LOG) {                          // log(z - z0_src)
    if constexpr (sizeof(T) == 8) {
      const CLog l = clog_pair(-dxr, -dxi, d2);
      lr = l.re;
      li = l.im;
    } else {
      lr = T(0.5) * log(d2);
      li = atan2(dxi, dxr);
    }
  }
#pragma unroll
  for (int q = 0; q < KD; ++q) {
    const T* a_r = a + 2 * q * P;
    const T* a_i = a_r + P;
    T hr = a_r[P - 1], hi = a_i[P - 1];
    for (int j = P - 2; j >= 1; --j) {
      const T nr = hr * wr - hi * wi + a_r[j];
      hi = hr * wi + hi * wr + a_i[j];
      hr = nr;
    }
    T fr = hr * wr - hi * wi, fi = hr * wi + hi * wr;
    if constexpr (LOG) {
      fr += a_r[0] * lr - a_i[0] * li;
      fi += a_r[0] * li + a_i[0] * lr;
    }
    phr[q] += fr;
    phi[q] += fi;
  }
}

template <typename T, bool LOG, int KD>
__global__ void __launch_bounds__(WARPS * 32, 2) eval_block_kernel(
    const int32_t* __restrict__ p2p, int S, const int32_t* __restrict__ m2p,
    int Sm, const T* __restrict__ zr, const T* __restrict__ zi,
    const T* __restrict__ qr, const T* __restrict__ qi,
    const int32_t* __restrict__ rk, const T* __restrict__ tr,
    const T* __restrict__ ti, const T* __restrict__ br,
    const T* __restrict__ bi, const T* __restrict__ ar,
    const T* __restrict__ ai, const T* __restrict__ mcr,
    const T* __restrict__ mci, const T* __restrict__ mrho, int nb, int n,
    int P, T* __restrict__ outr, T* __restrict__ outi) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int box = blockIdx.x * (blockDim.x >> 5) + warp;
  if constexpr (LOG && sizeof(T) == 8) clog_stage();   // a block barrier
  if (box >= nb) return;                 // warp-uniform: warp barriers only
  const long long row = box, plane = (long long)nb * n,
                  cplane = (long long)nb * P;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* region = reinterpret_cast<T*>(
      smem_raw + warp * block_warp_bytes(sizeof(T), n, P, S, Sm, KD));
  const int relems = block_region(n, P, KD);
  int32_t* s_rank = reinterpret_cast<int32_t*>(region + relems);
  int32_t* s_list = s_rank + ring_ranks(n);

  const int np = compact(p2p + row * S, S, s_list, lane);
  const int nm = m2p != nullptr ? compact(m2p + row * Sm, Sm, s_list + S, lane)
                                : 0;

  for (int g0 = 0; g0 < n; g0 += GROUP) {
    const int t0 = g0 + lane, t1 = g0 + 32 + lane;
    const bool a0 = t0 < n, a1 = t1 < n;
    const T z0r = a0 ? zr[row * n + t0] : T(0);
    const T z0i = a0 ? zi[row * n + t0] : T(0);
    const T z1r = a1 ? zr[row * n + t1] : T(0);
    const T z1i = a1 ? zi[row * n + t1] : T(0);
    const T x0r = a0 ? tr[row * n + t0] : T(0), x0i = a0 ? ti[row * n + t0] : T(0);
    const T x1r = a1 ? tr[row * n + t1] : T(0), x1i = a1 ? ti[row * n + t1] : T(0);
    T p0r[KD], p0i[KD], p1r[KD], p1i[KD];
#pragma unroll
    for (int k = 0; k < KD; ++k)
      l2p_seed(br + k * cplane + row * P, bi + k * cplane + row * P, P, x0r,
               x0i, x1r, x1i, p0r[k], p0i[k], p1r[k], p1i[k]);

    near_block<T, LOG, KD>(s_list, np, box, nb, n, zr, zi, qr, qi, rk,
                           region, s_rank, lane, t0, t1, z0r, z0i, z1r, z1i,
                           p0r, p0i, p1r, p1i);

    // M2P: stage the occupied rows with their KD multipole rows.
    const int rowlen = 2 * KD * P + 3;
    const int R = relems / rowlen;
    for (int m0 = 0; m0 < nm; m0 += R) {
      const int cm = min(R, nm - m0);
      for (int u = lane; u < cm * rowlen; u += 32) {
        const int i = u / rowlen, c = u - i * rowlen;
        const long long sr = s_list[S + m0 + i];
        const int q = c / (2 * P), e = c - q * 2 * P;
        region[u] = q < KD ? (e < P ? ar[q * cplane + sr * P + e]
                                    : ai[q * cplane + sr * P + e - P])
                    : e == 0 ? mcr[sr]
                    : e == 1 ? mci[sr]
                             : mrho[sr];
      }
      __syncwarp();
      for (int i = 0; i < cm; ++i) {
        m2p_block<T, LOG, KD>(region + i * rowlen, P, z0r, z0i, p0r, p0i);
        m2p_block<T, LOG, KD>(region + i * rowlen, P, z1r, z1i, p1r, p1i);
      }
      __syncwarp();                      // rows consumed before restaging
    }
#pragma unroll
    for (int k = 0; k < KD; ++k) {
      if (a0) {
        outr[k * plane + row * n + t0] = p0r[k];
        outi[k * plane + row * n + t0] = p0i[k];
      }
      if (a1) {
        outr[k * plane + row * n + t1] = p1r[k];
        outi[k * plane + row * n + t1] = p1i[k];
      }
    }
  }
}

static size_t block_smem(size_t elem, int n, int P, int S, int Sm, int kd,
                         size_t reserve, int* wpb) {
  const size_t per = block_warp_bytes(elem, n, P, S, Sm, kd);
  *wpb = fit_warps(per, WARPS, reserve);
  return (size_t)(*wpb > 0 ? *wpb : 0) * per;
}

template <typename T, bool LOG, int KD>
static int launch_block_one(const void* p2p, int S, const void* m2p, int Sm,
                            const void* zr, const void* zi, const void* qr,
                            const void* qi, const void* rk, const void* tr,
                            const void* ti, const void* br, const void* bi,
                            const void* ar, const void* ai, const void* mcr,
                            const void* mci, const void* mrho, int nb, int n,
                            int P, void* outr, void* outi, cudaStream_t s) {
  const size_t reserve = LOG && sizeof(T) == 8 ? CLOG_SMEM : 0;
  int wpb;
  const size_t smem = block_smem(sizeof(T), n, P, S, Sm, KD, reserve, &wpb);
  if (n < 1 || P < 2 || S < 1 || wpb < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int rc = allow_smem(eval_block_kernel<T, LOG, KD>, smem, reserve);
  if (rc) return rc;
  eval_block_kernel<T, LOG, KD><<<(nb + wpb - 1) / wpb, wpb * 32, smem, s>>>(
      (const int32_t*)p2p, S, (const int32_t*)m2p, Sm, (const T*)zr,
      (const T*)zi, (const T*)qr, (const T*)qi, (const int32_t*)rk,
      (const T*)tr, (const T*)ti, (const T*)br, (const T*)bi, (const T*)ar,
      (const T*)ai, (const T*)mcr, (const T*)mci, (const T*)mrho, nb, n, P,
      (T*)outr, (T*)outi);
  return launch_status();
}

template <typename T, bool LOG>
static int launch_block_kd(int kd, const void* p2p, int S, const void* m2p,
                           int Sm, const void* zr, const void* zi,
                           const void* qr, const void* qi, const void* rk,
                           const void* tr, const void* ti, const void* br,
                           const void* bi, const void* ar, const void* ai,
                           const void* mcr, const void* mci,
                           const void* mrho, int nb, int n, int P,
                           void* outr, void* outi, cudaStream_t s) {
#define BLOCK_ARGS                                                            \
  p2p, S, m2p, Sm, zr, zi, qr, qi, rk, tr, ti, br, bi, ar, ai, mcr, mci, mrho, \
      nb, n, P, outr, outi, s
  if (kd != 8) return static_cast<int>(cudaErrorInvalidValue);
  return launch_block_one<T, LOG, 8>(BLOCK_ARGS);
#undef BLOCK_ARGS
}

#define BLOCK_ENTRY(NAME, T)                                                  \
  extern "C" int NAME(const void* p2p, int S, const void* m2p, int Sm,        \
                      const void* zr, const void* zi, const void* qr,         \
                      const void* qi, const void* rk, const void* tr,         \
                      const void* ti, const void* br, const void* bi,         \
                      const void* ar, const void* ai, const void* mcr,        \
                      const void* mci, const void* mrho, int kd, int nb,      \
                      int n, int P, int log_kernel, void* outr, void* outi,   \
                      void* stream) {                                         \
    cudaStream_t s = (cudaStream_t)stream;                                    \
    return log_kernel                                                         \
               ? launch_block_kd<T, true>(kd, p2p, S, m2p, Sm, zr, zi, qr,    \
                                          qi, rk, tr, ti, br, bi, ar, ai,     \
                                          mcr, mci, mrho, nb, n, P, outr,     \
                                          outi, s)                            \
               : launch_block_kd<T, false>(kd, p2p, S, m2p, Sm, zr, zi, qr,   \
                                           qi, rk, tr, ti, br, bi, ar, ai,    \
                                           mcr, mci, mrho, nb, n, P, outr,    \
                                           outi, s);                          \
  }
BLOCK_ENTRY(eval_block_f32, float)
BLOCK_ENTRY(eval_block_f64, double)

// Dynamic shared memory per block (bytes) of a launch at these sizes
// (S: the width of the p2p and of the m2p lists).
extern "C" int repro_smem_bytes(int elem, int n, int P, int S) {
  return static_cast<int>(smem_bytes(elem, n, P, S, S));
}
