// Level-fused multipole-to-local (M2L) translation of the FMM downward
// pass, radius-normalized, for both G-kernels.
//
// Replaces the Pallas kernel repro/kernels/m2l/m2l.py (_m2l_pallas,
// pallas_call at :149; wrapper m2l/ops.py:m2l_fused_apply). For every
// target box t of the flattened all-levels axis (sum 4^l boxes) and every
// occupied slot of its weak list, with source box s and r = c_t - c_s:
//
//   a^_k  = a_k (rho_s/r)^k                      (k >= 1; a^_0 = a_0)
//   b^_l  = sum_k H[l][k] a^_k,   H[l][k] = C(l+k-1, k-1) ...
//   out_l += b^_l (-rho_t/r)^l   (+ a_0 log r on l = 0 for the log kernel)
//
// Bound on the H100: operations. Per occupied entry the (p+1)^2
// real-by-complex product is 4 (p+1)^2 flops (1.3 kflop at p = 17)
// against ~0.3 KB of operands (a multipole row, two centers, a radius).
//
// Design:
// 1. A block owns a tile of TB = 128 / (p+1) target boxes (7 at p = 17)
//    and walks their weak rows in chunks of WC slots (512 at p = 17; a
//    tile stages at most LIST_SLOTS indices), so shared memory does not
//    grow with the weak-list width W and any W runs. Per chunk each warp
//    loads its boxes' slots, coalesced, and compacts the occupied ones in
//    slot order with a ballot: no per-slot list load. A chunk that no box
//    of the tile occupies costs that pass and one barrier, no rounds.
//    Where W <= WC there is one chunk (the default weak_cap, 128).
// 2. Rounds of CEB entries per box: the block computes r, rho_s/r and
//    -rho_t/r from the (B, NB) centers and radii (no per-slot ratio
//    planes in device memory), and each entry's p+1 powers of both
//    ratios once, not once per output (one thread the pre-scaled row a^,
//    one thread the post-scale powers), into shared memory.
// 3. The product: thread (box, l) keeps row l of H in registers (the
//    p = 17 instantiation; a generic one reads H from shared memory and
//    takes twice as long at p = 17, scripts/time_kernels.py) and
//    streams its box's pre-scaled rows, whose 16-byte loads every thread
//    of the box shares (a broadcast): an (entries x P) tile times H^T,
//    each thread one output column of its box. All 32 lanes of every
//    warp but the last two work. FP64 tensor cores (mma m8n8k4) are not
//    used: P = 18 pads to 20 x 24 there (a third of the work padding),
//    and each box's few dozen entries would still need a reduction
//    across fragment rows; f32 stays on FFMA (TF32 would break the f32
//    accuracy bound).
// 4. Post-scaling and reduction in registers: thread (box, l) adds each
//    entry's b^_l (-rho_t/r)^l in slot order (chunks come in slot order,
//    so the chunking does not change any sum) and stores out_l once. The
//    order of every sum is fixed, there are no atomics: results are
//    bitwise reproducible and a problem's row of a batch equals its own
//    apply. Empty boxes, the root-only case and the ragged last tile
//    store 0.
#include "common.cuh"

constexpr int THREADS = 128;
constexpr int CEB = 8;         // entries of each box staged per round
constexpr int PFIX = 18;       // p = 17, the default config
constexpr int PMAX = 64;       // TB >= 2
constexpr int LIST_SLOTS = 3584;  // weak-list slots a tile stages at once

template <typename T> struct alignas(2 * sizeof(T)) Cx { T r, i; };

// Shared-memory geometry of one block (host and device agree on it).
struct Geo {
  int TB, RS, BS, WC;
  __host__ __device__ Geo(int P) {
    TB = THREADS / P;
    RS = P + (P & 1);          // complex row stride: even, so f32 rows are
                               // 16-byte aligned
    BS = CEB * RS + 2;         // box stride: shifts boxes by 16 bytes
                               // of banks (no conflicts between boxes)
    WC = LIST_SLOTS / TB / 32 * 32;   // weak-row chunk: whole warp passes
    WC = WC < 32 ? 32 : WC > 512 ? 512 : WC;
  }
  // Slots of a box staged per chunk of a W-wide row.
  __host__ __device__ int chunk(int W) const { return W < WC ? W : WC; }
};

static size_t smem_bytes(size_t elem, int P, int W) {
  const Geo g(P);
  return 2 * elem * (size_t)(2 * g.TB * g.BS + g.TB * CEB)   // a^, powers, log
         + elem * (size_t)(P * P)                            // H (generic)
         // one chunk of each box's weak row, and the box's count in it
         + sizeof(int32_t) * (size_t)(g.TB * (g.chunk(W) + 1));
}

// Complex c = a (x + i y) from real (a_r, a_i) and (x, y).
template <typename T>
__device__ __forceinline__ Cx<T> cmul(T ar, T ai, T x, T y) {
  return Cx<T>{ar * x - ai * y, ar * y + ai * x};
}

// Ratio sc / r for r = (rr, ri): rounded exactly as the plain version
// computes it (no contraction), so both scale by the same numbers.
template <typename T>
__device__ __forceinline__ void ratio(T sc, T rr, T ri, T& wr, T& wi) {
  using R = Rn<T>;
  const T k = R::div(T(1), R::add(R::mul(rr, rr), R::mul(ri, ri)));
  wr = R::mul(R::mul(sc, rr), k);
  wi = R::mul(R::mul(-sc, ri), k);
}

// b^ = sum_k h[k] x[k] over one pre-scaled row (two interleaved partial
// sums, each in k order).
template <typename T, int PF>
__device__ __forceinline__ void row_dot(const Cx<T>* x, const T* hreg,
                                        const T* hsm, int P, T& br, T& bi) {
  T r0 = T(0), i0 = T(0), r1 = T(0), i1 = T(0);
  if constexpr (PF > 0) {
#pragma unroll
    for (int k = 0; k + 1 < PF; k += 2) {
      T xr0, xi0, xr1, xi1;
      if constexpr (sizeof(T) == 4) {          // two complex in one load
        const float4 v = *reinterpret_cast<const float4*>(x + k);
        xr0 = v.x; xi0 = v.y; xr1 = v.z; xi1 = v.w;
      } else {
        const Cx<T> a = x[k], c = x[k + 1];
        xr0 = a.r; xi0 = a.i; xr1 = c.r; xi1 = c.i;
      }
      r0 = fma(hreg[k], xr0, r0);
      i0 = fma(hreg[k], xi0, i0);
      r1 = fma(hreg[k + 1], xr1, r1);
      i1 = fma(hreg[k + 1], xi1, i1);
    }
    if constexpr (PF & 1) {
      const Cx<T> a = x[PF - 1];
      r0 = fma(hreg[PF - 1], a.r, r0);
      i0 = fma(hreg[PF - 1], a.i, i0);
    }
  } else {
    (void)hreg;
    int k = 0;
    for (; k + 1 < P; k += 2) {
      const Cx<T> a = x[k], c = x[k + 1];
      r0 = fma(hsm[k], a.r, r0);
      i0 = fma(hsm[k], a.i, i0);
      r1 = fma(hsm[k + 1], c.r, r1);
      i1 = fma(hsm[k + 1], c.i, i1);
    }
    if (k < P) {
      const Cx<T> a = x[k];
      r0 = fma(hsm[k], a.r, r0);
      i0 = fma(hsm[k], a.i, i0);
    }
  }
  br = r0 + r1;
  bi = i0 + i1;
}

template <typename T, bool LOG, int PF>
__global__ void __launch_bounds__(THREADS) m2l_kernel(
    const int32_t* __restrict__ weak, const T* __restrict__ ar,
    const T* __restrict__ ai, const T* __restrict__ cr,
    const T* __restrict__ ci, const T* __restrict__ rho,
    const T* __restrict__ h, int NB, int W, int P_, T* __restrict__ outr,
    T* __restrict__ outi) {
  const int P = PF > 0 ? PF : P_;
  const Geo g(P);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Cx<T>* s_pre = reinterpret_cast<Cx<T>*>(smem_raw);   // a^ rows
  Cx<T>* s_post = s_pre + g.TB * g.BS;                  // (-rho_t/r)^l
  Cx<T>* s_log = s_post + g.TB * g.BS;                  // a_0 log r
  T* s_h = reinterpret_cast<T*>(s_log + g.TB * CEB);
  const int WC = g.chunk(W);
  int32_t* s_src = reinterpret_cast<int32_t*>(s_h + P * P);
  int32_t* s_cnt = s_src + g.TB * WC;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long b = blockIdx.y;
  const int box0 = blockIdx.x * g.TB;
  const int nbox = min(g.TB, NB - box0);

  // Output role: thread (obox, l) owns out_l of box obox.
  const int obox = tid / P, l = tid - obox * P;
  const bool owner = obox < nbox;
  T hreg[PF > 0 ? PF : 1];
  if constexpr (PF > 0) {
#pragma unroll
    for (int k = 0; k < PF; ++k) hreg[k] = owner ? h[l * PF + k] : T(0);
  }
  if (PF == 0)                 // read after the first chunk's barrier
    for (int i = tid; i < P * P; i += THREADS) s_h[i] = h[i];
  T accr = T(0), acci = T(0);

  for (int c0 = 0; c0 < W; c0 += WC) {
    const int c1 = min(W, c0 + WC);
    // 1. Compact each box's occupied slots of this chunk, in slot order.
    int any = 0;
    for (int bb = warp; bb < g.TB; bb += THREADS / 32) {
      int cnt = 0;
      if (bb < nbox) {
        const int32_t* wrow = weak + (b * NB + box0 + bb) * (long long)W;
        for (int s0 = c0; s0 < c1; s0 += 32) {
          const int src = s0 + lane < c1 ? wrow[s0 + lane] : -1;
          const unsigned m = __ballot_sync(0xffffffffu, src >= 0);
          if (src >= 0)
            s_src[bb * WC + cnt + __popc(m & ((1u << lane) - 1u))] = src;
          cnt += __popc(m);
        }
      }
      if (lane == 0) s_cnt[bb] = cnt;
      any |= cnt;
    }
    // A chunk that no box occupies ends at this barrier for every thread
    // (nothing was staged, nothing reads the counts).
    if (!__syncthreads_or(any)) continue;

    // rounds >= 1 here: the counts and lists of this chunk are read
    // before the last round's closing barrier, the next chunk writes
    // them after it.
    int most = 0;
    for (int bb = 0; bb < nbox; ++bb) most = max(most, s_cnt[bb]);
    const int rounds = (most + CEB - 1) / CEB;
    const int ocnt = owner ? s_cnt[obox] : 0;
    for (int r = 0; r < rounds; ++r) {
      const int e0 = r * CEB;
      // 2. Stage: per entry the pre-scaled row and the post-scale powers.
      for (int u = tid; u < 2 * g.TB * CEB; u += THREADS) {
        const bool post = u >= g.TB * CEB;
        const int v = post ? u - g.TB * CEB : u;
        const int bb = v / CEB, jj = v - bb * CEB;
        if (bb >= nbox || e0 + jj >= s_cnt[bb]) continue;
        const long long trow = b * NB + box0 + bb;
        const long long srow = b * NB + s_src[bb * WC + e0 + jj];
        const T rr = Rn<T>::sub(cr[trow], cr[srow]);   // r = c_t - c_s
        const T ri = Rn<T>::sub(ci[trow], ci[srow]);
        T wr, wi;
        ratio(post ? -rho[trow] : rho[srow], rr, ri, wr, wi);
        Cx<T>* dst = (post ? s_post : s_pre) + bb * g.BS + jj * g.RS;
        T pr = T(1), pi = T(0);
        if (post) {
#pragma unroll 6
          for (int k = 0; k < P; ++k) {
            dst[k] = Cx<T>{pr, pi};
            const Cx<T> nx = cmul(pr, pi, wr, wi);
            pr = nx.r;
            pi = nx.i;
          }
        } else {
          const T* a_r = ar + srow * P;
          const T* a_i = ai + srow * P;
#pragma unroll 6
          for (int k = 0; k < P; ++k) {
            dst[k] = cmul(a_r[k], a_i[k], pr, pi);
            const Cx<T> nx = cmul(pr, pi, wr, wi);
            pr = nx.r;
            pi = nx.i;
          }
          if (LOG) {                             // a_0 log r
            const T lr = T(0.5) * log(rr * rr + ri * ri);
            const T li = atan2(ri, rr);
            s_log[bb * CEB + jj] = cmul(a_r[0], a_i[0], lr, li);
          }
        }
      }
      __syncthreads();
      // 3.-4. Product, post-scale and slot-order sum of this round.
      if (owner) {
        const int ne = min(CEB, ocnt - e0);
        const Cx<T>* pre = s_pre + obox * g.BS;
        const Cx<T>* pst = s_post + obox * g.BS;
        for (int jj = 0; jj < ne; ++jj) {
          T br, bi;
          row_dot<T, PF>(pre + jj * g.RS, PF > 0 ? hreg : nullptr,
                         s_h + l * P, P, br, bi);
          const Cx<T> w = pst[jj * g.RS + l];
          accr += br * w.r - bi * w.i;
          acci += br * w.i + bi * w.r;
          if (LOG && l == 0) {
            const Cx<T> lg = s_log[obox * CEB + jj];
            accr += lg.r;
            acci += lg.i;
          }
        }
      }
      __syncthreads();
    }
  }
  if (owner) {
    const long long o = (b * NB + box0 + obox) * P + l;
    outr[o] = accr;
    outi[o] = acci;
  }
}

template <typename T, bool LOG, int PF>
static int launch_one(dim3 grid, size_t smem, cudaStream_t s,
                      const void* weak, const void* ar, const void* ai,
                      const void* cr, const void* ci, const void* rho,
                      const void* h, int NB, int W, int P, void* outr,
                      void* outi) {
  const int rc = allow_smem(m2l_kernel<T, LOG, PF>, smem);
  if (rc) return rc;
  m2l_kernel<T, LOG, PF><<<grid, THREADS, smem, s>>>(
      (const int32_t*)weak, (const T*)ar, (const T*)ai, (const T*)cr,
      (const T*)ci, (const T*)rho, (const T*)h, NB, W, P, (T*)outr,
      (T*)outi);
  return launch_status();
}

template <typename T>
static int launch(const void* weak, const void* ar, const void* ai,
                  const void* cr, const void* ci, const void* rho,
                  const void* h, int B, int NB, int W, int P, int log_kernel,
                  void* outr, void* outi, void* stream) {
  if (P < 1 || P > PMAX || W < 1) return static_cast<int>(cudaErrorInvalidValue);
  const Geo g(P);
  const dim3 grid((NB + g.TB - 1) / g.TB, B);
  const size_t smem = smem_bytes(sizeof(T), P, W);
  cudaStream_t s = (cudaStream_t)stream;
#define M2L_ARGS grid, smem, s, weak, ar, ai, cr, ci, rho, h, NB, W, P, outr, outi
  if (P == PFIX)
    return log_kernel ? launch_one<T, true, PFIX>(M2L_ARGS)
                      : launch_one<T, false, PFIX>(M2L_ARGS);
  return log_kernel ? launch_one<T, true, 0>(M2L_ARGS)
                    : launch_one<T, false, 0>(M2L_ARGS);
#undef M2L_ARGS
}

#define M2L_ENTRY(NAME, T)                                                   \
  extern "C" int NAME(const void* weak, const void* ar, const void* ai,      \
                      const void* cr, const void* ci, const void* rho,       \
                      const void* h, int B, int NB, int W, int P,            \
                      int log_kernel, void* outr, void* outi, void* stream) { \
    return launch<T>(weak, ar, ai, cr, ci, rho, h, B, NB, W, P, log_kernel,  \
                     outr, outi, stream);                                    \
  }
M2L_ENTRY(m2l_f32, float)
M2L_ENTRY(m2l_f64, double)

// ---------------------------------------------------------------------------
// K densities on one geometry (m2l_block_kernel<T, LOG, PF, KD>)
//
// The same translation for KD multipole planes that share one plan (the
// density axis): the weak lists, centres and radii are read once, the
// multipoles and the result carry KD rows (KD = 8; the host runs each
// density left over on m2l_kernel above). The design above, with each
// round of CE = 16 / KD entries a box (8 at most) staged in three steps:
// a. one thread an entry and side computes r, the ratio and its P powers
//    once: (rho_s/r)^k (k >= 1; 1 at k = 0) and (-rho_t/r)^l, and for the
//    log kernel log r, into shared memory;
// b. every thread forms the KD pre-scaled rows a^ = a_k (rho_s/r)^k of
//    the round's entries from the powers (the same products, in the same
//    rounding, as the kernel above);
// c. thread (box, l) takes each entry's KD rows times row l of H, the
//    (P x P)(P x KD) product, post-scales them by the one power
//    (-rho_t/r)^l and adds them to its KD sums in slot order (plus
//    a_0 log r at l = 0).
// So a box's KD results equal the K = 1 kernel's bit for bit. FP64 tensor
// cores are not used, as above (P = 18 pads to 20 x 24 there).

template <int KD>
struct GeoK {
  int TB, RS, CE, BS, BK, WC;
  __host__ __device__ GeoK(int P) {
    TB = THREADS / P;
    RS = P + (P & 1);
    CE = 16 / KD > CEB ? CEB : (16 / KD < 1 ? 1 : 16 / KD);
    BS = CE * RS + 2;            // a box's powers (pre or post)
    BK = CE * KD * RS + 2;       // a box's pre-scaled rows
    WC = LIST_SLOTS / TB / 32 * 32;
    WC = WC < 32 ? 32 : WC > 512 ? 512 : WC;
  }
  __host__ __device__ int chunk(int W) const { return W < WC ? W : WC; }
};

template <int KD>
static size_t block_smem_bytes(size_t elem, int P, int W) {
  const GeoK<KD> g(P);
  return 2 * elem * (size_t)(g.TB * g.BK + 2 * g.TB * g.BS + g.TB * g.CE)
         + elem * (size_t)(P * P)
         + sizeof(int32_t) * (size_t)(g.TB * (g.chunk(W) + 1));
}

template <typename T, bool LOG, int PF, int KD>
__global__ void __launch_bounds__(THREADS) m2l_block_kernel(
    const int32_t* __restrict__ weak, const T* __restrict__ ar,
    const T* __restrict__ ai, const T* __restrict__ cr,
    const T* __restrict__ ci, const T* __restrict__ rho,
    const T* __restrict__ h, int NB, int W, int P_, T* __restrict__ outr,
    T* __restrict__ outi) {
  const int P = PF > 0 ? PF : P_;
  const GeoK<KD> g(P);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Cx<T>* s_pre = reinterpret_cast<Cx<T>*>(smem_raw);   // KD a^ rows
  Cx<T>* s_spw = s_pre + g.TB * g.BK;                   // (rho_s/r)^k
  Cx<T>* s_post = s_spw + g.TB * g.BS;                  // (-rho_t/r)^l
  Cx<T>* s_log = s_post + g.TB * g.BS;                  // log r
  T* s_h = reinterpret_cast<T*>(s_log + g.TB * g.CE);
  const int WC = g.chunk(W);
  int32_t* s_src = reinterpret_cast<int32_t*>(s_h + P * P);
  int32_t* s_cnt = s_src + g.TB * WC;
  const long long plane = (long long)NB * P;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int box0 = blockIdx.x * g.TB;
  const int nbox = min(g.TB, NB - box0);

  const int obox = tid / P, l = tid - obox * P;
  const bool owner = obox < nbox;
  T hreg[PF > 0 ? PF : 1];
  if constexpr (PF > 0) {
#pragma unroll
    for (int k = 0; k < PF; ++k) hreg[k] = owner ? h[l * PF + k] : T(0);
  }
  if (PF == 0)
    for (int i = tid; i < P * P; i += THREADS) s_h[i] = h[i];
  T accr[KD], acci[KD];
#pragma unroll
  for (int k = 0; k < KD; ++k) accr[k] = acci[k] = T(0);

  for (int c0 = 0; c0 < W; c0 += WC) {
    const int c1 = min(W, c0 + WC);
    int any = 0;
    for (int bb = warp; bb < g.TB; bb += THREADS / 32) {
      int cnt = 0;
      if (bb < nbox) {
        const int32_t* wrow = weak + (box0 + bb) * (long long)W;
        for (int s0 = c0; s0 < c1; s0 += 32) {
          const int src = s0 + lane < c1 ? wrow[s0 + lane] : -1;
          const unsigned m = __ballot_sync(0xffffffffu, src >= 0);
          if (src >= 0)
            s_src[bb * WC + cnt + __popc(m & ((1u << lane) - 1u))] = src;
          cnt += __popc(m);
        }
      }
      if (lane == 0) s_cnt[bb] = cnt;
      any |= cnt;
    }
    if (!__syncthreads_or(any)) continue;

    int most = 0;
    for (int bb = 0; bb < nbox; ++bb) most = max(most, s_cnt[bb]);
    const int rounds = (most + g.CE - 1) / g.CE;
    const int ocnt = owner ? s_cnt[obox] : 0;
    for (int r = 0; r < rounds; ++r) {
      const int e0 = r * g.CE;
      // a. the entries' ratio powers (and log r), once an entry
      for (int u = tid; u < 2 * g.TB * g.CE; u += THREADS) {
        const bool post = u >= g.TB * g.CE;
        const int v = post ? u - g.TB * g.CE : u;
        const int bb = v / g.CE, jj = v - bb * g.CE;
        if (bb >= nbox || e0 + jj >= s_cnt[bb]) continue;
        const long long trow = box0 + bb;
        const long long srow = s_src[bb * WC + e0 + jj];
        const T rr = Rn<T>::sub(cr[trow], cr[srow]);   // r = c_t - c_s
        const T ri = Rn<T>::sub(ci[trow], ci[srow]);
        T wr, wi;
        ratio(post ? -rho[trow] : rho[srow], rr, ri, wr, wi);
        Cx<T>* dst = (post ? s_post : s_spw) + bb * g.BS + jj * g.RS;
        T pr = T(1), pi = T(0);
#pragma unroll 6
        for (int k = 0; k < P; ++k) {
          dst[k] = Cx<T>{pr, pi};
          const Cx<T> nx = cmul(pr, pi, wr, wi);
          pr = nx.r;
          pi = nx.i;
        }
        if (LOG && !post)
          s_log[bb * g.CE + jj] =
              Cx<T>{T(0.5) * log(rr * rr + ri * ri), atan2(ri, rr)};
      }
      __syncthreads();
      // b. the KD pre-scaled rows of each entry
      for (int u = tid; u < g.TB * g.CE * KD * P; u += THREADS) {
        const int bb = u / (g.CE * KD * P);
        const int v = u - bb * (g.CE * KD * P);
        const int jj = v / (KD * P), w = v - jj * (KD * P);
        const int q = w / P, k = w - q * P;
        if (bb >= nbox || e0 + jj >= s_cnt[bb]) continue;
        const long long src = q * plane + s_src[bb * WC + e0 + jj] * (long long)P + k;
        const Cx<T> pw = s_spw[bb * g.BS + jj * g.RS + k];
        s_pre[bb * g.BK + (jj * KD + q) * g.RS + k] =
            cmul(ar[src], ai[src], pw.r, pw.i);
      }
      __syncthreads();
      // c. product, post-scale and slot-order sums of this round
      if (owner) {
        const int ne = min(g.CE, ocnt - e0);
        for (int jj = 0; jj < ne; ++jj) {
          const Cx<T> w = s_post[obox * g.BS + jj * g.RS + l];
          const Cx<T> lg = LOG ? s_log[obox * g.CE + jj] : Cx<T>{T(0), T(0)};
#pragma unroll
          for (int q = 0; q < KD; ++q) {
            const Cx<T>* row = s_pre + obox * g.BK + (jj * KD + q) * g.RS;
            T br, bi;
            row_dot<T, PF>(row, PF > 0 ? hreg : nullptr, s_h + l * P, P, br,
                           bi);
            accr[q] += br * w.r - bi * w.i;
            acci[q] += br * w.i + bi * w.r;
            if (LOG && l == 0) {
              const Cx<T> a0 = row[0];             // a_0 (power 1)
              const Cx<T> t = cmul(a0.r, a0.i, lg.r, lg.i);
              accr[q] += t.r;
              acci[q] += t.i;
            }
          }
        }
      }
      __syncthreads();
    }
  }
  if (owner) {
#pragma unroll
    for (int q = 0; q < KD; ++q) {
      const long long o = q * plane + (box0 + obox) * (long long)P + l;
      outr[o] = accr[q];
      outi[o] = acci[q];
    }
  }
}

template <typename T, bool LOG, int PF, int KD>
static int launch_block_one(int NB, int W, int P, cudaStream_t s,
                            const void* weak, const void* ar, const void* ai,
                            const void* cr, const void* ci, const void* rho,
                            const void* h, void* outr, void* outi) {
  const GeoK<KD> g(P);
  const size_t smem = block_smem_bytes<KD>(sizeof(T), P, W);
  const int rc = allow_smem(m2l_block_kernel<T, LOG, PF, KD>, smem);
  if (rc) return rc;
  m2l_block_kernel<T, LOG, PF, KD><<<(NB + g.TB - 1) / g.TB, THREADS, smem,
                                     s>>>(
      (const int32_t*)weak, (const T*)ar, (const T*)ai, (const T*)cr,
      (const T*)ci, (const T*)rho, (const T*)h, NB, W, P, (T*)outr,
      (T*)outi);
  return launch_status();
}

template <typename T, bool LOG, int KD>
static int launch_block_p(int NB, int W, int P, cudaStream_t s,
                          const void* weak, const void* ar, const void* ai,
                          const void* cr, const void* ci, const void* rho,
                          const void* h, void* outr, void* outi) {
  return P == PFIX ? launch_block_one<T, LOG, PFIX, KD>(
                         NB, W, P, s, weak, ar, ai, cr, ci, rho, h, outr, outi)
                   : launch_block_one<T, LOG, 0, KD>(
                         NB, W, P, s, weak, ar, ai, cr, ci, rho, h, outr, outi);
}

template <typename T, bool LOG>
static int launch_block(int kd, int NB, int W, int P, cudaStream_t s,
                        const void* weak, const void* ar, const void* ai,
                        const void* cr, const void* ci, const void* rho,
                        const void* h, void* outr, void* outi) {
#define M2LB_ARGS NB, W, P, s, weak, ar, ai, cr, ci, rho, h, outr, outi
  if (kd != 8) return static_cast<int>(cudaErrorInvalidValue);
  return launch_block_p<T, LOG, 8>(M2LB_ARGS);
#undef M2LB_ARGS
}

#define M2L_BLOCK_ENTRY(NAME, T)                                              \
  extern "C" int NAME(const void* weak, const void* ar, const void* ai,      \
                      const void* cr, const void* ci, const void* rho,       \
                      const void* h, int kd, int NB, int W, int P,           \
                      int log_kernel, void* outr, void* outi, void* stream) { \
    if (P < 1 || P > PMAX || W < 1)                                          \
      return static_cast<int>(cudaErrorInvalidValue);                        \
    cudaStream_t s = (cudaStream_t)stream;                                   \
    return log_kernel ? launch_block<T, true>(kd, NB, W, P, s, weak, ar, ai, \
                                              cr, ci, rho, h, outr, outi)    \
                      : launch_block<T, false>(kd, NB, W, P, s, weak, ar,    \
                                               ai, cr, ci, rho, h, outr,     \
                                               outi);                        \
  }
M2L_BLOCK_ENTRY(m2l_block_f32, float)
M2L_BLOCK_ENTRY(m2l_block_f64, double)

// Dynamic shared memory per block (bytes) of a launch at these sizes
// (S: the weak-list width; bounded by the chunk width WC).
extern "C" int repro_smem_bytes(int elem, int n, int P, int S) {
  (void)n;
  return static_cast<int>(smem_bytes(elem, P, S));
}
