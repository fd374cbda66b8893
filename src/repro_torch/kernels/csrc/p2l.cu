// Direct particle-to-local (P2L) shifts of the FMM downward pass for the
// Carrier-Greengard swapped-theta leaf pairs, radius-normalized, for both
// G-kernels.
//
// Replaces the Pallas kernel repro/kernels/eval/p2l.py (_p2l_pallas,
// pallas_call at :151; wrapper eval/ops.py:p2l_apply). For every target
// leaf and every source box in its p2l list, the source particles x
// (strengths q) shift straight into the target's local coefficients:
//
//   harmonic  b~_l += sum q/(x - z0) * (rho/(x - z0))^l          (l = 0..p)
//   log       b~_0 += sum q log(z0 - x),
//             b~_l += -(1/l) sum q (rho/(x - z0))^l              (l >= 1)
//
// A source lane with d2 = |x - z0|^2 == 0 is masked, as in the Pallas
// kernel (p2l.py:67-76): it covers the zero-charge padding slots without
// a validity plane. At a real particle exactly on the target's center
// this contributes 0 where the plain sweep core/fmm.py:p2l_sweep goes
// singular — a measure-zero geometry.
//
// Bound on the H100: bytes. The lists are nearly empty (at N = 2^20,
// p = 17 about 1% of the slots are occupied, ~0.5 entries a leaf), so
// the work is ~9e7 flops, about a microsecond at the vector rate, while
// the list rows, the referenced source leaves' planes and the p+1
// outputs of every leaf take several microseconds at 3.35 TB/s.
//
// K densities on one geometry (p2l_block_kernel): the density is the
// grid's second axis over the one copy of the lists, centres, radii and
// positions (problem stride 0); each density's sums are the K = 1
// kernel's, bit for bit.
//
// Design: one warp owns one target leaf (WARPS a block); there is no
// block barrier and no atomic, so a warp never waits on another and
// results are bitwise reproducible (a problem's row of a batch equals its
// own launch).
// 1. The warp reads its list row once, coalesced (ceil(S/32) loads a
//    lane), and compacts the occupied slots in list order with a ballot
//    (pairs.cuh:compact). A leaf with no entry stores its p+1 zeros and
//    is done: most leaves, so the kernel's time is mostly this read and
//    these stores.
// 2. For each entry in list order, lane j takes particles j, j + 32, ...
//    of the source leaf, straight from the planes (coalesced rows: at
//    ~0.5 entries a leaf a shared-memory ring has nothing to overlap),
//    forms 1/(x - z0) (rcp.approx + Newton, only where d2 > 0) and the
//    power recurrence, and adds each term to a per-lane accumulator that
//    lives across all of the leaf's entries.
// 3. After the last entry one fixed-order warp reduction per coefficient
//    (an xor shuffle butterfly: every lane ends with the same bits), and
//    lane l stores coefficient l. The log kernel scales b~_l by -1/l at
//    the store.
// 4. p = 17 (P = 18) keeps the 2P accumulators in registers; other P keep
//    them in a per-warp shared array with rows padded to 33 lanes, summed
//    row by row by lane l after the last entry. n = 64 is an instantiation
//    (both particles of a lane's leaf loaded before the arithmetic); other
//    n take the generic loop.
// It replaces a first design (one block a leaf, a serial scan of all S
// list slots with one dependent global load each, and per occupied slot a
// shared-memory tree reduction with 7 block barriers), which ran at 7% /
// 10% of its bound (f32 / f64) on the card. Tried on the card at the
// uniform 2^20 plan and found slower (20 back-to-back launches, f32 /
// f64): eight warps a block, 0.0145 / 0.0273 ms against four warps'
// 0.0138 / 0.0233 (the f64 instantiation takes 120 registers, so a
// four-warp block fills the SM's register file in finer steps); in f64
// the accumulators in the shared array instead of registers, 0.0393 ms;
// the generic n loop at n = 64, 0.0154 / 0.0261.
// What holds it at ~1/4 of the bound is latency: most warps issue one
// list-row read and one store, and the register count caps the warps in
// flight that could hide it (16 an SM in f64, 32 in f32).
#include "pairs.cuh"

constexpr int WARPS = 4;       // target leaves per block, one warp each
constexpr int PFIX = 18;       // P = p + 1 at the paper's p = 17
constexpr int ROW = 33;        // lanes a row of the shared accumulators

// One warp's shared memory: its compacted list row and, for the generic
// P, the (2, P, ROW) accumulators.
static __host__ __device__ size_t warp_bytes(size_t elem, int P, int S,
                                             bool regs) {
  size_t b = sizeof(int32_t) * (size_t)S;
  b = (b + 15) / 16 * 16;
  if (!regs) b += elem * (size_t)(2 * P * ROW);
  return b;
}

// The terms of one source particle (x, q) at the target center c with
// radius rh: add(l, re, im) for l = 0 .. P-1 (P = PF where PF > 0).
template <typename T, bool LOG, int PF, typename Add>
__device__ __forceinline__ void particle_terms(T px, T py, T cq, T sq, T cr,
                                               T ci, T rh, int P_, Add add) {
  const int P = PF > 0 ? PF : P_;
  const T dxr = px - cr, dxi = py - ci;      // x - z0
  const T d2 = dxr * dxr + dxi * dxi;
  const bool ok = d2 > T(0);
  const T k = ok ? fast_rcp(d2) : T(0);
  const T invr = dxr * k, invi = -dxi * k;  // 1 / (x - z0)
  const T wr = rh * invr, wi = rh * invi;   // rho / (x - z0)
  T pwr, pwi;
  constexpr int l0 = LOG ? 1 : 0;
  if constexpr (LOG) {
    // b~_0 term: q log(z0 - x) = q (log|d|, arg(-d))
    const T lr = ok ? T(0.5) * log(d2) : T(0);
    const T li = ok ? atan2(-dxi, -dxr) : T(0);
    add(0, cq * lr - sq * li, cq * li + sq * lr);
    pwr = cq * wr - sq * wi;
    pwi = cq * wi + sq * wr;
  } else {
    pwr = cq * invr - sq * invi;
    pwi = cq * invi + sq * invr;
  }
#pragma unroll
  for (int l = l0; l < P; ++l) {
    add(l, pwr, pwi);
    const T nr = pwr * wr - pwi * wi;
    pwi = pwr * wi + pwi * wr;
    pwr = nr;
  }
}

// The sum over all lanes of v, the same bits in every lane.
template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) v += __shfl_xor_sync(0xffffffffu, v, m);
  return v;
}

// Coefficient l of the leaf's sums as stored: -v/l for the log kernel's
// l >= 1.
template <typename T, bool LOG>
__device__ __forceinline__ T scaled(T v, int l) {
  return LOG && l > 0 ? -v / T(l) : v;
}

// The kernel's body: problem blockIdx.y (p2l_kernel, DENS false), or
// density c = blockIdx.y of the charges and the result on the one
// geometry b = 0 (lists, centres, radii, positions; p2l_block_kernel).
template <typename T, bool LOG, int PF, int NF, bool DENS>
__device__ __forceinline__ void p2l_body(
    const int32_t* __restrict__ lists, const T* __restrict__ z0r,
    const T* __restrict__ z0i, const T* __restrict__ rho,
    const T* __restrict__ xr, const T* __restrict__ xi,
    const T* __restrict__ qr, const T* __restrict__ qi, int nb, int S,
    int n_, int P_, T* __restrict__ outr, T* __restrict__ outi) {
  const int n = NF > 0 ? NF : n_;
  const int P = PF > 0 ? PF : P_;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int box = blockIdx.x * (blockDim.x >> 5) + warp;
  if (box >= nb) return;                 // warp-uniform: warp barriers only
  const long long b = DENS ? 0 : blockIdx.y, row = b * nb + box;
  const long long c = blockIdx.y, crow = DENS ? c * nb + box : row;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* mine = smem_raw + warp * warp_bytes(sizeof(T), P, S, PF > 0);
  int32_t* s_list = reinterpret_cast<int32_t*>(mine);

  const T cr = z0r[row], ci = z0i[row], rh = rho[row];
  const int ne = compact(lists + row * S, S, s_list, lane);
  T* o_r = outr + crow * P;
  T* o_i = outi + crow * P;
  if (ne == 0) {                         // warp-uniform
    for (int l = lane; l < P; l += 32) o_r[l] = o_i[l] = T(0);
    return;
  }
  __syncwarp();                          // list written

  if constexpr (PF > 0) {
    T ar[PF], ai[PF];
#pragma unroll
    for (int l = 0; l < PF; ++l) ar[l] = ai[l] = T(0);
    auto add = [&](int l, T re, T im) {
      ar[l] += re;
      ai[l] += im;
    };
    for (int e = 0; e < ne; ++e) {
      const long long base = (b * nb + s_list[e]) * n + lane;
      const long long qbase = DENS ? (c * nb + s_list[e]) * n + lane : base;
      if constexpr (NF > 0 && NF % 32 == 0) {
        // every lane's NF/32 particles loaded before the arithmetic
        constexpr int K = NF / 32;
        T px[K], py[K], cq[K], sq[K];
#pragma unroll
        for (int k = 0; k < K; ++k) {
          px[k] = xr[base + 32 * k];
          py[k] = xi[base + 32 * k];
          cq[k] = qr[qbase + 32 * k];
          sq[k] = qi[qbase + 32 * k];
        }
#pragma unroll
        for (int k = 0; k < K; ++k)
          particle_terms<T, LOG, PF>(px[k], py[k], cq[k], sq[k], cr, ci, rh,
                                     P, add);
      } else {
        for (int j = 0; lane + j < n; j += 32)
          particle_terms<T, LOG, PF>(xr[base + j], xi[base + j],
                                     qr[qbase + j], qi[qbase + j], cr, ci,
                                     rh, P, add);
      }
    }
    T mr = T(0), mi = T(0);
#pragma unroll
    for (int l = 0; l < PF; ++l) {
      const T sr = warp_sum(ar[l]), si = warp_sum(ai[l]);
      if (lane == l) {
        mr = sr;
        mi = si;
      }
    }
    if (lane < PF) {
      o_r[lane] = scaled<T, LOG>(mr, lane);
      o_i[lane] = scaled<T, LOG>(mi, lane);
    }
  } else {
    T* acc_r = reinterpret_cast<T*>(mine
                                    + (sizeof(int32_t) * S + 15) / 16 * 16);
    T* acc_i = acc_r + P * ROW;
    for (int l = 0; l < P; ++l) {
      acc_r[l * ROW + lane] = T(0);
      acc_i[l * ROW + lane] = T(0);
    }
    auto add = [&](int l, T re, T im) {
      acc_r[l * ROW + lane] += re;
      acc_i[l * ROW + lane] += im;
    };
    for (int e = 0; e < ne; ++e) {
      const long long base = (b * nb + s_list[e]) * n + lane;
      const long long qbase = DENS ? (c * nb + s_list[e]) * n + lane : base;
      for (int j = 0; lane + j < n; j += 32)
        particle_terms<T, LOG, 0>(xr[base + j], xi[base + j], qr[qbase + j],
                                  qi[qbase + j], cr, ci, rh, P, add);
    }
    __syncwarp();                        // every lane's column written
    for (int l = lane; l < P; l += 32) {
      T sr = T(0), si = T(0);
      for (int k = 0; k < 32; ++k) {
        sr += acc_r[l * ROW + k];
        si += acc_i[l * ROW + k];
      }
      o_r[l] = scaled<T, LOG>(sr, l);
      o_i[l] = scaled<T, LOG>(si, l);
    }
  }
}

template <typename T, bool LOG, int PF, int NF>
__global__ void __launch_bounds__(WARPS * 32) p2l_kernel(
    const int32_t* __restrict__ lists, const T* __restrict__ z0r,
    const T* __restrict__ z0i, const T* __restrict__ rho,
    const T* __restrict__ xr, const T* __restrict__ xi,
    const T* __restrict__ qr, const T* __restrict__ qi, int nb, int S,
    int n_, int P_, T* __restrict__ outr, T* __restrict__ outi) {
  p2l_body<T, LOG, PF, NF, false>(lists, z0r, z0i, rho, xr, xi, qr, qi, nb,
                                  S, n_, P_, outr, outi);
}

// K densities on one geometry: density blockIdx.y of the (K, nb, n)
// charge planes and the (K, nb, P) result, over the single (1, ...)
// lists, centres, radii and positions (read with problem stride 0).
template <typename T, bool LOG, int PF, int NF>
__global__ void __launch_bounds__(WARPS * 32) p2l_block_kernel(
    const int32_t* __restrict__ lists, const T* __restrict__ z0r,
    const T* __restrict__ z0i, const T* __restrict__ rho,
    const T* __restrict__ xr, const T* __restrict__ xi,
    const T* __restrict__ qr, const T* __restrict__ qi, int nb, int S,
    int n_, int P_, T* __restrict__ outr, T* __restrict__ outi) {
  p2l_body<T, LOG, PF, NF, true>(lists, z0r, z0i, rho, xr, xi, qr, qi, nb,
                                 S, n_, P_, outr, outi);
}

static bool in_registers(int P) { return P == PFIX; }

static int warps_per_block(size_t elem, int P, int S) {
  return fit_warps(warp_bytes(elem, P, S, in_registers(P)), WARPS);
}

// Dynamic shared memory of one block: each warp's list row (and
// accumulators for the generic P).
static size_t smem_bytes(size_t elem, int P, int S) {
  return warps_per_block(elem, P, S)
         * warp_bytes(elem, P, S, in_registers(P));
}

template <typename T, bool LOG, int PF, int NF>
static int launch_one(dim3 grid, int wpb, size_t smem, cudaStream_t s,
                      const void* lists, const void* z0r, const void* z0i,
                      const void* rho, const void* xr, const void* xi,
                      const void* qr, const void* qi, int nb, int S, int n,
                      int P, void* outr, void* outi, bool dens) {
  auto kernel = dens ? p2l_block_kernel<T, LOG, PF, NF>
                     : p2l_kernel<T, LOG, PF, NF>;
  const int rc = allow_smem(kernel, smem);
  if (rc) return rc;
  kernel<<<grid, wpb * 32, smem, s>>>(
      (const int32_t*)lists, (const T*)z0r, (const T*)z0i, (const T*)rho,
      (const T*)xr, (const T*)xi, (const T*)qr, (const T*)qi, nb, S, n, P,
      (T*)outr, (T*)outi);
  return launch_status();
}

template <typename T, bool LOG>
static int launch_kernel(dim3 grid, int wpb, size_t smem, cudaStream_t s,
                         const void* lists, const void* z0r, const void* z0i,
                         const void* rho, const void* xr, const void* xi,
                         const void* qr, const void* qi, int nb, int S, int n,
                         int P, void* outr, void* outi, bool dens) {
#define P2L_ARGS                                                              \
  grid, wpb, smem, s, lists, z0r, z0i, rho, xr, xi, qr, qi, nb, S, n, P, outr, \
      outi, dens
  if (in_registers(P))
    return n == NFIX ? launch_one<T, LOG, PFIX, NFIX>(P2L_ARGS)
                     : launch_one<T, LOG, PFIX, 0>(P2L_ARGS);
  return launch_one<T, LOG, 0, 0>(P2L_ARGS);
#undef P2L_ARGS
}

// B problems (dens 0), or B densities on one geometry (dens 1).
template <typename T>
static int launch(const void* lists, const void* z0r, const void* z0i,
                  const void* rho, const void* xr, const void* xi,
                  const void* qr, const void* qi, int B, int nb, int S, int n,
                  int P, int log_kernel, void* outr, void* outi,
                  void* stream, bool dens = false) {
  const int wpb = warps_per_block(sizeof(T), P, S);
  if (n < 1 || P < 1 || S < 1 || wpb < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes(sizeof(T), P, S);
  const dim3 grid((nb + wpb - 1) / wpb, B);
  cudaStream_t s = (cudaStream_t)stream;
  return log_kernel
             ? launch_kernel<T, true>(grid, wpb, smem, s, lists, z0r, z0i,
                                      rho, xr, xi, qr, qi, nb, S, n, P, outr,
                                      outi, dens)
             : launch_kernel<T, false>(grid, wpb, smem, s, lists, z0r, z0i,
                                       rho, xr, xi, qr, qi, nb, S, n, P, outr,
                                       outi, dens);
}

#define P2L_ENTRY(NAME, T)                                                    \
  extern "C" int NAME(const void* lists, const void* z0r, const void* z0i,    \
                      const void* rho, const void* xr, const void* xi,        \
                      const void* qr, const void* qi, int B, int nb, int S,   \
                      int n, int P, int log_kernel, void* outr, void* outi,   \
                      void* stream) {                                         \
    return launch<T>(lists, z0r, z0i, rho, xr, xi, qr, qi, B, nb, S, n, P,    \
                     log_kernel, outr, outi, stream);                         \
  }
P2L_ENTRY(p2l_f32, float)
P2L_ENTRY(p2l_f64, double)

#define P2L_BLOCK_ENTRY(NAME, T)                                              \
  extern "C" int NAME(const void* lists, const void* z0r, const void* z0i,    \
                      const void* rho, const void* xr, const void* xi,        \
                      const void* qr, const void* qi, int K, int nb, int S,   \
                      int n, int P, int log_kernel, void* outr, void* outi,   \
                      void* stream) {                                         \
    return launch<T>(lists, z0r, z0i, rho, xr, xi, qr, qi, K, nb, S, n, P,    \
                     log_kernel, outr, outi, stream, true);                   \
  }
P2L_BLOCK_ENTRY(p2l_block_f32, float)
P2L_BLOCK_ENTRY(p2l_block_f64, double)

// Dynamic shared memory per block (bytes) of a launch at these sizes.
extern "C" int repro_smem_bytes(int elem, int n, int P, int S) {
  (void)n;
  return static_cast<int>(smem_bytes(elem, P, S));
}
