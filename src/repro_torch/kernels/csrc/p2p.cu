// Near-field direct evaluation over the leaf P2P lists (the per-phase
// FMM path's P2P): for every target particle z of leaf box b,
//
//   phi(z) = sum_{s in p2p(b)} sum_{x in leaf s, rank x != rank z} G(z, x)
//            harmonic G = q/(x - z),  log G = q log(z - x)
//
// Replaces the Pallas kernel repro/kernels/p2p/p2p.py (_p2p_pallas,
// pallas_call at :104; wrapper p2p/ops.py:p2p_apply). Self-interaction
// is excluded by global particle rank, never by position, so distinct
// coincident particles keep their mutual term.
//
// Bound on the H100: operations. Each pair is ~12 flops plus one
// reciprocal (harmonic) or a log and an atan2 (log); at the paper's
// N = 2^20 the occupied list entries give ~8e8 pairs against ~1e7
// bytes of particle planes.
//
// Design: the fused evaluation's pair loop (csrc/pairs.cuh:near_sum; its
// notes are in eval_fused.cu) with a zero seed and its own store. One
// warp owns one target leaf (four a block), every lane two targets; the
// warp reads its list row once and compacts it with a ballot, streams
// the listed source leaves as packed records through a two-stage
// cp.async ring, bounds each leaf's loop by its valid count and tests
// ranks only in the own-leaf slot; the harmonic reciprocal is
// rcp.approx + Newton, the f64 log pair's logarithm clog.cuh's (its
// tables staged once a block, behind the one block barrier). Otherwise
// only warp barriers; no atomics: results are
// bitwise reproducible and a problem's row of a batch equals its own
// launch. It replaces a first design (one block a leaf, one thread a
// target, a serial list scan, two block barriers a source leaf and an
// IEEE division a pair), which ran at 17% / 26% of the bound (f32 /
// f64) on the card.
#include "pairs.cuh"

constexpr int WARPS = 4;       // target leaves per block, one warp each

// One warp's shared memory: the ring (records, ranks) and its list row.
static __host__ __device__ size_t warp_bytes(size_t elem, int n, int S) {
  const size_t b = elem * (size_t)ring_elems(n)
                   + sizeof(int32_t) * (size_t)(ring_ranks(n) + S);
  return (b + 15) / 16 * 16;
}

template <typename T, bool LOG, int NF>
__global__ void __launch_bounds__(WARPS * 32, 5) p2p_kernel(
    const int32_t* __restrict__ lists, int S, const T* __restrict__ zr,
    const T* __restrict__ zi, const T* __restrict__ qr,
    const T* __restrict__ qi, const int32_t* __restrict__ rk, int nb, int n_,
    T* __restrict__ outr, T* __restrict__ outi) {
  const int n = NF > 0 ? NF : n_;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int box = blockIdx.x * (blockDim.x >> 5) + warp;
  if constexpr (LOG && sizeof(T) == 8) clog_stage();   // a block barrier
  if (box >= nb) return;                 // warp-uniform: warp barriers only
  const long long b = blockIdx.y, row = b * nb + box;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* region = reinterpret_cast<T*>(smem_raw
                                   + warp * warp_bytes(sizeof(T), n, S));
  Rec<T>* ring = reinterpret_cast<Rec<T>*>(region);
  int32_t* s_rank = reinterpret_cast<int32_t*>(region + ring_elems(n));
  int32_t* s_list = s_rank + ring_ranks(n);

  const int np = compact(lists + row * S, S, s_list, lane);
  for (int g0 = 0; g0 < n; g0 += GROUP) {
    const int t0 = g0 + lane, t1 = g0 + 32 + lane;
    const bool a0 = t0 < n, a1 = t1 < n;
    const T z0r = a0 ? zr[row * n + t0] : T(0);
    const T z0i = a0 ? zi[row * n + t0] : T(0);
    const T z1r = a1 ? zr[row * n + t1] : T(0);
    const T z1i = a1 ? zi[row * n + t1] : T(0);
    T p0r = T(0), p0i = T(0), p1r = T(0), p1i = T(0);
    near_sum<T, LOG, NF>(s_list, np, box, b, nb, n, zr, zi, qr, qi, rk, ring,
                         s_rank, lane, t0, t1, z0r, z0i, z1r, z1i, p0r, p0i,
                         p1r, p1i);
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

static int warps_per_block(size_t elem, int n, int S, size_t reserve = 0) {
  return fit_warps(warp_bytes(elem, n, S), WARPS, reserve);
}

// Dynamic shared memory of one block: each warp's ring and list row
// (`reserve`: static shared memory beside it, the clog tables).
static size_t smem_bytes(size_t elem, int n, int S, size_t reserve = 0) {
  return warps_per_block(elem, n, S, reserve) * warp_bytes(elem, n, S);
}

template <typename T, bool LOG, int NF>
static int launch_one(dim3 grid, int wpb, size_t smem, cudaStream_t s,
                      const void* lists, int S, const void* zr,
                      const void* zi, const void* qr, const void* qi,
                      const void* rk, int nb, int n, void* outr,
                      void* outi) {
  const int rc = allow_smem(p2p_kernel<T, LOG, NF>, smem,
                           LOG && sizeof(T) == 8 ? CLOG_SMEM : 0);
  if (rc) return rc;
  p2p_kernel<T, LOG, NF><<<grid, wpb * 32, smem, s>>>(
      (const int32_t*)lists, S, (const T*)zr, (const T*)zi, (const T*)qr,
      (const T*)qi, (const int32_t*)rk, nb, n, (T*)outr, (T*)outi);
  return launch_status();
}

template <typename T>
static int launch(const void* lists, int S, const void* zr, const void* zi,
                  const void* qr, const void* qi, const void* rk, int B,
                  int nb, int n, int log_kernel, void* outr, void* outi,
                  void* stream) {
  const size_t reserve = log_kernel && sizeof(T) == 8 ? CLOG_SMEM : 0;
  const int wpb = warps_per_block(sizeof(T), n, S, reserve);
  if (n < 1 || S < 1 || wpb < 1) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes(sizeof(T), n, S, reserve);
  const dim3 grid((nb + wpb - 1) / wpb, B);
  cudaStream_t s = (cudaStream_t)stream;
#define P2P_ARGS \
  grid, wpb, smem, s, lists, S, zr, zi, qr, qi, rk, nb, n, outr, outi
  if (n == NFIX)
    return log_kernel ? launch_one<T, true, NFIX>(P2P_ARGS)
                      : launch_one<T, false, NFIX>(P2P_ARGS);
  return log_kernel ? launch_one<T, true, 0>(P2P_ARGS)
                    : launch_one<T, false, 0>(P2P_ARGS);
#undef P2P_ARGS
}

#define P2P_ENTRY(NAME, T)                                                    \
  extern "C" int NAME(const void* lists, int S, const void* zr,               \
                      const void* zi, const void* qr, const void* qi,         \
                      const void* rk, int B, int nb, int n, int log_kernel,   \
                      void* outr, void* outi, void* stream) {                 \
    return launch<T>(lists, S, zr, zi, qr, qi, rk, B, nb, n, log_kernel,      \
                     outr, outi, stream);                                     \
  }
P2P_ENTRY(p2p_f32, float)
P2P_ENTRY(p2p_f64, double)

// Dynamic shared memory per block (bytes) of a launch at these sizes.
extern "C" int repro_smem_bytes(int elem, int n, int P, int S) {
  (void)P;
  return static_cast<int>(smem_bytes(elem, n, S));
}
