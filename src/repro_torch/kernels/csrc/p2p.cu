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
// division (harmonic) or a log and an atan2 (log); at the paper's
// N = 2^20 the occupied list entries give ~8e8 pairs against ~1e7
// bytes of particle planes.
//
// Design: one block owns one target leaf, one thread per target slot
// (n_max = 64 at the paper's N_d); for each list slot the block stages
// the source leaf's x, y, q (re, im) and ranks in shared memory (the
// TPU kernel's scalar-prefetch-indexed source DMA) and every thread sums
// that leaf's pairwise terms, then adds the leaf's sum to its register
// accumulator. Masked slots (-1) are skipped, not read as a dummy row.
// Phi is written once; no atomics: results are bitwise reproducible.
#include "common.cuh"

// Stage one source leaf (x, y, q_r, q_i and global ranks, n slots) of
// problem row `sb = (b * nb + src) * n` and rank row `rb = src * n` into
// shared memory, the block's threads striding over the slots.
template <typename T>
__device__ __forceinline__ void stage_source_leaf(
    const T* __restrict__ zr, const T* __restrict__ zi,
    const T* __restrict__ qr, const T* __restrict__ qi,
    const int32_t* __restrict__ rk, long long sb, long long rb, int n,
    T* s_x, T* s_y, T* s_qr, T* s_qi, int32_t* s_rk) {
  for (int j = threadIdx.x; j < n; j += blockDim.x) {
    s_x[j] = zr[sb + j];
    s_y[j] = zi[sb + j];
    s_qr[j] = qr[sb + j];
    s_qi[j] = qi[sb + j];
    s_rk[j] = rk[rb + j];
  }
}

// The near-field sum of one staged source leaf at one target (tzr, tzi)
// of global rank trk: sum over the n slots of G(z, x), skipping padded
// slots (rank -1) and the target itself (equal rank) -- self-exclusion
// by particle identity, so distinct coincident particles keep their
// (singular) mutual term. Harmonic G = q/(x - z), log G = q log(z - x).
template <typename T, bool LOG>
__device__ __forceinline__ void p2p_leaf_sum(
    const T* s_x, const T* s_y, const T* s_qr, const T* s_qi,
    const int32_t* s_rk, int n, T tzr, T tzi, int trk, T& sr, T& si) {
  sr = T(0);
  si = T(0);
  for (int j = 0; j < n; ++j) {
    const T dx = s_x[j] - tzr, dy = s_y[j] - tzi;   // z_src - z_tgt
    const T d2 = dx * dx + dy * dy;
    const int srk = s_rk[j];
    const bool ok = srk >= 0 && srk != trk;
    const T cq = s_qr[j], sq = s_qi[j];
    if (LOG) {
      const T lr = ok ? T(0.5) * log(d2) : T(0);
      const T li = ok ? atan2(-dy, -dx) : T(0);
      sr += cq * lr - sq * li;
      si += cq * li + sq * lr;
    } else {
      const T inv = ok ? T(1) / d2 : T(0);          // q/(dx + i dy)
      sr += (cq * dx + sq * dy) * inv;
      si += (sq * dx - cq * dy) * inv;
    }
  }
}

template <typename T, bool LOG>
__global__ void p2p_kernel(const int32_t* __restrict__ lists, int S,
                           const T* __restrict__ zr, const T* __restrict__ zi,
                           const T* __restrict__ qr, const T* __restrict__ qi,
                           const int32_t* __restrict__ rk, int nb, int n,
                           T* __restrict__ outr, T* __restrict__ outi) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* s_x = reinterpret_cast<T*>(smem_raw);
  T* s_y = s_x + n;
  T* s_qr = s_y + n;
  T* s_qi = s_qr + n;
  int32_t* s_rk = reinterpret_cast<int32_t*>(s_qi + n);

  const int t = threadIdx.x;
  const long long b = blockIdx.y;
  const int box = blockIdx.x;
  const long long row = b * nb + box;
  const bool act = t < n;
  const T tzr = act ? zr[row * n + t] : T(0);
  const T tzi = act ? zi[row * n + t] : T(0);
  const int trk = act ? rk[(long long)box * n + t] : -1;

  T accr = T(0), acci = T(0);
  for (int s = 0; s < S; ++s) {
    const int src = lists[row * S + s];
    if (src < 0) continue;                     // block-uniform
    __syncthreads();                           // previous stage consumed
    stage_source_leaf(zr, zi, qr, qi, rk, (b * nb + src) * n,
                      (long long)src * n, n, s_x, s_y, s_qr, s_qi, s_rk);
    __syncthreads();
    T sr, si;
    p2p_leaf_sum<T, LOG>(s_x, s_y, s_qr, s_qi, s_rk, n, tzr, tzi, trk, sr,
                         si);
    accr += sr;
    acci += si;
  }
  if (act) {
    outr[row * n + t] = accr;
    outi[row * n + t] = acci;
  }
}

// Dynamic shared memory of one block: a staged source leaf (x, y, q_r,
// q_i, rank).
static size_t smem_bytes(size_t elem, int n) {
  return elem * (size_t)(4 * n) + sizeof(int32_t) * (size_t)n;
}

template <typename T>
static int launch(const void* lists, int S, const void* zr, const void* zi,
                  const void* qr, const void* qi, const void* rk, int B,
                  int nb, int n, int log_kernel, void* outr, void* outi,
                  void* stream) {
  const int nt = ((n + 31) / 32) * 32;
  const size_t smem = smem_bytes(sizeof(T), n);
  if (nt > 1024 || smem > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(nb, B);
  cudaStream_t s = (cudaStream_t)stream;
#define P2P_ARGS                                                              \
  (const int32_t*)lists, S, (const T*)zr, (const T*)zi, (const T*)qr,         \
      (const T*)qi, (const int32_t*)rk, nb, n, (T*)outr, (T*)outi
  if (log_kernel)
    p2p_kernel<T, true><<<grid, nt, smem, s>>>(P2P_ARGS);
  else
    p2p_kernel<T, false><<<grid, nt, smem, s>>>(P2P_ARGS);
#undef P2P_ARGS
  return launch_status();
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
  (void)S;
  (void)P;
  return static_cast<int>(smem_bytes(elem, n));
}
