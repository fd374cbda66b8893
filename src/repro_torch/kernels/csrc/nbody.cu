// Direct all-pairs N-body sum, the FMM's O(N^2) baseline (paper Figs
// 5.5/5.6): for every target y_i,
//
//   phi(y_i) = sum_{j : x_j != y_i} q_j / (x_j - y_i)       (harmonic G)
//
// Self-interaction is excluded BY POSITION (|x_j - y_i|^2 > 0, as the
// TPU kernel's `denom > 0`), unlike the FMM's P2P, which excludes by
// particle rank: here every source at a target's position drops out.
//
// Replaces the Pallas kernel repro/kernels/nbody/nbody.py
// (_nbody_pallas, pallas_call at :53; wrapper nbody/ops.py:nbody_direct).
//
// Bound on the H100: operations. N targets x M sources pairs, each ~12
// flops and one IEEE division (__fdiv_rn / __ddiv_rn: f64 division is a
// reciprocal plus Newton steps on the card, several f64 operations
// each), against 4 reals per source and 2 per target of memory traffic.
//
// Design: the classic tiled all-pairs scheme. One thread owns one
// target and keeps its sum in registers for the whole kernel; the block
// walks over the sources in tiles of NBODY_TILE, staging each tile's
// (x, y, q_r, q_i) in shared memory, one source per thread. Each tile's
// terms are summed first and the tile sum added to the target's total
// (the TPU kernel's per-tile block sum). The ragged last tile is
// masked by its length, so no padded sources are read. No atomics.
#include "common.cuh"

#define NBODY_TILE 256

template <typename T>
__global__ void nbody_kernel(const T* __restrict__ tzr,
                             const T* __restrict__ tzi, int N,
                             const T* __restrict__ szr,
                             const T* __restrict__ szi,
                             const T* __restrict__ sqr,
                             const T* __restrict__ sqi, int M,
                             T* __restrict__ outr, T* __restrict__ outi) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* s_x = reinterpret_cast<T*>(smem_raw);
  T* s_y = s_x + NBODY_TILE;
  T* s_qr = s_y + NBODY_TILE;
  T* s_qi = s_qr + NBODY_TILE;

  const int t = threadIdx.x;
  const long long i = (long long)blockIdx.x * NBODY_TILE + t;
  const bool act = i < N;
  const T x = act ? tzr[i] : T(0);
  const T y = act ? tzi[i] : T(0);
  T accr = T(0), acci = T(0);
  for (long long base = 0; base < M; base += NBODY_TILE) {
    __syncthreads();                           // previous tile consumed
    const long long j = base + t;
    if (j < M) {
      s_x[t] = szr[j];
      s_y[t] = szi[j];
      s_qr[t] = sqr[j];
      s_qi[t] = sqi[j];
    }
    __syncthreads();
    const int cnt = (int)min((long long)NBODY_TILE, M - base);
    T sr = T(0), si = T(0);
    for (int k = 0; k < cnt; ++k) {
      const T dx = s_x[k] - x, dy = s_y[k] - y;      // x_j - y_i
      const T d2 = dx * dx + dy * dy;
      const T inv = d2 > T(0) ? Rn<T>::div(T(1), d2) : T(0);
      const T cq = s_qr[k], sq = s_qi[k];
      sr += (cq * dx + sq * dy) * inv;
      si += (sq * dx - cq * dy) * inv;
    }
    accr += sr;
    acci += si;
  }
  if (act) {
    outr[i] = accr;
    outi[i] = acci;
  }
}

// Dynamic shared memory of one block: one source tile (x, y, q_r, q_i).
static size_t smem_bytes(size_t elem) {
  return elem * (size_t)(4 * NBODY_TILE);
}

template <typename T>
static int launch(const void* tzr, const void* tzi, int N, const void* szr,
                  const void* szi, const void* sqr, const void* sqi, int M,
                  void* outr, void* outi, void* stream) {
  const dim3 grid((N + NBODY_TILE - 1) / NBODY_TILE);
  nbody_kernel<T><<<grid, NBODY_TILE, smem_bytes(sizeof(T)),
                    (cudaStream_t)stream>>>(
      (const T*)tzr, (const T*)tzi, N, (const T*)szr, (const T*)szi,
      (const T*)sqr, (const T*)sqi, M, (T*)outr, (T*)outi);
  return launch_status();
}

#define NBODY_ENTRY(NAME, T)                                                  \
  extern "C" int NAME(const void* tzr, const void* tzi, int N,                \
                      const void* szr, const void* szi, const void* sqr,      \
                      const void* sqi, int M, void* outr, void* outi,         \
                      void* stream) {                                         \
    return launch<T>(tzr, tzi, N, szr, szi, sqr, sqi, M, outr, outi, stream); \
  }
NBODY_ENTRY(nbody_f32, float)
NBODY_ENTRY(nbody_f64, double)

// Dynamic shared memory per block (bytes) of a launch at these sizes.
extern "C" int repro_smem_bytes(int elem, int n, int P, int S) {
  (void)S;
  (void)n;
  (void)P;
  return static_cast<int>(smem_bytes(elem));
}
