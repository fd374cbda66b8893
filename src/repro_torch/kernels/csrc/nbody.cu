// Direct all-pairs N-body sum, the FMM's O(N^2) baseline (paper Figs
// 5.5/5.6): for every target y_i,
//
//   phi(y_i) = sum_{j : |x_j - y_i|^2 > 0} q_j / (x_j - y_i)   (harmonic G)
//
// Self-interaction is excluded BY POSITION (|x_j - y_i|^2 > 0, as the
// TPU kernel's `denom > 0`), unlike the FMM's P2P, which excludes by
// particle rank: here every source at a target's position drops out.
//
// Replaces the Pallas kernel repro/kernels/nbody/nbody.py
// (_nbody_pallas, pallas_call at :53; wrapper nbody/ops.py:nbody_direct).
//
// Bound on the H100: operations. N targets x M sources pairs against 4
// reals per source and 2 per target of memory traffic. Without a
// division a pair is ~13 floating-point instructions and one MUFU
// reciprocal estimate: dx, dy (2), d2 (2), the Newton step (2 f32, 3
// f64), the exclusion (1), the numerators (2 + 2), the sums (2). In f32
// every one of them takes an issue slot of the SM's four schedulers,
// which issue as many instructions a clock as the FP32 pipe executes, so
// instructions a pair, not flops, set the floor; in f64 the FP64 pipe
// (64 lanes an SM) does.
//
// Design (the pair loop's notes and the card times are in PERF.md):
// - Register blocking: each of the block's 128 threads owns K targets
//   (f32 4, f64 2), targets t, t + 128, ... of the block's tile, with
//   their positions and sums in registers.
// - Packed source records (x, y, q_r, q_i) (`Rec`, csrc/pairs.cuh) in
//   shared memory, staged NB_TILE at a time through a two-stage cp.async
//   ring, so the next tile's copy overlaps this tile's arithmetic. A
//   thread reads each record once (one 16-byte broadcast load in f32,
//   two in f64) and applies it to its K targets.
// - No division: 1/d2 is rcp.approx + Newton (`fast_rcp`), and the
//   exclusion costs no compare and select. In f32, 1/d2 is capped at
//   the largest finite value (one FMNMX): at d2 = 0 the estimate is NaN
//   and the min returns the cap. In f64, which has no one-instruction
//   min, d2 is raised to the smallest normal number before the
//   reciprocal by one integer max on its high word (bit patterns of
//   non-negative doubles order as integers), so 1/d2 stays finite. At
//   d2 = 0 (coincident points: dx = dy = 0) both numerators are exactly
//   0, so the term is exactly 0. (Points so close that d2 underflows
//   below the smallest normal number, ~1e-19 apart in f32 and ~1e-154
//   in f64, are outside what either version computes: the IEEE form's
//   1/d2 overflows there.)
// - Each tile's terms are summed first and the tile sum added to the
//   target's total (the TPU kernel's per-tile block sum).
// - Source split: when the target tiles alone cannot fill the card
//   (the wrapper's `nbody_plan` decides from N and M), the grid's
//   second axis cuts the sources into `splits` ranges of `chunk`. Each
//   block writes its partial sums to a workspace, then takes a ticket
//   from its target tile's counter; the last block of a tile to arrive
//   adds the tile's partials in split order (so a second launch is
//   bitwise equal to the first), writes the result and resets the
//   counter for the next launch. No atomics on the sums.
// The ragged last tile of each range is masked by its length, so no
// padded source is read.
#include <float.h>

#include "pairs.cuh"

constexpr int NB_THREADS = 128;  // threads a block
constexpr int NB_TILE = 256;     // source records a stage

// Per real type: targets a thread, and 1/d2 (finite at d2 = 0).
template <typename T> struct Nb;
template <> struct Nb<float> {
  static constexpr int K = 4;
  static __device__ __forceinline__ float inv(float d2) {
    return fminf(fast_rcp(d2), FLT_MAX);
  }
};
template <> struct Nb<double> {
  static constexpr int K = 2;
  static __device__ __forceinline__ double inv(double d2) {
    const int hi = max(__double2hiint(d2), 0x00100000);   // DBL_MIN's
    return fast_rcp(__hiloint2double(hi, __double2loint(d2)));
  }
};

// One source record's terms added to the K targets' tile sums.
template <typename T, int K>
__device__ __forceinline__ void apply_record(const Rec<T>& s,
                                             const T (&x)[K], const T (&y)[K],
                                             T (&sr)[K], T (&si)[K]) {
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const T dx = s.x - x[k], dy = s.y - y[k];      // x_j - y_i
    const T inv = Nb<T>::inv(dx * dx + dy * dy);
    sr[k] += (s.qr * dx + s.qi * dy) * inv;
    si[k] += (s.qi * dx - s.qr * dy) * inv;
  }
}

// One staged tile of `cnt` records (CNT > 0: a full tile of CNT) added
// to the K targets' totals as one tile sum each.
template <typename T, int K, int CNT>
__device__ __forceinline__ void tile_sum(const Rec<T>* __restrict__ src,
                                         int cnt, const T (&x)[K],
                                         const T (&y)[K], T (&accr)[K],
                                         T (&acci)[K]) {
  T sr[K], si[K];
#pragma unroll
  for (int k = 0; k < K; ++k) sr[k] = si[k] = T(0);
  if constexpr (CNT > 0) {
#pragma unroll 8
    for (int j = 0; j < CNT; ++j) apply_record<T, K>(src[j], x, y, sr, si);
  } else {
#pragma unroll 2
    for (int j = 0; j < cnt; ++j) apply_record<T, K>(src[j], x, y, sr, si);
  }
#pragma unroll
  for (int k = 0; k < K; ++k) {
    accr[k] += sr[k];
    acci[k] += si[k];
  }
}

template <typename T>
__global__ void __launch_bounds__(NB_THREADS) nbody_kernel(
    const T* __restrict__ tzr, const T* __restrict__ tzi, int N,
    const T* __restrict__ szr, const T* __restrict__ szi,
    const T* __restrict__ sqr, const T* __restrict__ sqi, int M, int chunk,
    T* __restrict__ outr, T* __restrict__ outi, T* __restrict__ wsr,
    T* __restrict__ wsi, int* __restrict__ tickets) {
  constexpr int K = Nb<T>::K;
  __shared__ Rec<T> ring[2][NB_TILE];
  __shared__ int last;

  const int t = threadIdx.x;
  const long long tile0 = (long long)blockIdx.x * (NB_THREADS * K) + t;
  T x[K], y[K], accr[K], acci[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const long long i = tile0 + k * NB_THREADS;
    x[k] = i < N ? tzr[i] : T(0);
    y[k] = i < N ? tzi[i] : T(0);
    accr[k] = acci[k] = T(0);
  }

  // This block's source range [s0, s1), in tiles of NB_TILE.
  const long long s0 = (long long)blockIdx.y * chunk;
  const long long s1 = min((long long)M, s0 + chunk);
  const int ntile = s1 > s0 ? (int)((s1 - s0 + NB_TILE - 1) / NB_TILE) : 0;
  auto count = [&](int tile) {
    return (int)min((long long)NB_TILE, s1 - s0 - (long long)tile * NB_TILE);
  };
  auto issue = [&](int tile) {
    const long long b = s0 + (long long)tile * NB_TILE;
    const int cnt = count(tile);
    Rec<T>* dst = ring[tile & 1];
    for (int j = t; j < cnt; j += NB_THREADS) {
      cp_async(&dst[j].x, szr + b + j);
      cp_async(&dst[j].y, szi + b + j);
      cp_async(&dst[j].qr, sqr + b + j);
      cp_async(&dst[j].qi, sqi + b + j);
    }
  };

  if (ntile > 0) issue(0);
  cp_async_commit();
  for (int tile = 0; tile < ntile; ++tile) {
    if (tile + 1 < ntile) issue(tile + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();                       // this tile's records landed
    const int cnt = count(tile);
    if (cnt == NB_TILE)
      tile_sum<T, K, NB_TILE>(ring[tile & 1], cnt, x, y, accr, acci);
    else
      tile_sum<T, K, 0>(ring[tile & 1], cnt, x, y, accr, acci);
    __syncthreads();                       // slot consumed before refill
  }

  if (gridDim.y == 1) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const long long i = tile0 + k * NB_THREADS;
      if (i < N) {
        outr[i] = accr[k];
        outi[i] = acci[k];
      }
    }
    return;
  }

  // Split sources: publish this block's partials, then the tile's last
  // block to arrive sums them in split order.
  const long long part = (long long)blockIdx.y * N;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const long long i = tile0 + k * NB_THREADS;
    if (i < N) {
      wsr[part + i] = accr[k];
      wsi[part + i] = acci[k];
    }
  }
  __threadfence();                         // partials visible card-wide
  __syncthreads();
  if (t == 0)
    last = atomicAdd(&tickets[blockIdx.x], 1) == (int)gridDim.y - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  const int S = gridDim.y;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const long long i = tile0 + k * NB_THREADS;
    if (i < N) {
      T r = __ldcg(wsr + i), im = __ldcg(wsi + i);
#pragma unroll 8
      for (int s = 1; s < S; ++s) {
        r += __ldcg(wsr + (long long)s * N + i);
        im += __ldcg(wsi + (long long)s * N + i);
      }
      outr[i] = r;
      outi[i] = im;
    }
  }
  if (t == 0) tickets[blockIdx.x] = 0;     // ready for the next launch
}

// Target tiles of a launch: NB_THREADS * K targets each.
template <typename T>
static int target_tiles(int N) {
  const int per = NB_THREADS * Nb<T>::K;
  return (N + per - 1) / per;
}

// `tiles` must be the wrapper's count (the length of `tickets`); with
// splits > 1, `wsr`/`wsi` hold splits x N reals each.
template <typename T>
static int launch(const void* tzr, const void* tzi, int N, const void* szr,
                  const void* szi, const void* sqr, const void* sqi, int M,
                  int tiles, int splits, int chunk, void* outr, void* outi,
                  void* wsr, void* wsi, void* tickets, void* stream) {
  if (N <= 0 || tiles != target_tiles<T>(N) || splits < 1 ||
      splits > 65535 || chunk < 0 ||
      (long long)splits * chunk < (long long)M ||
      (splits > 1 && (!wsr || !wsi || !tickets)))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(tiles, splits);
  nbody_kernel<T><<<grid, NB_THREADS, 0, (cudaStream_t)stream>>>(
      (const T*)tzr, (const T*)tzi, N, (const T*)szr, (const T*)szi,
      (const T*)sqr, (const T*)sqi, M, chunk, (T*)outr, (T*)outi, (T*)wsr,
      (T*)wsi, (int*)tickets);
  return launch_status();
}

#define NBODY_ENTRY(NAME, T)                                                 \
  extern "C" int NAME(const void* tzr, const void* tzi, int N,               \
                      const void* szr, const void* szi, const void* sqr,     \
                      const void* sqi, int M, int tiles, int splits,         \
                      int chunk, void* outr, void* outi, void* wsr,          \
                      void* wsi, void* tickets, void* stream) {              \
    return launch<T>(tzr, tzi, N, szr, szi, sqr, sqi, M, tiles, splits,      \
                     chunk, outr, outi, wsr, wsi, tickets, stream);          \
  }
NBODY_ENTRY(nbody_f32, float)
NBODY_ENTRY(nbody_f64, double)

// Dynamic shared memory per block (bytes): none, the ring is static.
extern "C" int repro_smem_bytes(int elem, int n, int P, int S) {
  (void)elem;
  (void)S;
  (void)n;
  (void)P;
  return 0;
}
