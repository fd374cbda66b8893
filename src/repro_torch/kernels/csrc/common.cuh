// Shared helpers of the hand-written FMM kernels (plain C interface).
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

// Every library exports this so the Python binding can name an error.
extern "C" const char* repro_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

// Arithmetic with one explicit rounding each: nvcc never contracts these
// into fused multiply-adds. Used where results must match a reference bit
// for bit (the topology's theta test).
template <typename T> struct Rn;
template <> struct Rn<float> {
  static __device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
  static __device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
  static __device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
  static __device__ __forceinline__ float div(float a, float b) { return __fdiv_rn(a, b); }
  static __device__ __forceinline__ float sqrt(float a) { return __fsqrt_rn(a); }
  static __device__ __forceinline__ float fma(float a, float b, float c) { return __fmaf_rn(a, b, c); }
};
template <> struct Rn<double> {
  static __device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
  static __device__ __forceinline__ double sub(double a, double b) { return __dsub_rn(a, b); }
  static __device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
  static __device__ __forceinline__ double div(double a, double b) { return __ddiv_rn(a, b); }
  static __device__ __forceinline__ double sqrt(double a) { return __dsqrt_rn(a); }
  static __device__ __forceinline__ double fma(double a, double b, double c) { return __fma_rn(a, b, c); }
};

static inline int launch_status() { return static_cast<int>(cudaGetLastError()); }

// Stage one source leaf (x, y, q_r, q_i and global ranks, n slots) of
// problem row `sb = (b * nb + src) * n` and rank row `rb = src * n` into
// shared memory, the block's threads striding over the slots. Used by
// the P2P and fused evaluation kernels.
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
