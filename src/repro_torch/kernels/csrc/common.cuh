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

// Shared memory one block may take on the H100 (sm_90) once it opts in.
constexpr size_t SMEM_OPTIN = 227 * 1024;

// Let `kernel` take `bytes` of dynamic shared memory beside `reserve`
// bytes of its own static shared memory: where the two together pass the
// default 48 KB a kernel must opt in. Returns the CUDA error code (0 on
// success).
template <typename K>
static int allow_smem(K kernel, size_t bytes, size_t reserve = 0) {
  if (bytes + reserve > SMEM_OPTIN)
    return static_cast<int>(cudaErrorInvalidValue);
  if (bytes + reserve <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes)));
}
