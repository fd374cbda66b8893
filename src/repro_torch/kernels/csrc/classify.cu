// Leaf-level theta classification of the FMM topology phase.
//
// Replaces the Pallas kernel repro/kernels/topology/classify.py
// (_classify_pallas, pallas_call at :103; wrapper leaf_classify_pallas).
// For every (problem, leaf box, candidate) it applies the theta test
// R + theta*r <= theta*d and the Carrier-Greengard swapped test, and
// writes five keyed int32 arrays (strong, weak, p2p, p2l, m2p): the
// candidate id where the class holds, INT32_MAX where it does not.
//
// Bound on the H100: bytes. Each pair reads a 4-byte candidate id and
// writes 5 x 4 bytes of keys; the candidate geometry is a gather from
// the (B, 4^L) center/radius arrays, which stay in L2 (16384 leaves are
// 384 KB in f64). About 30 floating-point operations per pair is far
// below the card's ratio of operations to bytes.
//
// Design: one thread per (problem, box, candidate), consecutive threads
// on consecutive candidates of one box, so the id loads and the five key
// stores are coalesced; the target's own geometry is one broadcast load
// per warp. No shared memory, no atomics.
//
// Bit parity: the lists must equal those of the JAX reference bit for
// bit. XLA's CPU build computes hypot as max*sqrt(fma(r, r, 1)) with
// r = min/max, and contracts the theta test's big + theta*small into one
// fused multiply-add. This kernel writes exactly those two sums as fma()
// and every other product, quotient, difference and root with an _rn
// intrinsic, so nvcc fuses nothing else.
#include "common.cuh"

template <typename T>
__device__ __forceinline__ T max_nan(T a, T b) {
  return (a != a) ? a : ((b != b) ? b : (a > b ? a : b));
}
template <typename T>
__device__ __forceinline__ T min_nan(T a, T b) {
  return (a != a) ? a : ((b != b) ? b : (a < b ? a : b));
}

// jnp.hypot as XLA's CPU build evaluates it.
template <typename T>
__device__ __forceinline__ T hypot_xla(T a, T b) {
  a = fabs(a);
  b = fabs(b);
  const bool inf = isinf(a) || isinf(b);
  const T x1 = max_nan(a, b), x2 = min_nan(a, b);
  const T r = Rn<T>::div(x2, x1 == T(0) ? T(1) : x1);
  const T s = Rn<T>::sqrt(Rn<T>::fma(r, r, T(1)));
  const T x = (x1 == T(0)) ? x1 : Rn<T>::mul(x1, s);
  return inf ? T(INFINITY) : x;
}

template <typename T>
__global__ void classify_kernel(const int32_t* __restrict__ cand,
                                const T* __restrict__ cx,
                                const T* __restrict__ cy,
                                const T* __restrict__ rad,
                                int nb, int C, long long total, T theta,
                                int swapped, int32_t* __restrict__ ks,
                                int32_t* __restrict__ kw,
                                int32_t* __restrict__ kp,
                                int32_t* __restrict__ kl,
                                int32_t* __restrict__ km) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= total) return;
  const long long row = i / C;             // b * nb + box
  const long long base = (row / nb) * nb;  // b * nb
  const int c = cand[i];
  const bool valid = c >= 0;
  const T tbx = cx[row], tby = cy[row], rb = rad[row];
  T ccx = T(0), ccy = T(0), rc = T(0);
  if (valid) {
    ccx = cx[base + c];
    ccy = cy[base + c];
    rc = rad[base + c];
  }
  const T d = hypot_xla(Rn<T>::sub(tbx, ccx), Rn<T>::sub(tby, ccy));
  const T big = max_nan(rb, rc), small = min_nan(rb, rc);
  const T rhs = Rn<T>::mul(theta, d);
  const bool wellsep = Rn<T>::fma(theta, small, big) <= rhs;
  const bool weak = valid && wellsep;
  const bool strong = valid && !wellsep;
  bool p2p = strong, p2l = false, m2p = false;
  if (swapped) {
    const bool sw = Rn<T>::fma(theta, big, small) <= rhs;
    p2l = strong && sw && (rc > rb);       // source larger
    m2p = strong && sw && (rc < rb);       // source smaller
    p2p = strong && !(p2l || m2p);
  }
  const int32_t K = INT32_MAX;
  ks[i] = strong ? c : K;
  kw[i] = weak ? c : K;
  kp[i] = p2p ? c : K;
  kl[i] = p2l ? c : K;
  km[i] = m2p ? c : K;
}

template <typename T>
static int launch(const void* cand, const void* cx, const void* cy,
                  const void* rad, int B, int nb, int C, double theta,
                  int swapped, void* ks, void* kw, void* kp, void* kl,
                  void* km, void* stream) {
  const long long total = (long long)B * nb * C;
  const int threads = 256;
  const long long blocks = (total + threads - 1) / threads;
  classify_kernel<T><<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)cand, (const T*)cx, (const T*)cy, (const T*)rad, nb, C,
      total, (T)theta, swapped, (int32_t*)ks, (int32_t*)kw, (int32_t*)kp,
      (int32_t*)kl, (int32_t*)km);
  return launch_status();
}

extern "C" int classify_f32(const void* cand, const void* cx, const void* cy,
                            const void* rad, int B, int nb, int C,
                            double theta, int swapped, void* ks, void* kw,
                            void* kp, void* kl, void* km, void* stream) {
  return launch<float>(cand, cx, cy, rad, B, nb, C, theta, swapped, ks, kw,
                       kp, kl, km, stream);
}

extern "C" int classify_f64(const void* cand, const void* cx, const void* cy,
                            const void* rad, int B, int nb, int C,
                            double theta, int swapped, void* ks, void* kw,
                            void* kp, void* kl, void* km, void* stream) {
  return launch<double>(cand, cx, cy, rad, B, nb, C, theta, swapped, ks, kw,
                        kp, kl, km, stream);
}

// Dynamic shared memory per block (bytes): none, the kernel reads its
// geometry straight from global memory.
extern "C" int repro_smem_bytes(int elem, int n, int P, int S) {
  (void)elem; (void)n; (void)P; (void)S;
  return 0;
}
