// Level-fused multipole-to-local (M2L) translation of the FMM downward
// pass, radius-normalized, for both G-kernels.
//
// Replaces the Pallas kernel repro/kernels/m2l/m2l.py (_m2l_pallas,
// pallas_call at :149; wrapper m2l/ops.py:m2l_fused_apply). For every
// target box of the flattened all-levels axis (sum 4^l boxes) and every
// slot w of its weak list:
//
//   a^_k  = a_k (rho_s/r)^k                      (k >= 1; a^_0 = a_0)
//   b^_l  = sum_k H[l][k] a^_k,   H[l][k] = C(l+k-1, k-1) ...
//   out_l += b^_l (-rho_t/r)^l   (+ a_0 log r on l = 0 for the log kernel)
//
// Bound on the H100: operations. Per list entry the (p+1)^2 real-by-
// complex matrix-vector product is 4 (p+1)^2 flops (1.3 kflop at p = 17)
// and the two power recurrences about 12 p more, against ~0.3 KB of
// operands (a multipole row, four ratio values), so the work sits well
// above the bytes line in f64 and near it in f32.
//
// Design: one warp owns one target box, lanes own output indices l (two
// per lane for p+1 > 32). H (p+1)^2 lives in shared memory for the
// whole block; per weak slot the warp stages the pre-scaled source row
// a^ in shared memory, each lane takes the dot product of its row of H
// with it, post-scales with its own power recurrence and accumulates in
// registers. The weak loop runs over all slots of the box (no grid-step
// carry as on the TPU); masked slots are skipped. Every box stores its
// (p+1) outputs once: no atomics, results are bitwise reproducible.
#include "common.cuh"

constexpr int WARPS = 4;
constexpr int MAX_PER_LANE = 2;   // p + 1 <= 64

template <typename T, bool LOG>
__global__ void m2l_kernel(const int32_t* __restrict__ weak,
                           const T* __restrict__ ar, const T* __restrict__ ai,
                           const T* __restrict__ prer,
                           const T* __restrict__ prei,
                           const T* __restrict__ postr,
                           const T* __restrict__ posti,
                           const T* __restrict__ logr,
                           const T* __restrict__ logi,
                           const T* __restrict__ h, int NB, int W, int P,
                           T* __restrict__ outr, T* __restrict__ outi) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sh = reinterpret_cast<T*>(smem_raw);          // H, P*P
  T* stage = sh + P * P;                           // per warp: re[P], im[P]
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int i = threadIdx.x; i < P * P; i += blockDim.x) sh[i] = h[i];
  __syncthreads();

  const long long box = (long long)blockIdx.x * WARPS + warp;
  if (box >= NB) return;                           // no block barrier below
  const long long b = blockIdx.y;
  const long long row = b * NB + box;
  T* sar = stage + warp * 2 * P;
  T* sai = sar + P;

  T accr[MAX_PER_LANE], acci[MAX_PER_LANE];
#pragma unroll
  for (int t = 0; t < MAX_PER_LANE; ++t) accr[t] = acci[t] = T(0);

  for (int w = 0; w < W; ++w) {
    const long long slot = row * W + w;
    const int src = weak[slot];
    if (src < 0) continue;                         // warp-uniform
    const T pr = prer[slot], pi = prei[slot];
    const T qr = postr[slot], qi = posti[slot];
    const T* a_r = ar + (b * NB + src) * P;
    const T* a_i = ai + (b * NB + src) * P;
    // pre-scale: lane k holds a_k (rho_s/r)^k
    for (int k = lane; k < P; k += 32) {
      T wr = T(1), wi = T(0);
      for (int j = 0; j < k; ++j) {
        const T nr = wr * pr - wi * pi;
        wi = wr * pi + wi * pr;
        wr = nr;
      }
      const T xr = a_r[k], xi = a_i[k];
      sar[k] = xr * wr - xi * wi;
      sai[k] = xr * wi + xi * wr;
    }
    __syncwarp();
#pragma unroll
    for (int t = 0; t < MAX_PER_LANE; ++t) {
      const int l = lane + 32 * t;
      if (l < P) {
        const T* hl = sh + l * P;
        T bhr = T(0), bhi = T(0);
        for (int k = 0; k < P; ++k) {
          bhr += hl[k] * sar[k];
          bhi += hl[k] * sai[k];
        }
        T wr = T(1), wi = T(0);                    // (-rho_t/r)^l
        for (int j = 0; j < l; ++j) {
          const T nr = wr * qr - wi * qi;
          wi = wr * qi + wi * qr;
          wr = nr;
        }
        accr[t] += bhr * wr - bhi * wi;
        acci[t] += bhr * wi + bhi * wr;
        if (LOG && l == 0) {                       // b_0 += a_0 log r
          const T a0r = a_r[0], a0i = a_i[0];
          const T lr = logr[slot], li = logi[slot];
          accr[t] += a0r * lr - a0i * li;
          acci[t] += a0r * li + a0i * lr;
        }
      }
    }
    __syncwarp();
  }
#pragma unroll
  for (int t = 0; t < MAX_PER_LANE; ++t) {
    const int l = lane + 32 * t;
    if (l < P) {
      outr[row * P + l] = accr[t];
      outi[row * P + l] = acci[t];
    }
  }
}

// Dynamic shared memory of one block: H plus each warp's staged row.
static size_t smem_bytes(size_t elem, int P) {
  return elem * (size_t)(P * P + WARPS * 2 * P);
}

template <typename T>
static int launch(const void* weak, const void* ar, const void* ai,
                  const void* prer, const void* prei, const void* postr,
                  const void* posti, const void* logr, const void* logi,
                  const void* h, int B, int NB, int W, int P, int log_kernel,
                  void* outr, void* outi, void* stream) {
  if (P > 32 * MAX_PER_LANE) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((NB + WARPS - 1) / WARPS, B);
  const size_t smem = smem_bytes(sizeof(T), P);
  cudaStream_t s = (cudaStream_t)stream;
  if (log_kernel)
    m2l_kernel<T, true><<<grid, WARPS * 32, smem, s>>>(
        (const int32_t*)weak, (const T*)ar, (const T*)ai, (const T*)prer,
        (const T*)prei, (const T*)postr, (const T*)posti, (const T*)logr,
        (const T*)logi, (const T*)h, NB, W, P, (T*)outr, (T*)outi);
  else
    m2l_kernel<T, false><<<grid, WARPS * 32, smem, s>>>(
        (const int32_t*)weak, (const T*)ar, (const T*)ai, (const T*)prer,
        (const T*)prei, (const T*)postr, (const T*)posti, nullptr, nullptr,
        (const T*)h, NB, W, P, (T*)outr, (T*)outi);
  return launch_status();
}

#define M2L_ENTRY(NAME, T)                                                   \
  extern "C" int NAME(const void* weak, const void* ar, const void* ai,      \
                      const void* prer, const void* prei, const void* postr, \
                      const void* posti, const void* logr, const void* logi, \
                      const void* h, int B, int NB, int W, int P,            \
                      int log_kernel, void* outr, void* outi, void* stream) { \
    return launch<T>(weak, ar, ai, prer, prei, postr, posti, logr, logi, h,  \
                     B, NB, W, P, log_kernel, outr, outi, stream);           \
  }
M2L_ENTRY(m2l_f32, float)
M2L_ENTRY(m2l_f64, double)

// Dynamic shared memory per block (bytes) of a launch at these sizes.
extern "C" int repro_smem_bytes(int elem, int n, int P) {
  (void)n;
  return static_cast<int>(smem_bytes(elem, P));
}
