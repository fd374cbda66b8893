// Local-expansion evaluation (L2P) at the leaf particles (the per-phase
// FMM path's L2P): for every particle slot of leaf box b,
//
//   phi = sum_{j=0..p} b~_j t^j,  t = (z - z0_b)/rho_b   (Horner)
//
// at the pre-centered, radius-normalized position t; padded slots
// (rank -1) are written as 0.
//
// Replaces the Pallas kernel repro/kernels/l2p/l2p.py (_l2p_pallas,
// pallas_call at :46; wrapper l2p/ops.py:l2p_apply, which zeroes the
// padded slots through its `valid` mask).
//
// Bound on the H100: bytes. Each slot reads its position (2 reals) and
// rank and writes 2 reals; the box's P = p + 1 complex coefficients are
// read once per block; the Horner costs ~8p flops per slot.
//
// Design: one block owns one leaf, one thread per particle slot. The
// block stages the box's P coefficients in shared memory; each thread
// runs the Horner recurrence in registers and writes its value once.
#include "common.cuh"

template <typename T>
__global__ void l2p_kernel(const T* __restrict__ br, const T* __restrict__ bi,
                           const T* __restrict__ tr, const T* __restrict__ ti,
                           const int32_t* __restrict__ rk, int nb, int n,
                           int P, T* __restrict__ outr,
                           T* __restrict__ outi) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* s_cr = reinterpret_cast<T*>(smem_raw);
  T* s_ci = s_cr + P;

  const int t = threadIdx.x, nt = blockDim.x;
  const long long b = blockIdx.y;
  const int box = blockIdx.x;
  const long long row = b * nb + box;
  for (int j = t; j < P; j += nt) {
    s_cr[j] = br[row * P + j];
    s_ci[j] = bi[row * P + j];
  }
  __syncthreads();
  if (t >= n) return;
  const T xr = tr[row * n + t], xi = ti[row * n + t];
  T phr = s_cr[P - 1], phi_ = s_ci[P - 1];
  for (int j = P - 2; j >= 0; --j) {
    const T nr = phr * xr - phi_ * xi + s_cr[j];
    phi_ = phr * xi + phi_ * xr + s_ci[j];
    phr = nr;
  }
  const bool valid = rk[(long long)box * n + t] >= 0;
  outr[row * n + t] = valid ? phr : T(0);
  outi[row * n + t] = valid ? phi_ : T(0);
}

// Dynamic shared memory of one block: one coefficient row (re, im).
static size_t smem_bytes(size_t elem, int P) {
  return elem * (size_t)(2 * P);
}

template <typename T>
static int launch(const void* br, const void* bi, const void* tr,
                  const void* ti, const void* rk, int B, int nb, int n, int P,
                  void* outr, void* outi, void* stream) {
  const int nt = ((n + 31) / 32) * 32;
  const size_t smem = smem_bytes(sizeof(T), P);
  if (nt > 1024 || smem > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(nb, B);
  l2p_kernel<T><<<grid, nt, smem, (cudaStream_t)stream>>>(
      (const T*)br, (const T*)bi, (const T*)tr, (const T*)ti,
      (const int32_t*)rk, nb, n, P, (T*)outr, (T*)outi);
  return launch_status();
}

#define L2P_ENTRY(NAME, T)                                                    \
  extern "C" int NAME(const void* br, const void* bi, const void* tr,         \
                      const void* ti, const void* rk, int B, int nb, int n,   \
                      int P, void* outr, void* outi, void* stream) {          \
    return launch<T>(br, bi, tr, ti, rk, B, nb, n, P, outr, outi, stream);    \
  }
L2P_ENTRY(l2p_f32, float)
L2P_ENTRY(l2p_f64, double)

// Dynamic shared memory per block (bytes) of a launch at these sizes.
extern "C" int repro_smem_bytes(int elem, int n, int P, int S) {
  (void)S;
  (void)n;
  return static_cast<int>(smem_bytes(elem, P));
}
