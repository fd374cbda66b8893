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
// Bound on the H100: operations. Each (pair, particle) costs the
// reciprocal and ~(p+1) complex multiply-adds (about 8 (p+1) flops)
// against 32 bytes of particle data, far above the bytes line.
//
// Design: one block owns one target leaf and loops over its p2l slots;
// threads run over the source box's particles, each with its own power
// recurrence over the p+1 terms, writing its terms into a (p+1) x threads
// shared array. A fixed-order shared-memory tree reduction sums each
// coefficient, and thread l accumulates coefficient l in a register
// across slots; the block stores its p+1 outputs once. No atomics:
// results are bitwise reproducible.
#include "common.cuh"

template <typename T, bool LOG>
__global__ void p2l_kernel(const int32_t* __restrict__ lists,
                           const T* __restrict__ z0r,
                           const T* __restrict__ z0i,
                           const T* __restrict__ rho,
                           const T* __restrict__ xr, const T* __restrict__ xi,
                           const T* __restrict__ qr, const T* __restrict__ qi,
                           int nb, int S, int n, int P,
                           T* __restrict__ outr, T* __restrict__ outi) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int nt = blockDim.x, tid = threadIdx.x;
  T* red_r = reinterpret_cast<T*>(smem_raw);   // [P][nt]
  T* red_i = red_r + P * nt;
  const long long b = blockIdx.y;
  const long long row = b * nb + blockIdx.x;
  const T cr = z0r[row], ci = z0i[row], rh = rho[row];
  T accr = T(0), acci = T(0);                  // coefficient `tid` (< P)

  for (int s = 0; s < S; ++s) {
    const int src = lists[row * S + s];
    if (src < 0) continue;                     // block-uniform
    for (int l = 0; l < P; ++l) red_r[l * nt + tid] = red_i[l * nt + tid] = T(0);
    const long long base = (b * nb + src) * n;
    for (int j = tid; j < n; j += nt) {
      const T px = xr[base + j], py = xi[base + j];
      const T cq = qr[base + j], sq = qi[base + j];
      const T dxr = px - cr, dxi = py - ci;    // x - z0
      const T d2 = dxr * dxr + dxi * dxi;
      const bool ok = d2 > T(0);
      const T k = ok ? T(1) / d2 : T(0);
      const T invr = dxr * k, invi = -dxi * k; // 1 / (x - z0)
      const T wr = rh * invr, wi = rh * invi;  // rho / (x - z0)
      T pwr, pwi;
      int l0;
      if (LOG) {
        // b~_0 term: q log(z0 - x) = q (log|d|, arg(-d))
        const T lr = ok ? T(0.5) * log(d2) : T(0);
        const T li = ok ? atan2(-dxi, -dxr) : T(0);
        red_r[tid] += cq * lr - sq * li;
        red_i[tid] += cq * li + sq * lr;
        pwr = cq * wr - sq * wi;
        pwi = cq * wi + sq * wr;
        l0 = 1;
      } else {
        pwr = cq * invr - sq * invi;
        pwi = cq * invi + sq * invr;
        l0 = 0;
      }
      for (int l = l0; l < P; ++l) {
        red_r[l * nt + tid] += pwr;
        red_i[l * nt + tid] += pwi;
        const T nr = pwr * wr - pwi * wi;
        pwi = pwr * wi + pwi * wr;
        pwr = nr;
      }
    }
    __syncthreads();
    for (int st = nt / 2; st > 0; st >>= 1) {  // fixed-order tree
      if (tid < st)
        for (int l = 0; l < P; ++l) {
          red_r[l * nt + tid] += red_r[l * nt + tid + st];
          red_i[l * nt + tid] += red_i[l * nt + tid + st];
        }
      __syncthreads();
    }
    if (tid < P) {
      T sr = red_r[tid * nt], si = red_i[tid * nt];
      if (LOG && tid > 0) {                    // b~_l = -(sum q w^l) / l
        sr = -sr / T(tid);
        si = -si / T(tid);
      }
      accr += sr;
      acci += si;
    }
    __syncthreads();                           // red is rewritten next slot
  }
  if (tid < P) {
    outr[row * P + tid] = accr;
    outi[row * P + tid] = acci;
  }
}

// Threads per block: a power of two covering the particles and the
// coefficients.
static int block_threads(int n, int P) {
  int nt = 32;
  while (nt < n && nt < 128) nt *= 2;
  while (nt < P) nt *= 2;
  return nt;
}

// Dynamic shared memory of one block: the (p+1) x threads reduction
// planes, real and imaginary.
static size_t smem_bytes(size_t elem, int n, int P) {
  return elem * (size_t)(2 * P * block_threads(n, P));
}

template <typename T>
static int launch(const void* lists, const void* z0r, const void* z0i,
                  const void* rho, const void* xr, const void* xi,
                  const void* qr, const void* qi, int B, int nb, int S, int n,
                  int P, int log_kernel, void* outr, void* outi,
                  void* stream) {
  const int nt = block_threads(n, P);
  const size_t smem = smem_bytes(sizeof(T), n, P);
  if (nt > 1024 || smem > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(nb, B);
  cudaStream_t s = (cudaStream_t)stream;
  if (log_kernel)
    p2l_kernel<T, true><<<grid, nt, smem, s>>>(
        (const int32_t*)lists, (const T*)z0r, (const T*)z0i, (const T*)rho,
        (const T*)xr, (const T*)xi, (const T*)qr, (const T*)qi, nb, S, n, P,
        (T*)outr, (T*)outi);
  else
    p2l_kernel<T, false><<<grid, nt, smem, s>>>(
        (const int32_t*)lists, (const T*)z0r, (const T*)z0i, (const T*)rho,
        (const T*)xr, (const T*)xi, (const T*)qr, (const T*)qi, nb, S, n, P,
        (T*)outr, (T*)outi);
  return launch_status();
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

// Dynamic shared memory per block (bytes) of a launch at these sizes.
extern "C" int repro_smem_bytes(int elem, int n, int P, int S) {
  (void)S;
  return static_cast<int>(smem_bytes(elem, n, P));
}
