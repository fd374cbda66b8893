// The whole FMM evaluation phase in one launch: L2P, then P2P over the
// leaf strong (p2p) list, then M2P over the m2p list, into one phi value
// per target held in a register and written once.
//
// Replaces the Pallas kernel repro/kernels/eval/fused.py
// (_eval_fused_pallas, pallas_call at :205; wrapper
// eval/ops.py:eval_fused_apply). Per target particle z of leaf box b:
//
//   phi  = sum_j b~_j t^j,  t = (z - z0_b)/rho_b       (L2P Horner seed)
//   phi += sum_{s in p2p(b)} sum_{x in s, rank x != rank z} G(z, x)
//          harmonic G = q/(x - z),  log G = q log(z - x)
//   phi += sum_{s in m2p(b)} [ sum_{j>=1} a~_j w^j  (+ a~_0 log(z - z0_s)) ]
//          w = rho_s/(z - z0_s), gated on rho_s > 0 as in fused.py:108-114
//
// Self-interaction is excluded by global particle rank, never by
// position, so distinct coincident particles keep their mutual term.
//
// Bound on the H100: operations. Each P2P pair is ~12 flops plus one
// reciprocal (harmonic) or a log and an atan2 (log) against source data
// the block stages once per slot; each M2P target costs ~8p flops per
// slot. Device-memory traffic is the particle planes once per list
// entry, far below the flop time.
//
// Design: one block owns one target leaf, one thread per target slot
// (n_max = 64 at the paper's N_d). For each p2p slot the block stages the
// source box's x, y, q (re, im) and ranks in shared memory and every
// thread sums the pairwise terms of that slot, then adds the slot's sum
// to its phi. For each m2p slot the block stages the (p+1) complex
// multipole row; each thread runs the Horner in w. Masked slots (-1) are
// skipped. No atomics: results are bitwise reproducible.
#include "common.cuh"

template <typename T, bool LOG>
__global__ void eval_fused_kernel(
    const int32_t* __restrict__ p2p, int S, const int32_t* __restrict__ m2p,
    int Sm, const T* __restrict__ zr, const T* __restrict__ zi,
    const T* __restrict__ qr, const T* __restrict__ qi,
    const int32_t* __restrict__ rk, const T* __restrict__ tr,
    const T* __restrict__ ti, const T* __restrict__ br,
    const T* __restrict__ bi, const T* __restrict__ ar,
    const T* __restrict__ ai, const T* __restrict__ mcr,
    const T* __restrict__ mci, const T* __restrict__ mrho, int nb, int n,
    int P, T* __restrict__ outr, T* __restrict__ outi) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* s_x = reinterpret_cast<T*>(smem_raw);
  T* s_y = s_x + n;
  T* s_qr = s_y + n;
  T* s_qi = s_qr + n;
  T* s_cr = s_qi + n;                          // a coefficient row, P
  T* s_ci = s_cr + P;
  int32_t* s_rk = reinterpret_cast<int32_t*>(s_ci + P);

  const int t = threadIdx.x, nt = blockDim.x;
  const long long b = blockIdx.y;
  const int box = blockIdx.x;
  const long long row = b * nb + box;
  const bool act = t < n;
  const T tzr = act ? zr[row * n + t] : T(0);
  const T tzi = act ? zi[row * n + t] : T(0);
  const int trk = act ? rk[(long long)box * n + t] : -1;

  // L2P seed: Horner of the local block at the pre-centered position.
  for (int j = t; j < P; j += nt) {
    s_cr[j] = br[row * P + j];
    s_ci[j] = bi[row * P + j];
  }
  __syncthreads();
  T phr = s_cr[P - 1], phi_ = s_ci[P - 1];
  {
    const T xr = act ? tr[row * n + t] : T(0);
    const T xi = act ? ti[row * n + t] : T(0);
    for (int j = P - 2; j >= 0; --j) {
      const T nr = phr * xr - phi_ * xi + s_cr[j];
      phi_ = phr * xi + phi_ * xr + s_ci[j];
      phr = nr;
    }
  }

  // P2P over the strong (p2p) list.
  for (int s = 0; s < S; ++s) {
    const int src = p2p[row * S + s];
    if (src < 0) continue;                     // block-uniform
    __syncthreads();                           // previous stage consumed
    stage_source_leaf(zr, zi, qr, qi, rk, (b * nb + src) * n,
                      (long long)src * n, n, s_x, s_y, s_qr, s_qi, s_rk);
    __syncthreads();
    T sr, si;
    p2p_leaf_sum<T, LOG>(s_x, s_y, s_qr, s_qi, s_rk, n, tzr, tzi, trk, sr,
                         si);
    phr += sr;
    phi_ += si;
  }

  // M2P over the m2p list.
  for (int s = 0; s < Sm; ++s) {
    const int src = m2p[row * Sm + s];
    if (src < 0) continue;                     // block-uniform
    __syncthreads();
    const long long sr_ = b * nb + src;
    for (int j = t; j < P; j += nt) {
      s_cr[j] = ar[sr_ * P + j];
      s_ci[j] = ai[sr_ * P + j];
    }
    __syncthreads();
    const T cr = mcr[sr_], ci = mci[sr_], rh = mrho[sr_];
    const T dxr = tzr - cr, dxi = tzi - ci;    // z - z0_src
    const T d2 = dxr * dxr + dxi * dxi;
    const bool ok = rh > T(0);
    const T k = ok ? T(1) / d2 : T(0);
    const T wr = rh * dxr * k, wi = -rh * dxi * k;    // rho / (z - z0)
    T hr = s_cr[P - 1], hi = s_ci[P - 1];
    for (int j = P - 2; j >= 1; --j) {
      const T nr = hr * wr - hi * wi + s_cr[j];
      hi = hr * wi + hi * wr + s_ci[j];
      hr = nr;
    }
    T fr = hr * wr - hi * wi, fi = hr * wi + hi * wr;
    if (LOG) {                                 // + a_0 log(z - z0_src)
      const T lr = ok ? T(0.5) * log(d2) : T(0);
      const T li = ok ? atan2(dxi, dxr) : T(0);
      fr += s_cr[0] * lr - s_ci[0] * li;
      fi += s_cr[0] * li + s_ci[0] * lr;
    }
    if (ok) {
      phr += fr;
      phi_ += fi;
    }
  }
  if (act) {
    outr[row * n + t] = phr;
    outi[row * n + t] = phi_;
  }
}

// Dynamic shared memory of one block: a staged source box (x, y, q_r,
// q_i, rank) and one multipole row.
static size_t smem_bytes(size_t elem, int n, int P) {
  return elem * (size_t)(4 * n + 2 * P) + sizeof(int32_t) * (size_t)n;
}

template <typename T>
static int launch(const void* p2p, int S, const void* m2p, int Sm,
                  const void* zr, const void* zi, const void* qr,
                  const void* qi, const void* rk, const void* tr,
                  const void* ti, const void* br, const void* bi,
                  const void* ar, const void* ai, const void* mcr,
                  const void* mci, const void* mrho, int B, int nb, int n,
                  int P, int log_kernel, void* outr, void* outi,
                  void* stream) {
  const int nt = ((n + 31) / 32) * 32;
  const size_t smem = smem_bytes(sizeof(T), n, P);
  if (nt > 1024 || smem > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(nb, B);
  cudaStream_t s = (cudaStream_t)stream;
#define EVAL_ARGS                                                             \
  (const int32_t*)p2p, S, (const int32_t*)m2p, Sm, (const T*)zr,              \
      (const T*)zi, (const T*)qr, (const T*)qi, (const int32_t*)rk,           \
      (const T*)tr, (const T*)ti, (const T*)br, (const T*)bi, (const T*)ar,   \
      (const T*)ai, (const T*)mcr, (const T*)mci, (const T*)mrho, nb, n, P,   \
      (T*)outr, (T*)outi
  if (log_kernel)
    eval_fused_kernel<T, true><<<grid, nt, smem, s>>>(EVAL_ARGS);
  else
    eval_fused_kernel<T, false><<<grid, nt, smem, s>>>(EVAL_ARGS);
#undef EVAL_ARGS
  return launch_status();
}

#define EVAL_ENTRY(NAME, T)                                                   \
  extern "C" int NAME(const void* p2p, int S, const void* m2p, int Sm,        \
                      const void* zr, const void* zi, const void* qr,         \
                      const void* qi, const void* rk, const void* tr,         \
                      const void* ti, const void* br, const void* bi,         \
                      const void* ar, const void* ai, const void* mcr,        \
                      const void* mci, const void* mrho, int B, int nb,       \
                      int n, int P, int log_kernel, void* outr, void* outi,   \
                      void* stream) {                                         \
    return launch<T>(p2p, S, m2p, Sm, zr, zi, qr, qi, rk, tr, ti, br, bi, ar, \
                     ai, mcr, mci, mrho, B, nb, n, P, log_kernel, outr, outi, \
                     stream);                                                 \
  }
EVAL_ENTRY(eval_fused_f32, float)
EVAL_ENTRY(eval_fused_f64, double)

// Dynamic shared memory per block (bytes) of a launch at these sizes.
extern "C" int repro_smem_bytes(int elem, int n, int P) {
  return static_cast<int>(smem_bytes(elem, n, P));
}
