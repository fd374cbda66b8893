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
// read once; the Horner costs ~8p flops per slot. At the paper's N = 2^20
// that is ~23 MB (f32) in tiny pieces, so what a design must avoid is
// latency paid in series.
//
// Design: one warp owns L leaves (f32 2, f64 1; a block 4 warps), lane
// l the slot pair (2l, 2l + 1) of each chunk of 64 slots. A warp first
// issues the loads of its leaves' positions and ranks (one 8-byte load
// of a slot pair, 16-byte in f64, where n is even and the planes are
// aligned; positions and results as streaming accesses, touched once,
// the ranks, which every problem of a batch shares, as plain loads),
// then the coefficients, which it puts in its own piece of shared
// memory; one warp barrier, no block barrier. So a leaf costs one
// latency round and the warp's leaves overlap theirs. The Horner reads
// each coefficient with one broadcast shared-memory load, its steps
// written as the plain version's. Shuffling the coefficients from the
// lanes that loaded them ran slower: the compiler could not prove the
// shuffles convergent and wrapped each in a warp synchronisation. More
// leaves a warp (f32 4, f64 2) ran no faster in f32 and slower in f64:
// with all of a warp's loads issued up front, fewer and longer warps
// leave less of the card's load, Horner and store phases overlapping.
#include "common.cuh"

constexpr int L2P_WARPS = 4;     // warps a block

template <typename T> struct L2p;
template <> struct L2p<float> {
  using T2 = float2;
  static constexpr int L = 2;    // leaves a warp, loaded together
};
template <> struct L2p<double> {
  using T2 = double2;
  static constexpr int L = 1;
};

// Shared memory of one warp: its leaves' coefficients (re, im).
static __host__ __device__ int warp_elems(int L, int P) { return L * 2 * P; }

template <typename T, int VEC>
__global__ void __launch_bounds__(32 * L2P_WARPS) l2p_kernel(
    const T* __restrict__ br, const T* __restrict__ bi,
    const T* __restrict__ tr, const T* __restrict__ ti,
    const int32_t* __restrict__ rk, int rows, int nb, int n, int P,
    T* __restrict__ outr, T* __restrict__ outi) {
  using T2 = typename L2p<T>::T2;
  constexpr int L = L2p<T>::L;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  T* cw = reinterpret_cast<T*>(smem_raw) + warp * warp_elems(L, P);
  const int first = (blockIdx.x * L2P_WARPS + warp) * L;

  for (int s0 = 0; s0 < n; s0 += 64) {
    const int s = s0 + 2 * lane;               // this lane's slots s, s + 1
    const bool a0 = s < n, a1 = s + 1 < n;
    T xr0[L], xi0[L], xr1[L], xi1[L];
    int k0[L], k1[L];
#pragma unroll
    for (int l = 0; l < L; ++l) {
      const int row = first + l;
      xr0[l] = xi0[l] = xr1[l] = xi1[l] = T(0);
      k0[l] = k1[l] = -1;
      const long long at = (long long)row * n + s;
      const long long rat = (long long)(row % nb) * n + s;
      if (VEC && row < rows && a0) {           // n even: a1 too
        const T2 pr = __ldcs(reinterpret_cast<const T2*>(tr + at));
        const T2 pi = __ldcs(reinterpret_cast<const T2*>(ti + at));
        const int2 kk = *reinterpret_cast<const int2*>(rk + rat);
        xr0[l] = pr.x; xr1[l] = pr.y;
        xi0[l] = pi.x; xi1[l] = pi.y;
        k0[l] = kk.x; k1[l] = kk.y;
      } else if (!VEC && row < rows) {
        if (a0) { xr0[l] = tr[at]; xi0[l] = ti[at]; k0[l] = rk[rat]; }
        if (a1) { xr1[l] = tr[at + 1]; xi1[l] = ti[at + 1]; k1[l] = rk[rat + 1]; }
      }
    }
    if (s0 == 0) {                             // coefficients, once
      for (int e = lane; e < L * P; e += 32) {
        const int l = e / P, j = e - l * P, row = first + l;
        const bool ok = row < rows;
        cw[l * 2 * P + j] = ok ? br[(long long)row * P + j] : T(0);
        cw[l * 2 * P + P + j] = ok ? bi[(long long)row * P + j] : T(0);
      }
      __syncwarp();
    }
#pragma unroll
    for (int l = 0; l < L; ++l) {
      const T* cr = cw + l * 2 * P;
      const T* ci = cr + P;
      T p0r = cr[P - 1], p0i = ci[P - 1];
      T p1r = p0r, p1i = p0i;
      const T xa = xr0[l], ya = xi0[l], xb = xr1[l], yb = xi1[l];
#pragma unroll 4
      for (int j = P - 2; j >= 0; --j) {
        const T c_r = cr[j], c_i = ci[j];
        const T n0 = p0r * xa - p0i * ya + c_r;
        p0i = p0r * ya + p0i * xa + c_i;
        p0r = n0;
        const T n1 = p1r * xb - p1i * yb + c_r;
        p1i = p1r * yb + p1i * xb + c_i;
        p1r = n1;
      }
      const int row = first + l;
      if (row >= rows) continue;
      const long long at = (long long)row * n + s;
      if (k0[l] < 0) p0r = p0i = T(0);
      if (k1[l] < 0) p1r = p1i = T(0);
      if (VEC && a0) {
        __stcs(reinterpret_cast<T2*>(outr + at), T2{p0r, p1r});
        __stcs(reinterpret_cast<T2*>(outi + at), T2{p0i, p1i});
      } else if (!VEC) {
        if (a0) { outr[at] = p0r; outi[at] = p0i; }
        if (a1) { outr[at + 1] = p1r; outi[at + 1] = p1i; }
      }
    }
  }
}

// Dynamic shared memory of one block.
template <typename T>
static size_t smem_bytes(int P) {
  return sizeof(T) * (size_t)(L2P_WARPS * warp_elems(L2p<T>::L, P));
}

static bool aligned(const void* p, size_t a) {
  return reinterpret_cast<uintptr_t>(p) % a == 0;
}

template <typename T>
static int launch(const void* br, const void* bi, const void* tr,
                  const void* ti, const void* rk, int B, int nb, int n, int P,
                  void* outr, void* outi, void* stream) {
  const long long rows = (long long)B * nb;
  if (rows <= 0 || rows > (1LL << 30) || n <= 0 || P <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int per = L2P_WARPS * L2p<T>::L;
  const dim3 grid((unsigned)((rows + per - 1) / per));
  const size_t smem = smem_bytes<T>(P);
  const size_t v = 2 * sizeof(T);
  const bool vec = n % 2 == 0 && aligned(tr, v) && aligned(ti, v) &&
                   aligned(outr, v) && aligned(outi, v) && aligned(rk, 8);
  const auto kernel = vec ? l2p_kernel<T, 1> : l2p_kernel<T, 0>;
  if (const int rc = allow_smem(kernel, smem)) return rc;
  kernel<<<grid, 32 * L2P_WARPS, smem, (cudaStream_t)stream>>>(
      (const T*)br, (const T*)bi, (const T*)tr, (const T*)ti,
      (const int32_t*)rk, (int)rows, nb, n, P, (T*)outr, (T*)outi);
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
  return static_cast<int>(elem == 8 ? smem_bytes<double>(P)
                                    : smem_bytes<float>(P));
}
