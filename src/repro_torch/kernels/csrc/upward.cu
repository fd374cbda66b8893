// The upward pass of the FMM (P2M at the leaves, M2M up every level to
// the root), radius-normalized, for both G-kernels, in at most two
// launches.
//
// Replaces no Pallas kernel: the reference's upward pass is plain jnp
// (repro/core/fmm.py: p2m, m2m_level, upward), and its plain torch twin
// (core/fmm.py: upward) stays the CPU's and the "reference" backend's
// path. Run as plain torch on the card it costs ~2,800 small elementwise
// kernels a pass (17 power passes over the leaf planes, and a level's
// ratio powers, 136-step Pascal pass and log-source corrections, each a
// kernel of 4^l x 18 elements), ~3.9 ms at N = 2^20 against a bound of
// ~0.012 ms. For every leaf, with w = (x - z0)/rho:
//
//   harmonic  a~_0 = 0,      a~_j = -sum q/rho w^(j-1)       (j >= 1)
//   log       a~_0 = sum q,  a~_j = -(1/j) sum q w^j          (j >= 1)
//
// and for every child box with u = (c_child - c_parent)/rho_parent and
// ratio = rho_child/rho_parent, core/expansions.py:m2m_norm (ratio
// powers, the Pascal pass with multiplier u, the log-source correction),
// the four children of a parent summed in child order.
//
// Bound on the H100: bytes. The pass reads z and q once (2^20 x 32 B in
// f64: 33.5 MB, 10 us at 3.35 TB/s), the leaf bounds of the static
// layout, the centers and radii of every box, and writes 21,845 boxes x
// 18 complex coefficients (6.3 MB); its operations (2^20 x 17 complex
// products for P2M, ~21,845 x 150 for M2M) take under 5 us at the
// vector rate. A lone block doing the M2M of the top levels is bound by
// its SM's f64 pipe instead, so the leaf stage takes all but the top
// four levels.
//
// Design: every box's multipoles go to one (B, sum 4^l, P) complex output
// whose levels lie root first (level l from (4^l - 1)/3); a level is read
// back from it, after a barrier, by the level above. There are no atomics
// and every sum has a fixed order, so two launches are bitwise equal.
// 1. Launch 1 (the leaf stage): a block owns one box of level L - D and
//    its 4^D leaves (D = L up to L = 2, else the larger of 2 and L - 4:
//    2 at the cells' seven levels but 3, so 256 blocks of 64 leaves). A
//    group of G = 8 lanes takes a leaf: its particles are the ranks
//    [bounds[b], bounds[b+1]) (no padding to skip), lane r of the group
//    reads particles r, r + G, ... of z and q, keeps the running power of
//    each in registers and adds its terms to per-lane sums of the P
//    coefficients; each coefficient is then a 3-step xor-shuffle
//    butterfly inside the group (four leaves a warp share each shuffle).
//    After a barrier one thread a child box shifts the leaves into their
//    parents, and so on for D levels: m2m_norm's steps in registers, then
//    the four children of a parent, four neighbouring lanes, summed in
//    child order through shuffles. Divisions are reciprocals taken once
//    (a leaf's 1/rho, a parent's 1/rho, 1/j), so the f64 pipe does
//    multiply-adds.
// 2. Launch 2 (the top stage, only where L - D >= 1): one block a problem
//    shifts the remaining levels, from the at most 256 boxes of level
//    L - D up to the root, level by level with a barrier between levels.
// p = 17 (P = 18) keeps every sum and the Pascal pass in registers; other
// P run the same code over local arrays. B is the leading grid axis; for
// K densities on one geometry (upward_block_kernel) it is the density,
// over the one copy of the positions, leaf bounds, centres and radii
// (problem stride 0), and each density's multipoles are the K = 1
// kernel's, bit for bit.
// Measured at the uniform 2^20 plan (f64, launch 1 + launch 2): this
// design 0.031 + 0.017 ms. A first one (a warp a leaf, D = 2 at seven
// levels, divisions, 160 registers, so one block an SM) took 0.205 +
// 0.070 ms; capping it at 128 registers alone, 0.121 + 0.073; G = 4 or
// 16 lanes a leaf, 128 or 512 threads a block, 0.031-0.046 + 0.017.
#include "common.cuh"

constexpr int THREADS = 256;
constexpr int G = 8;           // lanes a leaf in the P2M
constexpr int PFIX = 18;       // P = p + 1 at the paper's p = 17
constexpr int PMAX = 64;

template <typename T> struct alignas(2 * sizeof(T)) Cx { T r, i; };

// First box of level l on the flat all-levels axis.
__host__ __device__ inline long long level_offset(int l) {
  return ((1LL << (2 * l)) - 1) / 3;
}

// Levels below the box a leaf-stage block owns: the top stage starts from
// at most 4^4 boxes.
static int block_depth(int L) {
  return L <= 2 ? L : (L - 4 > 2 ? L - 4 : 2);
}

// The sum over the G lanes of a group, the same bits in each of them.
template <typename T>
__device__ __forceinline__ T group_sum(T v) {
#pragma unroll
  for (int m = G / 2; m > 0; m >>= 1) v += __shfl_xor_sync(0xffffffffu, v, m);
  return v;
}

// P2M of one leaf (ranks [r0, r1), center c0, effective radius rh) by
// one group of G lanes, r the lane's place in it; dst the leaf's P
// coefficients. A group with no leaf (act false) takes part in the
// shuffles only.
template <typename T, bool LOG, int PF>
__device__ __forceinline__ void p2m_leaf(const Cx<T>* __restrict__ z,
                                         const Cx<T>* __restrict__ q,
                                         int r0, int r1, Cx<T> c0, T rh,
                                         int P_, int r, bool act,
                                         Cx<T>* dst) {
  constexpr int PN = PF > 0 ? PF : PMAX;
  const int P = PF > 0 ? PF : P_;
  T ar[PN], ai[PN];
#pragma unroll
  for (int j = 0; j < P; ++j) ar[j] = ai[j] = T(0);
  const T irh = T(1) / rh;
#pragma unroll 4
  for (int i = r0 + r; i < (act ? r1 : r0); i += G) {
    const Cx<T> x = z[i], s = q[i];
    const T wr = (x.r - c0.r) * irh, wi = (x.i - c0.i) * irh;
    T pr = LOG ? s.r : s.r * irh, pi = LOG ? s.i : s.i * irh;
    if (LOG) {
      ar[0] += pr;
      ai[0] += pi;
    }
#pragma unroll
    for (int j = 1; j < P; ++j) {
      if (LOG) {                               // q w^j
        const T nr = pr * wr - pi * wi;
        pi = pr * wi + pi * wr;
        pr = nr;
      }
      ar[j] += pr;
      ai[j] += pi;
      if (!LOG) {                              // q/rho w^j, for j + 1
        const T nr = pr * wr - pi * wi;
        pi = pr * wi + pi * wr;
        pr = nr;
      }
    }
  }
#pragma unroll
  for (int j = 0; j < P; ++j) {
    const T sr = group_sum(ar[j]), si = group_sum(ai[j]);
    if (act && j % G == r) {
      if (j == 0)
        dst[0] = LOG ? Cx<T>{sr, si} : Cx<T>{T(0), T(0)};
      else if (LOG)
        dst[j] = Cx<T>{-sr * (T(1) / T(j)), -si * (T(1) / T(j))};
      else
        dst[j] = Cx<T>{-sr, -si};
    }
  }
}

// M2M of the children [c_lo, c_hi) of level lc (a run of whole sibling
// quartets) into their parents at level lc - 1, on one problem's flat
// rows: one thread a child, chunks of the block.
template <typename T, int PF>
__device__ __forceinline__ void m2m_step(Cx<T>* out,
                                         const Cx<T>* __restrict__ cen,
                                         const T* __restrict__ rho, int lc,
                                         int c_lo, int c_hi, int P_) {
  constexpr int PN = PF > 0 ? PF : PMAX;
  const int P = PF > 0 ? PF : P_;
  const long long oc = level_offset(lc), op = level_offset(lc - 1);
  const int tid = threadIdx.x, lane = tid & 31;
  for (int c0 = c_lo; c0 + (tid & ~31) < c_hi; c0 += THREADS) {
    // (warp-uniform: every lane of a warp that enters takes the shuffles)
    const int c = c0 + tid;
    const bool act = c < c_hi;
    Cx<T> a[PN];
    if (act) {
      const Cx<T> zc = cen[oc + c], zp = cen[op + (c >> 2)];
      const T irp = T(1) / rho[op + (c >> 2)];
      const T ur = (zc.r - zp.r) * irp, ui = (zc.i - zp.i) * irp;
      const T ratio = rho[oc + c] * irp;
      const Cx<T>* src = out + (oc + c) * P;
      a[0] = src[0];
      T w = T(1);
#pragma unroll
      for (int j = 1; j < P; ++j) {            // a_j ratio^j
        w *= ratio;
        const Cx<T> v = src[j];
        a[j] = Cx<T>{v.r * w, v.i * w};
      }
#pragma unroll
      for (int k = P - 1; k > 1; --k) {        // Pascal pass, multiplier u
#pragma unroll
        for (int j = k; j < P; ++j) {
          const Cx<T> b = a[j - 1];
          a[j].r += ur * b.r - ui * b.i;
          a[j].i += ur * b.i + ui * b.r;
        }
      }
      T pr = T(1), pi = T(0);
#pragma unroll
      for (int j = 1; j < P; ++j) {            // log-source correction
        const T nr = pr * ur - pi * ui;
        pi = pr * ui + pi * ur;
        pr = nr;
        const T inv = T(1) / T(j);
        a[j].r -= (a[0].r * pr - a[0].i * pi) * inv;
        a[j].i -= (a[0].r * pi + a[0].i * pr) * inv;
      }
    } else {
#pragma unroll
      for (int j = 0; j < P; ++j) a[j] = Cx<T>{T(0), T(0)};
    }
    // lane 4k sums its quartet in child order
    Cx<T>* dst = out + (op + (c >> 2)) * P;
    const bool head = act && (lane & 3) == 0;
#pragma unroll
    for (int j = 0; j < P; ++j) {
      const T r1 = __shfl_down_sync(0xffffffffu, a[j].r, 1);
      const T i1 = __shfl_down_sync(0xffffffffu, a[j].i, 1);
      const T r2 = __shfl_down_sync(0xffffffffu, a[j].r, 2);
      const T i2 = __shfl_down_sync(0xffffffffu, a[j].i, 2);
      const T r3 = __shfl_down_sync(0xffffffffu, a[j].r, 3);
      const T i3 = __shfl_down_sync(0xffffffffu, a[j].i, 3);
      if (head)
        dst[j] = Cx<T>{((a[j].r + r1) + r2) + r3, ((a[j].i + i1) + i2) + i3};
    }
  }
}

// The kernel's body on one problem's rows: positions, centres and radii
// of geometry b, charges and multipoles of c (c = b in upward_kernel; the
// one geometry b = 0 and density c in upward_block_kernel).
template <typename T, bool LOG, int PF, bool TOP>
__device__ __forceinline__ void upward_body(
    const Cx<T>* __restrict__ z, const Cx<T>* __restrict__ q,
    const int32_t* __restrict__ bounds, const Cx<T>* __restrict__ cen,
    const T* __restrict__ rho, int N, int L, int D, int P_, Cx<T>* out,
    const long long b, const long long c) {
  const int P = PF > 0 ? PF : P_;
  const long long NB = level_offset(L + 1);
  cen += b * NB;
  rho += b * NB;
  out += c * NB * P;
  if constexpr (!TOP) {
    z += b * N;
    q += c * N;
    const int box = blockIdx.x, nleaf = 1 << (2 * D);
    const int grp = threadIdx.x / G, r = threadIdx.x % G;
    const long long oL = level_offset(L);
    // warp-uniform: the four groups of a warp take four neighbouring
    // leaves (the root alone at L = 0 leaves three groups idle)
    for (int k0 = (grp & ~3); k0 < nleaf; k0 += THREADS / G) {
      const int k = k0 + (grp & 3);
      const bool act = k < nleaf;
      const int leaf = box * nleaf + (act ? k : 0);
      p2m_leaf<T, LOG, PF>(z, q, bounds[leaf], bounds[leaf + 1],
                           cen[oL + leaf], rho[oL + leaf], P, r, act,
                           out + (oL + leaf) * P);
    }
    for (int lc = L; lc > L - D; --lc) {
      __syncthreads();                         // level lc written
      const int per = 1 << (2 * (lc - (L - D)));
      m2m_step<T, PF>(out, cen, rho, lc, box * per, (box + 1) * per, P);
    }
  } else {
    (void)z;
    (void)q;
    (void)bounds;
    (void)N;
    for (int lc = L - D; lc >= 1; --lc) {
      m2m_step<T, PF>(out, cen, rho, lc, 0, 1 << (2 * lc), P);
      __syncthreads();                         // level lc - 1 written
    }
  }
}

template <typename T, bool LOG, int PF, bool TOP>
__global__ void __launch_bounds__(THREADS, 2) upward_kernel(
    const Cx<T>* __restrict__ z, const Cx<T>* __restrict__ q,
    const int32_t* __restrict__ bounds, const Cx<T>* __restrict__ cen,
    const T* __restrict__ rho, int N, int L, int D, int P_, Cx<T>* out) {
  upward_body<T, LOG, PF, TOP>(z, q, bounds, cen, rho, N, L, D, P_, out,
                               blockIdx.y, blockIdx.y);
}

// K densities on one geometry: density blockIdx.y of the (K, N) charges
// and the (K, sum 4^l, P) multipoles over the single positions, leaf
// bounds, centres and radii (problem stride 0).
template <typename T, bool LOG, int PF, bool TOP>
__global__ void __launch_bounds__(THREADS, 2) upward_block_kernel(
    const Cx<T>* __restrict__ z, const Cx<T>* __restrict__ q,
    const int32_t* __restrict__ bounds, const Cx<T>* __restrict__ cen,
    const T* __restrict__ rho, int N, int L, int D, int P_, Cx<T>* out) {
  upward_body<T, LOG, PF, TOP>(z, q, bounds, cen, rho, N, L, D, P_, out, 0,
                               blockIdx.y);
}

template <typename T, bool LOG, int PF, bool TOP>
static int launch_one(dim3 grid, cudaStream_t s, const void* z,
                      const void* q, const void* bounds, const void* cen,
                      const void* rho, int N, int L, int D, int P,
                      void* out, bool dens) {
  auto kernel = dens ? upward_block_kernel<T, LOG, PF, TOP>
                     : upward_kernel<T, LOG, PF, TOP>;
  kernel<<<grid, THREADS, 0, s>>>(
      (const Cx<T>*)z, (const Cx<T>*)q, (const int32_t*)bounds,
      (const Cx<T>*)cen, (const T*)rho, N, L, D, P, (Cx<T>*)out);
  return launch_status();
}

// B problems (dens false), or B densities on one geometry (dens true).
template <typename T>
static int launch(const void* z, const void* q, const void* bounds,
                  const void* cen, const void* rho, int B, int N, int L,
                  int P, int log_kernel, int stage, void* out,
                  void* stream, bool dens = false) {
  if (B < 1 || N < 1 || L < 0 || L > 14 || P < 1 || P > PMAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const int D = block_depth(L);
  if (stage != 0 && (stage != 1 || L - D < 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(stage ? 1 : 1u << (2 * (L - D)), B);
  cudaStream_t s = (cudaStream_t)stream;
#define UP_ARGS grid, s, z, q, bounds, cen, rho, N, L, D, P, out, dens
  if (stage) return P == PFIX ? launch_one<T, false, PFIX, true>(UP_ARGS)
                              : launch_one<T, false, 0, true>(UP_ARGS);
  if (P == PFIX)
    return log_kernel ? launch_one<T, true, PFIX, false>(UP_ARGS)
                      : launch_one<T, false, PFIX, false>(UP_ARGS);
  return log_kernel ? launch_one<T, true, 0, false>(UP_ARGS)
                    : launch_one<T, false, 0, false>(UP_ARGS);
#undef UP_ARGS
}

#define UP_ENTRY(NAME, T)                                                   \
  extern "C" int NAME(const void* z, const void* q, const void* bounds,     \
                      const void* cen, const void* rho, int B, int N, int L, \
                      int P, int log_kernel, int stage, void* out,          \
                      void* stream) {                                       \
    return launch<T>(z, q, bounds, cen, rho, B, N, L, P, log_kernel, stage, \
                     out, stream);                                          \
  }
UP_ENTRY(upward_f32, float)
UP_ENTRY(upward_f64, double)

#define UP_BLOCK_ENTRY(NAME, T)                                             \
  extern "C" int NAME(const void* z, const void* q, const void* bounds,     \
                      const void* cen, const void* rho, int K, int N, int L, \
                      int P, int log_kernel, int stage, void* out,          \
                      void* stream) {                                       \
    return launch<T>(z, q, bounds, cen, rho, K, N, L, P, log_kernel, stage, \
                     out, stream, true);                                    \
  }
UP_BLOCK_ENTRY(upward_block_f32, float)
UP_BLOCK_ENTRY(upward_block_f64, double)

// Dynamic shared memory per block (bytes): none.
extern "C" int repro_smem_bytes(int elem, int n, int P, int S) {
  (void)elem;
  (void)n;
  (void)P;
  (void)S;
  return 0;
}
