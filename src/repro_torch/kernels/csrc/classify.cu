// Theta classification and compaction of one level of the FMM topology.
//
// Replaces the Pallas kernel repro/kernels/topology/classify.py
// (_classify_pallas, pallas_call at :103; wrapper leaf_classify_pallas),
// and, on the card, the plain-torch theta tests of the levels above the
// leaf and every sort of the connectivity build. It is launched once a
// level, l = 1..L in order: each launch reads the parent level's
// compacted strong lists and writes level l's lists, compacted, so the
// next launch reads them.
//
// For every (problem, box, candidate) it applies the theta test
// R + theta*r <= theta*d (strong or weak) and, at the leaf, the
// Carrier-Greengard swapped test (p2p, p2l or m2p). It writes each
// class's list of the row, padded with -1 and clipped to its cap, and
// the row's count of each class before clipping (the cap margins).
//
// No sort: a box's candidates are the children 4p + k of its parent's
// strong entries p, in list order. The root's list is [0], and every
// list this kernel writes keeps candidate order, so by induction each
// parent list ascends with its entries before its -1 padding, and so do
// the candidates generated from it. A stable compaction of a row is then
// exactly the sorted row, and clipping it at the cap keeps the same
// entries the sort kept.
//
// Design: one warp per (problem, box) row. The warp walks the row's 4S
// candidate slots in chunks of 32, one candidate a lane, generated from
// the parent's list and never stored; per class a ballot and popc give
// each kept entry its slot after the running count, and only slots
// below the cap are written. A row may be any width. The walk ends at
// the first chunk with no candidate (the parent's entries precede its
// padding). The candidate geometry is a gather from the level's
// (B, 4^l) centres and radii, which stay in L2 (16384 leaves are 384 KB
// in f64).
//
// Bound on the H100: bytes. The lists are written once (each class's
// cap a row) and the parent lists read once; about 30 floating-point
// operations a candidate is far below the card's ratio of operations to
// bytes.
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

constexpr unsigned FULL = 0xffffffffu;
constexpr int NCLASS = 5;  // strong, weak, p2p, p2l, m2p

// Append the lanes whose `keep` holds to `out` after its `n` entries (in
// lane order), writing only below `cap`; `n` counts every kept entry.
__device__ __forceinline__ void append(bool keep, int32_t c, int32_t* out,
                                       int cap, int& n, int lane) {
  const unsigned m = __ballot_sync(FULL, keep);
  const int at = n + __popc(m & ((1u << lane) - 1u));
  if (keep && at < cap) out[at] = c;
  n += __popc(m);
}

// Fill slots [min(n, cap), cap) of `out` with -1.
__device__ __forceinline__ void pad(int32_t* out, int cap, int n, int lane) {
  for (int j = min(n, cap) + lane; j < cap; j += 32) out[j] = -1;
}

template <typename T>
__global__ void classify_kernel(const int32_t* __restrict__ parent,
                                const T* __restrict__ cxy,
                                const T* __restrict__ rad, int nb, int S,
                                int W, long long rows, T theta, int swapped,
                                int leaf, int32_t* __restrict__ strong,
                                int32_t* __restrict__ weak,
                                int32_t* __restrict__ p2p,
                                int32_t* __restrict__ p2l,
                                int32_t* __restrict__ m2p,
                                int32_t* __restrict__ counts) {
  const long long row =
      (blockIdx.x * (long long)blockDim.x + threadIdx.x) >> 5;
  if (row >= rows) return;  // whole warps: a row is one warp
  const int lane = threadIdx.x & 31;
  const long long b = row / nb;
  const int box = (int)(row - b * nb);
  const long long base = b * nb;  // level row of the problem's box 0
  const int32_t* ps = parent + (b * (nb >> 2) + (box >> 2)) * (long long)S;
  const T tbx = cxy[2 * row], tby = cxy[2 * row + 1], rb = rad[row];
  int32_t* os = strong + row * S;
  int32_t* ow = weak + row * W;
  int n[NCLASS] = {0, 0, 0, 0, 0};
  for (int i0 = 0; i0 < 4 * S; i0 += 32) {
    const int i = i0 + lane;
    int32_t c = -1;
    if (i < 4 * S) {
      const int32_t p = ps[i >> 2];
      if (p >= 0) c = 4 * p + (i & 3);
    }
    const bool valid = c >= 0;
    if (__ballot_sync(FULL, valid) == 0u) break;
    T ccx = T(0), ccy = T(0), rc = T(0);
    if (valid) {
      ccx = cxy[2 * (base + c)];
      ccy = cxy[2 * (base + c) + 1];
      rc = rad[base + c];
    }
    const T d = hypot_xla(Rn<T>::sub(tbx, ccx), Rn<T>::sub(tby, ccy));
    const T big = max_nan(rb, rc), small = min_nan(rb, rc);
    const T rhs = Rn<T>::mul(theta, d);
    const bool wellsep = Rn<T>::fma(theta, small, big) <= rhs;
    const bool is_strong = valid && !wellsep;
    append(is_strong, c, os, S, n[0], lane);
    append(valid && wellsep, c, ow, W, n[1], lane);
    if (leaf) {
      bool is_p2l = false, is_m2p = false;
      if (swapped) {
        const bool sw = Rn<T>::fma(theta, big, small) <= rhs;
        is_p2l = is_strong && sw && (rc > rb);  // source larger
        is_m2p = is_strong && sw && (rc < rb);  // source smaller
      }
      append(is_strong && !(is_p2l || is_m2p), c, p2p + row * S, S, n[2],
             lane);
      append(is_p2l, c, p2l + row * S, S, n[3], lane);
      append(is_m2p, c, m2p + row * S, S, n[4], lane);
    }
  }
  pad(os, S, n[0], lane);
  pad(ow, W, n[1], lane);
  if (leaf) {
    pad(p2p + row * S, S, n[2], lane);
    pad(p2l + row * S, S, n[3], lane);
    pad(m2p + row * S, S, n[4], lane);
  }
  if (lane == 0) {
    for (int k = 0; k < NCLASS; ++k) counts[row * NCLASS + k] = n[k];
  }
}

template <typename T>
static int launch(const void* parent, const void* cxy, const void* rad,
                  int B, int nb, int S, int W, double theta, int swapped,
                  int leaf, void* strong, void* weak, void* p2p, void* p2l,
                  void* m2p, void* counts, void* stream) {
  const long long rows = (long long)B * nb;
  const int threads = 256;  // 8 rows a block
  const long long blocks = (rows * 32 + threads - 1) / threads;
  classify_kernel<T><<<(unsigned)blocks, threads, 0,
                       (cudaStream_t)stream>>>(
      (const int32_t*)parent, (const T*)cxy, (const T*)rad, nb, S, W, rows,
      (T)theta, swapped, leaf, (int32_t*)strong, (int32_t*)weak,
      (int32_t*)p2p, (int32_t*)p2l, (int32_t*)m2p, (int32_t*)counts);
  return launch_status();
}

extern "C" int classify_level_f32(const void* parent, const void* cxy,
                                  const void* rad, int B, int nb, int S,
                                  int W, double theta, int swapped, int leaf,
                                  void* strong, void* weak, void* p2p,
                                  void* p2l, void* m2p, void* counts,
                                  void* stream) {
  return launch<float>(parent, cxy, rad, B, nb, S, W, theta, swapped, leaf,
                       strong, weak, p2p, p2l, m2p, counts, stream);
}

extern "C" int classify_level_f64(const void* parent, const void* cxy,
                                  const void* rad, int B, int nb, int S,
                                  int W, double theta, int swapped, int leaf,
                                  void* strong, void* weak, void* p2p,
                                  void* p2l, void* m2p, void* counts,
                                  void* stream) {
  return launch<double>(parent, cxy, rad, B, nb, S, W, theta, swapped, leaf,
                        strong, weak, p2p, p2l, m2p, counts, stream);
}

// Dynamic shared memory per block (bytes): none, the kernel reads its
// geometry straight from global memory.
extern "C" int repro_smem_bytes(int elem, int n, int P, int S) {
  (void)elem; (void)n; (void)P; (void)S;
  return 0;
}
