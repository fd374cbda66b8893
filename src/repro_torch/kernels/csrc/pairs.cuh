// The near-field pair loop shared by the fused evaluation (eval_fused.cu)
// and the per-phase P2P kernel (p2p.cu), with the warp helpers that the
// P2L kernel (p2l.cu) uses too.
//
// One warp owns one target leaf and every lane two of its targets, t and
// t + 32. The warp compacts its list row once (`compact`), then
// `near_sum` streams the listed source leaves through a two-stage
// cp.async ring of packed (x, y, q_r, q_i) records and adds each leaf's
// pairwise terms to the lane's two sums:
//
//   phi(z) += sum_{s in list} sum_{x in s, rank x != rank z} G(z, x)
//             harmonic G = q/(x - z),  log G = q log(z - x)
//
// Self-interaction is excluded by global particle rank, never by
// position, so distinct coincident particles keep their (non-finite)
// mutual term. The static leaf layout pads at the tail
// (kernels/common.py:dense_rank_planes), so each staged leaf's valid
// count (one ballot over its staged ranks) bounds the loop and padded
// source slots are never read; the rank test runs only in the slot whose
// source is the target's own leaf, where it reduces to slot != target
// slot. The design notes and the card times are in eval_fused.cu. The
// log kernel's f64 pair takes its complex logarithm from clog.cuh (its
// tables staged by the kernel, clog_stage), the f32 pair the library's
// logf and atan2f.
#pragma once
#include "clog.cuh"
#include "common.cuh"

constexpr int NSTAGE = 2;      // source leaves in flight per warp
constexpr int NFIX = 64;       // n_max at the paper's N_d
constexpr int GROUP = 64;      // targets per pass of a warp: two per lane

template <typename T> struct alignas(16) Rec { T x, y, qr, qi; };

// Asynchronous 4- or 8-byte copies from global to shared memory
// (cp.async, sm_80 and later), committed and awaited in groups.
template <typename T>
__device__ __forceinline__ void cp_async(T* dst, const T* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (sizeof(T) == 4)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
                 :: "r"(d), "l"(src) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n"
                 :: "r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// 1/d: the hardware estimate refined by Newton. d = 0 gives NaN (as 0/0
// does in the IEEE form q * (1/0) * 0), never a finite value.
__device__ __forceinline__ float fast_rcp(float d) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(d));
  return fmaf(r, fmaf(-d, r, 1.0f), r);
}

__device__ __forceinline__ double fast_rcp(double d) {
  double r;
  asm("rcp.approx.ftz.f64 %0, %1;" : "=d"(r) : "d"(d));
  const double e = fma(-d, r, 1.0);
  return fma(r, fma(e, e, e), r);      // r (1 + e + e^2): error ~e^3
}

// Compact one list row's occupied slots (>= 0) into `out` in list
// order; returns their count. All 32 lanes take part.
__device__ __forceinline__ int compact(const int32_t* __restrict__ row,
                                       int S, int32_t* out, int lane) {
  int cnt = 0;
  for (int s0 = 0; s0 < S; s0 += 32) {
    const int v = s0 + lane < S ? row[s0 + lane] : -1;
    const unsigned m = __ballot_sync(0xffffffffu, v >= 0);
    if (v >= 0) out[cnt + __popc(m & ((1u << lane) - 1u))] = v;
    cnt += __popc(m);
  }
  return cnt;
}

// One pair's term G(z, x) added to (sr, si); `self` drops it (the
// target's own slot, only tested where SELF).
template <typename T, bool LOG, bool SELF>
__device__ __forceinline__ void pair_term(const Rec<T>& s, bool self, T zr,
                                          T zi, T& sr, T& si) {
  const T dx = s.x - zr, dy = s.y - zi;          // z_src - z_tgt
  const T d2 = dx * dx + dy * dy;
  if constexpr (LOG) {
    T lr, li;
    if constexpr (sizeof(T) == 8) {
      const CLog l = clog_pair(dx, dy, d2);
      lr = l.re;
      li = l.im;
    } else {
      lr = T(0.5) * log(d2);
      li = atan2(-dy, -dx);
    }
    if (SELF && self) {
      lr = T(0);
      li = T(0);
    }
    sr += s.qr * lr - s.qi * li;
    si += s.qr * li + s.qi * lr;
  } else {
    T inv = fast_rcp(d2);                         // q/(dx + i dy)
    if (SELF && self) inv = T(0);
    sr += (s.qr * dx + s.qi * dy) * inv;
    si += (s.qi * dx - s.qr * dy) * inv;
  }
}

// The sums over one staged source leaf's `cnt` valid records at the
// lane's two targets (slots t0, t1).
template <typename T, bool LOG, bool SELF, int NU>
__device__ __forceinline__ void leaf_sum(const Rec<T>* __restrict__ src,
                                         int cnt, int t0, int t1, T z0r,
                                         T z0i, T z1r, T z1i, T& s0r,
                                         T& s0i, T& s1r, T& s1i) {
  s0r = s0i = s1r = s1i = T(0);
  if constexpr (NU > 0) {
    if (cnt == NU) {
#pragma unroll 16
      for (int j = 0; j < NU; ++j) {
        const Rec<T> s = src[j];
        pair_term<T, LOG, SELF>(s, j == t0, z0r, z0i, s0r, s0i);
        pair_term<T, LOG, SELF>(s, j == t1, z1r, z1i, s1r, s1i);
      }
      return;
    }
  }
#pragma unroll 4
  for (int j = 0; j < cnt; ++j) {
    const Rec<T> s = src[j];
    pair_term<T, LOG, SELF>(s, j == t0, z0r, z0i, s0r, s0i);
    pair_term<T, LOG, SELF>(s, j == t1, z1r, z1i, s1r, s1i);
  }
}

// Shared memory of one warp's ring: NSTAGE staged leaves of n packed
// records (in reals), and their ranks (in int32s).
static __host__ __device__ int ring_elems(int n) { return NSTAGE * n * 4; }
static __host__ __device__ int ring_ranks(int n) { return NSTAGE * n; }

// The near field of problem b's target leaf `box` at the lane's two
// targets (slots t0, t1 at z0, z1), added to (p0r, p0i) and (p1r, p1i)
// in list order. `list` holds the np compacted source leaves; `ring`
// and `ranks` are the warp's ring (ring_elems(n) reals, ring_ranks(n)
// int32s). Planes: (B, nb, n) particles, (nb, n) ranks. The warp's
// lanes all call it; it leaves the ring free for reuse.
template <typename T, bool LOG, int NF>
__device__ __forceinline__ void near_sum(
    const int32_t* list, int np, int box, long long b, int nb, int n_,
    const T* __restrict__ zr, const T* __restrict__ zi,
    const T* __restrict__ qr, const T* __restrict__ qi,
    const int32_t* __restrict__ rk, Rec<T>* ring, int32_t* ranks, int lane,
    int t0, int t1, T z0r, T z0i, T z1r, T z1i, T& p0r, T& p0i, T& p1r,
    T& p1i) {
  const int n = NF > 0 ? NF : n_;

  // Stage source leaf list[s] into ring slot s % NSTAGE.
  auto issue = [&](int s) {
    const int src = list[s];
    const long long sb = (b * nb + src) * n, rb = (long long)src * n;
    Rec<T>* dst = ring + (s % NSTAGE) * n;
    int32_t* rdst = ranks + (s % NSTAGE) * n;
    for (int j = lane; j < n; j += 32) {
      cp_async(&dst[j].x, zr + sb + j);
      cp_async(&dst[j].y, zi + sb + j);
      cp_async(&dst[j].qr, qr + sb + j);
      cp_async(&dst[j].qi, qi + sb + j);
      cp_async(rdst + j, rk + rb + j);
    }
  };

  __syncwarp();                        // list written; ring free
  for (int s = 0; s < NSTAGE - 1; ++s) {
    if (s < np) issue(s);
    cp_async_commit();
  }
  for (int s = 0; s < np; ++s) {
    if (s + NSTAGE - 1 < np) issue(s + NSTAGE - 1);
    cp_async_commit();
    cp_async_wait<NSTAGE - 1>();
    __syncwarp();                      // every lane's copies landed
    const Rec<T>* rec = ring + (s % NSTAGE) * n;
    const int32_t* rks = ranks + (s % NSTAGE) * n;
    int cnt = 0;                       // valid sources: a prefix
    for (int j0 = 0; j0 < n; j0 += 32)
      cnt += __popc(__ballot_sync(0xffffffffu,
                                  j0 + lane < n && rks[j0 + lane] >= 0));
    T s0r, s0i, s1r, s1i;
    if (list[s] == box)                // the target's own leaf
      leaf_sum<T, LOG, true, 0>(rec, cnt, t0, t1, z0r, z0i, z1r, z1i, s0r,
                                s0i, s1r, s1i);
    else    // log: the generic loop; the full-leaf loop unrolled by 16
            // ran slower on the card (f64, 2^20: 5.3 against 4.0 ms)
      leaf_sum<T, LOG, false, LOG ? 0 : NF>(rec, cnt, t0, t1, z0r, z0i, z1r,
                                            z1i, s0r, s0i, s1r, s1i);
    p0r += s0r;
    p0i += s0i;
    p1r += s1r;
    p1i += s1i;
    __syncwarp();                      // slot consumed before refill
  }
}

// Warps (target leaves) per block: `want`, or fewer where their
// per-warp shared memory would not fit in a block's beside `reserve`
// bytes of static shared memory (the clog tables of an f64 log launch).
static int fit_warps(size_t per_warp, int want, size_t reserve = 0) {
  const size_t fit = (SMEM_OPTIN - reserve) / per_warp;
  return fit < (size_t)want ? (int)fit : want;
}
