// Device code of K1's blocked Cholesky, shared by chol.cu (K1) and
// fused_svgp.cu (K2, which factorizes its own Gram with it), and the host
// helper that launches a kernel over thread-block clusters.
//
// One matrix per cluster of `csize` thread blocks (8 or 16, THREADS threads
// each; Hopper thread block clusters), right-looking, two-level blocked:
// 32-wide inner panels inside 128-wide outer panels (OUTER tiles of NB).
// For each inner panel k:
//   1. every block reads the 32x32 diagonal tile and factorizes it in shared
//      memory, one row per lane, the columns right of each pair of pivots
//      dealt to the block's warps. The blocks compute bit-identical
//      factors, so they agree on a failed pivot without communicating;
//   2. the panel rows below it are solved against it (x L11^T = a) by
//      forward substitution, one row per thread in registers, UNIT rows
//      per unit, units spread over the cluster;
//   3. the columns of the same outer panel right of k take their depth-32
//      update.
// After the last inner panel of an outer panel, the trailing lower triangle
// takes one update of depth 128: 64x64 output units spread over the
// cluster, the two 64x32 panel slices of each depth tile staged in shared
// memory (the next tile's loads in flight during this one's FMAs), a 4x4
// register micro-tile per thread accumulated over the whole depth, then
// one read-modify-write of the target. FMA in the working type, no tensor
// cores (no TF32). Every load from the storage is batched: a thread issues
// all its loads of a step before its first store, so their latencies
// (distributed shared memory or L2) overlap; the panel slices of the
// resident storage are read in 16-byte vectors.
//
// Storage (`Store`): where the lower triangle fits, it lives in the
// cluster's shared memory ("resident") as 32x32 tiles, tile t of the
// row-major list of lower tiles in slot t / csize of block t % csize, read
// and written by any block over distributed shared memory; the padding of
// the last tile holds the identity, so every tile is full. Above that, the
// working factor lives in the output buffer in global memory (L2-resident
// at these sizes), read with __ldcg (other SMs write it) and masked at the
// ragged edge. Both storages run the same panel and update routines through
// Store::get / Store::put. cluster.sync() orders the phases; the global
// storage adds a __threadfence() before it.
//
// A non-positive or non-finite pivot becomes NaN, and the NaN flows into
// every later column, never a trap.

#pragma once

#include <cfloat>
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace mobocmf {

namespace cg = cooperative_groups;

constexpr int NB = 32;          // tile edge = inner panel width = warp width
constexpr int TILE_WORDS = NB * NB;
constexpr int OUTER = 4;        // tiles per outer panel: a trailing update of depth 128
constexpr int UNIT = 64;        // rows (and columns) of one panel or update unit
constexpr int LDS = NB + 1;     // padded row stride of the staging buffers
constexpr int THREADS = 256;    // 16 x 16 threads, 4 x 4 outputs each per update unit
constexpr unsigned FULL = 0xffffffffu;
// staging workspace, in words of T, at the start of the dynamic shared
// memory: two UNIT x NB panel slices, the diagonal tile, its reciprocal
// pivots
constexpr int WORK_WORDS = 2 * UNIT * LDS + NB * LDS + NB;
// launch_cluster's answer when no cluster of the plan fits on the card
constexpr int NOT_SCHEDULABLE = -2;

// Built with -DMOBOCMF_CHOL_PHASES (mobocmf_tpu_torch/profile_chol.py
// --phases), block 0 of a launch adds the nanoseconds (%globaltimer) each
// phase of the factorization took to phase_ns; otherwise PHASE is nothing.
enum Phase { kSyncTop, kDiag, kPanel, kSyncMid, kInner, kSyncOuter, kOuter, kPhases };
#ifdef MOBOCMF_CHOL_PHASES
__device__ unsigned long long phase_ns[kPhases];
__device__ __forceinline__ unsigned long long now_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
#define PHASE(p)                                              \
  do {                                                        \
    if (blockIdx.x == 0 && threadIdx.x == 0) {                \
      const unsigned long long t_ = now_ns();                 \
      phase_ns[p] += t_ - phase_t;                            \
      phase_t = t_;                                           \
    }                                                         \
  } while (0)
#define PHASE_START unsigned long long phase_t = now_ns()
#else
#define PHASE(p) \
  do {           \
  } while (0)
#define PHASE_START
#endif

template <typename T>
struct Num;

template <>
struct Num<float> {
  static constexpr float eps = FLT_EPSILON;
  static constexpr float big = FLT_MAX;
  __device__ static float nan() { return CUDART_NAN_F; }
  __device__ static float root(float x) { return sqrtf(x); }
  __device__ static float absval(float x) { return fabsf(x); }
  __device__ static float fma(float a, float b, float c) { return fmaf(a, b, c); }
  __device__ static float ex(float x) { return expf(x); }
};

template <>
struct Num<double> {
  static constexpr double eps = DBL_EPSILON;
  static constexpr double big = DBL_MAX;
  __device__ static double nan() { return CUDART_NAN; }
  __device__ static double root(double x) { return sqrt(x); }
  __device__ static double absval(double x) { return fabs(x); }
  __device__ static double fma(double a, double b, double c) { return ::fma(a, b, c); }
  __device__ static double ex(double x) { return ::exp(x); }
};

// The pivot sqrt(d) and its reciprocal. In f32 from the hardware's
// reciprocal square root and one Newton step (within an ulp or two of the
// correctly rounded value, at a fraction of the latency of a correctly
// rounded square root and division: the diagonal block's pivot chain runs
// it once per column); in f64, the reference precision, correctly rounded.
__device__ __forceinline__ void pivot(float d, float& piv, float& inv) {
  const float r = rsqrtf(d);
  inv = fmaf(r, fmaf(-0.5f * d * r, r, 0.5f), r);
  piv = d * inv;
}

__device__ __forceinline__ void pivot(double d, double& piv, double& inv) {
  piv = sqrt(d);
  inv = 1.0 / piv;
}

template <typename T>
__device__ __forceinline__ T tmax(T a, T b) {
  // NaN in b propagates, as jnp.maximum does
  return a > b ? a : b;
}

// Bytes of dynamic shared memory a block needs: the workspace, and with the
// resident storage its share of the lower triangle's tiles.
template <typename T>
__host__ __device__ inline long smem_bytes(int n, int csize, bool resident) {
  const long nt = (n + NB - 1) / NB;
  const long slots = (nt * (nt + 1) / 2 + csize - 1) / csize;
  return (long)sizeof(T) * (WORK_WORDS + (resident ? slots * TILE_WORDS : 0));
}

// Row of entry idx of the row-major list of lower tiles.
__device__ __forceinline__ int tri_row(int idx) {
  int ti = static_cast<int>((sqrtf(8.0f * idx + 1.0f) - 1.0f) * 0.5f);
  while ((ti + 1) * (ti + 2) / 2 <= idx) ++ti;
  while (ti * (ti + 1) / 2 > idx) --ti;
  return ti;
}

template <typename T>
struct Work {
  T (*PA)[LDS];  // UNIT x NB
  T (*PB)[LDS];  // UNIT x NB
  T (*D)[LDS];   // the diagonal tile, then its factor
  T* rinv;       // the factor's reciprocal pivots
};

template <typename T>
__device__ __forceinline__ Work<T> carve(unsigned char* smem) {
  T* p = reinterpret_cast<T*>(smem);
  Work<T> w;
  w.PA = reinterpret_cast<T(*)[LDS]>(p);
  w.PB = reinterpret_cast<T(*)[LDS]>(p + UNIT * LDS);
  w.D = reinterpret_cast<T(*)[LDS]>(p + 2 * UNIT * LDS);
  w.rinv = p + 2 * UNIT * LDS + NB * LDS;
  return w;
}

template <typename T, bool RESIDENT>
struct Store {
  T* base;  // resident: this block's tile slots; else the n x n matrix
  int n, nt, rank, lgc;  // lgc = log2(cluster size)

  __device__ __forceinline__ int owner(int ti, int tj) const {
    return RESIDENT ? ((ti * (ti + 1) / 2 + tj) & ((1 << lgc) - 1)) : 0;
  }
  // element (0, 0) of lower tile (ti, tj), rows NB apart (resident only)
  __device__ __forceinline__ T* tile(int ti, int tj) const {
    const int idx = ti * (ti + 1) / 2 + tj;
    const int own = idx & ((1 << lgc) - 1);
    T* local = base + (size_t)(idx >> lgc) * TILE_WORDS;
    return own == rank ? local : cg::this_cluster().map_shared_rank(local, own);
  }
  // entry (r, c), c <= r < nt * NB; outside the matrix the identity
  __device__ __forceinline__ T get(int r, int c) const {
    if constexpr (RESIDENT) {
      return tile(r / NB, c / NB)[(r % NB) * NB + c % NB];
    } else {
      if (r < n && c < n) return __ldcg(base + (size_t)r * n + c);
      return r == c ? T(1) : T(0);
    }
  }
  __device__ __forceinline__ void put(int r, int c, T v) const {
    if constexpr (RESIDENT) {
      tile(r / NB, c / NB)[(r % NB) * NB + c % NB] = v;
    } else {
      if (r < n && c < n) base[(size_t)r * n + c] = v;
    }
  }
};

template <bool RESIDENT>
__device__ __forceinline__ void sync_cluster(cg::cluster_group& cluster) {
  if constexpr (!RESIDENT) __threadfence();
  cluster.sync();
}

// Load f(r, c) for c <= r < n into the storage; the resident tiles get a
// zero upper triangle and the identity outside the matrix.
template <typename T, bool RESIDENT, typename F>
__device__ void stage(const Store<T, RESIDENT>& S, int csize, const F& f) {
  const int n = S.n;
  if constexpr (RESIDENT) {
    const int ntiles = S.nt * (S.nt + 1) / 2;
    for (int idx = S.rank; idx < ntiles; idx += csize) {
      const int ti = tri_row(idx), tj = idx - ti * (ti + 1) / 2;
      T* t = S.base + (size_t)(idx / csize) * TILE_WORDS;
      for (int e = threadIdx.x; e < TILE_WORDS; e += THREADS) {
        const int r = ti * NB + e / NB, c = tj * NB + e % NB;
        t[e] = c > r ? T(0) : (r < n ? f(r, c) : (r == c ? T(1) : T(0)));
      }
    }
  } else {
    for (int r = S.rank; r < n; r += csize)
      for (int c = threadIdx.x; c <= r; c += THREADS) S.base[(size_t)r * n + c] = f(r, c);
  }
}

template <typename T>
struct Vec16;
template <>
struct Vec16<float> {
  using type = float4;
};
template <>
struct Vec16<double> {
  using type = double2;
};

__device__ __forceinline__ void unpack(const float4& x, float* d) {
  d[0] = x.x;
  d[1] = x.y;
  d[2] = x.z;
  d[3] = x.w;
}

__device__ __forceinline__ void unpack(const double2& x, double* d) {
  d[0] = x.x;
  d[1] = x.y;
}

// Stage rows [r0, r0 + UNIT) x columns [c0, c0 + NB) of the storage (rows
// >= r_end zero) into registers v, and the same from q0 when `two`: every
// load is issued before the first store, so their latencies overlap. The
// resident storage is read in 16-byte vectors along a tile's rows.
template <typename T, bool RESIDENT>
__device__ __forceinline__ void load_slices(const Store<T, RESIDENT>& S, T* v, int r0, int q0,
                                            int r_end, int q_end, int c0, bool two) {
  constexpr int PER = UNIT * NB / THREADS;
  if constexpr (RESIDENT) {
    using V = typename Vec16<T>::type;
    constexpr int W = sizeof(V) / sizeof(T);
#pragma unroll
    for (int q = 0; q < PER / W; ++q) {
      const int e = threadIdx.x + q * THREADS, i = e / (NB / W), j = e % (NB / W) * W;
      V x = {}, y = {};
      if (r0 + i < r_end)
        x = *reinterpret_cast<const V*>(S.tile((r0 + i) / NB, c0 / NB) + (r0 + i) % NB * NB + j);
      if (two && q0 + i < q_end)
        y = *reinterpret_cast<const V*>(S.tile((q0 + i) / NB, c0 / NB) + (q0 + i) % NB * NB + j);
      unpack(x, v + q * W);
      if (two) unpack(y, v + PER + q * W);
    }
  } else {
#pragma unroll
    for (int q = 0; q < PER; ++q) {
      const int e = threadIdx.x + q * THREADS, i = e / NB, j = e % NB;
      v[q] = r0 + i < r_end ? S.get(r0 + i, c0 + j) : T(0);
      if (two) v[PER + q] = q0 + i < q_end ? S.get(q0 + i, c0 + j) : T(0);
    }
  }
}

// The registers of load_slices into P (and Q), in the same layout.
template <typename T, bool RESIDENT>
__device__ __forceinline__ void store_slices(T (*P)[LDS], T (*Q)[LDS], const T* v, bool two) {
  constexpr int PER = UNIT * NB / THREADS;
  constexpr int W = RESIDENT ? sizeof(typename Vec16<T>::type) / sizeof(T) : 1;
#pragma unroll
  for (int q = 0; q < PER / W; ++q) {
    const int e = threadIdx.x + q * THREADS, i = e / (NB / W), j = e % (NB / W) * W;
#pragma unroll
    for (int t = 0; t < W; ++t) {
      P[i][j + t] = v[q * W + t];
      if (two) Q[i][j + t] = v[PER + q * W + t];
    }
  }
}

// Every block: diagonal tile k into D, factorized in place by all warps:
// lane i owns row i, and for each pair of pivots the columns to their right
// are dealt round-robin to the warps (one barrier per pair), with
// l_ik = a_ik / sqrt(a_kk) as a product with the reciprocal pivot; rinv
// gets the reciprocal pivots. Every
// thread reads the same pivots, so the answer (did a pivot fail?) is the
// same in every thread and every block.
template <typename T, bool RESIDENT>
__device__ bool factor_diag(const Store<T, RESIDENT>& S, int k, Work<T>& w) {
  constexpr int PER = TILE_WORDS / THREADS;
  constexpr int WARPS = THREADS / 32;
  const int tid = threadIdx.x, lane = tid % 32, wid = tid / 32;
  T v[PER];
#pragma unroll
  for (int q = 0; q < PER; ++q) {
    const int e = tid + q * THREADS, i = e / NB, j = e % NB;
    v[q] = j <= i ? S.get(k * NB + i, k * NB + j) : T(0);
  }
#pragma unroll
  for (int q = 0; q < PER; ++q) {
    const int e = tid + q * THREADS;
    w.D[e / NB][e % NB] = v[q];
  }
  __syncthreads();
  bool bad = false;
  // two pivots per barrier: the second column's update by the first is
  // formed on the fly, with the same operations in the same order as two
  // single steps, so the factor is bit-identical to the unpaired loop
#pragma unroll 1
  for (int kk = 0; kk < NB; kk += 2) {
    T d0 = w.D[kk][kk];
    if (!(d0 > T(0) && d0 <= Num<T>::big)) {  // <= 0, NaN or inf
      d0 = Num<T>::nan();
      bad = true;
    }
    T piv0, inv0;
    pivot(d0, piv0, inv0);
    const T l10 = w.D[kk + 1][kk] * inv0;
    T d1 = Num<T>::fma(-l10, l10, w.D[kk + 1][kk + 1]);
    if (!(d1 > T(0) && d1 <= Num<T>::big)) {
      d1 = Num<T>::nan();
      bad = true;
    }
    T piv1, inv1;
    pivot(d1, piv1, inv1);
    const T li0 = w.D[lane][kk] * inv0;
    const T li1 = Num<T>::fma(-li0, l10, w.D[lane][kk + 1]) * inv1;
    T a[NB / WARPS], b0[NB / WARPS], b1[NB / WARPS];
#pragma unroll
    for (int m = 0; m < NB / WARPS; ++m) {
      const int j = kk + 2 + wid + WARPS * m;
      b0[m] = j < NB ? w.D[j][kk] : T(0);
      b1[m] = j < NB ? w.D[j][kk + 1] : T(0);
      a[m] = j < NB && j <= lane ? w.D[lane][j] : T(0);
    }
#pragma unroll
    for (int m = 0; m < NB / WARPS; ++m) {
      const int j = kk + 2 + wid + WARPS * m;
      if (j < NB && j <= lane) {
        const T lj0 = b0[m] * inv0;
        const T lj1 = Num<T>::fma(-lj0, l10, b1[m]) * inv1;
        w.D[lane][j] = Num<T>::fma(-li1, lj1, Num<T>::fma(-li0, lj0, a[m]));
      }
    }
    __syncthreads();  // columns kk, kk + 1 are read by every warp before they are scaled
    if (wid == (kk / 2) % WARPS) {
      if (lane == kk) {
        w.D[kk][kk] = piv0;
        w.rinv[kk] = inv0;
      }
      if (lane > kk) w.D[lane][kk] = li0;
      if (lane == kk + 1) {
        w.D[kk + 1][kk + 1] = piv1;
        w.rinv[kk + 1] = inv1;
      }
      if (lane > kk + 1) w.D[lane][kk + 1] = li1;
    }
  }
  __syncthreads();
  return bad;
}

// The rows below diagonal tile k: solve x L_kk^T = a for each row by
// forward substitution (as a triangular solve does it, so a failed pivot's
// NaN reaches every later column), one row per thread in registers, units
// of UNIT rows spread over the cluster.
template <typename T, bool RESIDENT>
__device__ void panel(const Store<T, RESIDENT>& S, int k, int csize, Work<T>& w) {
  constexpr int PER = UNIT * NB / THREADS;
  const int tid = threadIdx.x;
  const int r_begin = (k + 1) * NB, r_end = S.nt * NB, c0 = k * NB;
  for (int r0 = r_begin + S.rank * UNIT; r0 < r_end; r0 += csize * UNIT) {
    T v[PER];
    load_slices<T, RESIDENT>(S, v, r0, 0, r_end, 0, c0, false);
    store_slices<T, RESIDENT>(w.PA, w.PB, v, false);
    __syncthreads();
    if (tid < UNIT) {
      T x[NB];
#pragma unroll
      for (int j = 0; j < NB; ++j) x[j] = w.PA[tid][j];
#pragma unroll
      for (int j = 0; j < NB; ++j) {
        x[j] *= w.rinv[j];
#pragma unroll
        for (int q = j + 1; q < NB; ++q) x[q] = Num<T>::fma(-x[j], w.D[q][j], x[q]);
      }
#pragma unroll
      for (int j = 0; j < NB; ++j) w.PA[tid][j] = x[j];
    }
    __syncthreads();
#pragma unroll
    for (int q = 0; q < PER; ++q) {
      const int e = tid + q * THREADS, i = e / NB, j = e % NB;
      if (r0 + i < r_end) S.put(r0 + i, c0 + j, w.PA[i][j]);
    }
    __syncthreads();
  }
}

// A[r, c] -= sum over depth tiles d in [d0, d1) of L[r, tile d] L[c, tile d]^T
// for ka*NB <= c <= r < nt*NB and c < kc*NB: 64x64 output units spread
// over the cluster, the whole depth accumulated in registers (the next
// depth tile's loads in flight during this one's FMAs), then one
// read-modify-write of the target.
template <typename T, bool RESIDENT>
__device__ void update(const Store<T, RESIDENT>& S, int ka, int kc, int d0, int d1, int csize,
                       Work<T>& w) {
  constexpr int PER = UNIT * NB / THREADS;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int base = ka * NB, r_end = S.nt * NB, c_end = kc * NB;
  const int nu = (r_end - base + UNIT - 1) / UNIT, nv = (c_end - base + UNIT - 1) / UNIT;
  int t = 0;
  for (int v = 0; v < nv; ++v) {
    for (int u = v; u < nu; ++u, ++t) {
      if (t % csize != S.rank) continue;
      const int r0 = base + u * UNIT, c0 = base + v * UNIT;
      T acc[4][4];
#pragma unroll
      for (int p = 0; p < 4; ++p)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[p][q] = T(0);
      T stage[2 * PER];
      load_slices<T, RESIDENT>(S, stage, r0, c0, r_end, c_end, d0 * NB, true);
      for (int d = d0; d < d1; ++d) {
        store_slices<T, RESIDENT>(w.PA, w.PB, stage, true);
        __syncthreads();
        if (d + 1 < d1)
          load_slices<T, RESIDENT>(S, stage, r0, c0, r_end, c_end, (d + 1) * NB, true);
#pragma unroll 8
        for (int kk = 0; kk < NB; ++kk) {
          T av[4], bv[4];
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            av[q] = w.PA[ty + 16 * q][kk];
            bv[q] = w.PB[tx + 16 * q][kk];
          }
#pragma unroll
          for (int p = 0; p < 4; ++p)
#pragma unroll
            for (int q = 0; q < 4; ++q) acc[p][q] = Num<T>::fma(av[p], bv[q], acc[p][q]);
        }
        __syncthreads();
      }
      T old[4][4];
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        const int r = r0 + ty + 16 * p;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int c = c0 + tx + 16 * q;
          old[p][q] = r < r_end && c < c_end && c <= r ? S.get(r, c) : T(0);
        }
      }
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        const int r = r0 + ty + 16 * p;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int c = c0 + tx + 16 * q;
          if (r < r_end && c < c_end && c <= r) S.put(r, c, old[p][q] - acc[p][q]);
        }
      }
    }
  }
}

// One attempt on the staged matrix, in place. Returns false early, on a
// failed pivot, when `last` is false; the same in every block. Ends with a
// cluster.sync(): every tile is final and no block reads another's.
template <typename T, bool RESIDENT>
__device__ bool factor(const Store<T, RESIDENT>& S, int outer, bool last,
                       cg::cluster_group& cluster, Work<T>& w) {
  const int csize = static_cast<int>(cluster.num_blocks());
  const int nt = S.nt;
  bool ok = true;
  PHASE_START;
  for (int p = 0; p < nt; p += outer) {
    const int pe = min(p + outer, nt);
    for (int k = p; k < pe; ++k) {
      sync_cluster<RESIDENT>(cluster);  // tile column k is up to date
      PHASE(kSyncTop);
      if (factor_diag<T, RESIDENT>(S, k, w)) {
        ok = false;
        if (!last) return false;  // uniform over the cluster
      }
      PHASE(kDiag);
      panel<T, RESIDENT>(S, k, csize, w);
      PHASE(kPanel);
      // every block has read the diagonal tile before its owner overwrites
      // it, and the panel is written before the updates read it
      sync_cluster<RESIDENT>(cluster);
      PHASE(kSyncMid);
      if (S.owner(k, k) == S.rank) {
        for (int e = threadIdx.x; e < TILE_WORDS; e += THREADS) {
          const int i = e / NB, j = e % NB;
          S.put(k * NB + i, k * NB + j, w.D[i][j]);
        }
      }
      if (k + 1 < pe) update<T, RESIDENT>(S, k + 1, pe, k, k + 1, csize, w);
      PHASE(kInner);
    }
    if (pe < nt) {
      sync_cluster<RESIDENT>(cluster);
      PHASE(kSyncOuter);
      update<T, RESIDENT>(S, pe, nt, p, pe, csize, w);
      PHASE(kOuter);
    }
  }
  sync_cluster<RESIDENT>(cluster);
  return ok;
}

// The factor into the n x n row-major `out` with a zeroed strict upper
// triangle. Resident: each block writes its own tiles and a share of the
// rows' upper part; global storage (out is the storage): the upper part.
template <typename T, bool RESIDENT>
__device__ void write_out(const Store<T, RESIDENT>& S, T* out, int csize) {
  const int n = S.n;
  if constexpr (RESIDENT) {
    const int ntiles = S.nt * (S.nt + 1) / 2;
    for (int idx = S.rank; idx < ntiles; idx += csize) {
      const int ti = tri_row(idx), tj = idx - ti * (ti + 1) / 2;
      const T* t = S.base + (size_t)(idx / csize) * TILE_WORDS;
      for (int e = threadIdx.x; e < TILE_WORDS; e += THREADS) {
        const int r = ti * NB + e / NB, c = tj * NB + e % NB;
        if (r < n && c < n) out[(size_t)r * n + c] = c <= r ? t[e] : T(0);
      }
    }
    for (int r = S.rank; r < n; r += csize)
      for (int c = (r / NB + 1) * NB + threadIdx.x; c < n; c += THREADS)
        out[(size_t)r * n + c] = T(0);
  } else {
    for (int r = S.rank; r < n; r += csize)
      for (int c = r + 1 + threadIdx.x; c < n; c += THREADS) out[(size_t)r * n + c] = T(0);
  }
}

template <typename T, bool RESIDENT>
__device__ __forceinline__ Store<T, RESIDENT> make_store(unsigned char* smem, T* global, int n,
                                                         cg::cluster_group& cluster) {
  Store<T, RESIDENT> S;
  S.base = RESIDENT ? reinterpret_cast<T*>(smem) + WORK_WORDS : global;
  S.n = n;
  S.nt = (n + NB - 1) / NB;
  S.rank = static_cast<int>(cluster.block_rank());
  S.lgc = 31 - __clz(static_cast<int>(cluster.num_blocks()));
  return S;
}

// Host: the number of clusters of `csize` blocks (THREADS threads, `smem`
// bytes of dynamic shared memory each) of `kern` the card can hold at once,
// in `active`. Asked once per (kernel, device, csize, smem) and cached; the
// kernel's attributes (non-portable cluster size, dynamic shared memory up
// to the opt-in limit) are set with the first question.
struct ClusterCache {
  const void* kern;
  int device, csize, smem, active;
};

template <typename Kern>
cudaError_t max_active_clusters(Kern kern, int csize, int smem, int* active) {
  static ClusterCache cache[64];
  static int used = 0;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  for (int i = 0; i < used; ++i) {
    const ClusterCache& c = cache[i];
    if (c.kern == (const void*)kern && c.device == device && c.csize == csize && c.smem == smem) {
      *active = c.active;
      return cudaSuccess;
    }
  }
  int optin = 0;
  cudaFuncAttributes fa;
  if ((err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device)) ||
      (err = cudaFuncGetAttributes(&fa, kern)) ||
      (err = cudaFuncSetAttribute(kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1)) ||
      (err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  optin - static_cast<int>(fa.sharedSizeBytes))))
    return err;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = csize;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(csize);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaOccupancyMaxActiveClusters(active, (const void*)kern, &cfg);
  if (err != cudaSuccess) return err;
  if (used < 64) cache[used++] = ClusterCache{(const void*)kern, device, csize, smem, *active};
  return cudaSuccess;
}

// Host: launch `kern` on `blocks` blocks in clusters of `csize` (a power of
// two up to 16; above 8 the non-portable size) with `smem` bytes of dynamic
// shared memory. Returns NOT_SCHEDULABLE when the card cannot hold one such
// cluster, else the CUDA error of the launch (0 = ok).
template <typename Kern, typename... Args>
int launch_cluster(Kern kern, int blocks, int csize, int smem, cudaStream_t stream,
                   Args... args) {
  if (csize < 1 || csize > 16 || (csize & (csize - 1)) || blocks % csize)
    return static_cast<int>(cudaErrorInvalidValue);
  int active = 0;
  cudaError_t err = max_active_clusters(kern, csize, smem, &active);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (active < 1) return NOT_SCHEDULABLE;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = csize;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kern, args...);
  if (err == cudaSuccess) err = cudaGetLastError();
  return static_cast<int>(err);
}

}  // namespace mobocmf
