// Device code of K1's blocked Cholesky, shared by chol.cu (K1) and
// fused_svgp.cu (K2, which factorizes its own Gram with it).
//
// `factor` runs one attempt on the lower triangle of an n x n matrix held
// in global memory, in place, over a cluster of CLUSTER thread blocks of
// THREADS threads each (Hopper thread block clusters; cluster.sync()
// between the phases of a step), right-looking with 32-wide column panels:
//   1. every block of the cluster loads the 32x32 diagonal block and one
//      warp factorizes it in registers (one row per lane, shuffles for the
//      column broadcasts). The blocks compute bit-identical factors, so
//      they agree on a failed pivot without communicating;
//   2. the panel rows below it are split over the cluster; each thread
//      solves its rows against the block (x L11^T = a) in registers;
//   3. the 64x64 tiles of the trailing lower triangle are split over the
//      cluster: two 64x32 panel slices staged in shared memory, a 4x4
//      register micro-tile per thread, FMA in the working type (no tensor
//      cores, so no TF32).
// Reads of the working factor bypass L1 (__ldcg): other SMs of the cluster
// write it between two cluster.sync() calls. A non-positive or non-finite
// pivot becomes NaN and flows into every later column.

#pragma once

#include <cfloat>
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace mobocmf {

namespace cg = cooperative_groups;

constexpr int NB = 32;       // panel width = warp width
constexpr int TILE = 64;     // trailing-update tile edge
constexpr int THREADS = 256; // 16 x 16 threads, 4 x 4 outputs each per tile
constexpr int CLUSTER = 8;   // blocks per matrix (the portable cluster size)
constexpr unsigned FULL = 0xffffffffu;

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

template <typename T>
__device__ __forceinline__ T tmax(T a, T b) {
  // NaN in b propagates, as jnp.maximum does
  return a > b ? a : b;
}

__device__ __forceinline__ void cluster_sync(cg::cluster_group& cluster) {
  __threadfence();
  cluster.sync();
}

// Factorize the nb x nb diagonal block held in D in place, with warp 0:
// lane i holds row i. Returns (in every thread) whether a pivot failed.
template <typename T>
__device__ __forceinline__ bool factor_diag_block(T (*D)[NB + 1], int nb, int* failed) {
  const int tid = threadIdx.x;
  if (tid < NB) {
    const int i = tid;
    T r[NB];
#pragma unroll
    for (int j = 0; j < NB; ++j) r[j] = (i < nb && j <= i) ? D[i][j] : T(0);
    bool bad = false;
#pragma unroll
    for (int k = 0; k < NB; ++k) {
      if (k < nb) {
        T d = __shfl_sync(FULL, r[k], k);
        if (!(d > T(0) && d <= Num<T>::big)) {  // <= 0, NaN or inf
          d = Num<T>::nan();
          bad = true;
        }
        const T piv = Num<T>::root(d);
        if (i == k) r[k] = piv;
        if (i > k) r[k] = r[k] / piv;
#pragma unroll
        for (int j = k + 1; j < NB; ++j) {
          const T ljk = __shfl_sync(FULL, r[k], j);
          if (j <= i) r[j] -= r[k] * ljk;
        }
      }
    }
    if (i < nb) {
#pragma unroll
      for (int j = 0; j < NB; ++j)
        if (j <= i) D[i][j] = r[j];
    }
    if (i == 0) *failed = bad ? 1 : 0;
  }
  __syncthreads();
  return *failed != 0;
}

// One attempt on the lower triangle held in L (A + jitter*I already
// loaded). Returns false early, on a failed pivot, when `last` is false.
// The same in every block of the cluster.
template <typename T>
__device__ __forceinline__ bool factor(T* L, int n, bool last, cg::cluster_group& cluster,
                                       T (*D)[NB + 1], T (*PA)[NB + 1], T (*PB)[NB + 1],
                                       int* failed) {
  const int tid = threadIdx.x;
  const int rank = static_cast<int>(cluster.block_rank());
  const int tx = tid % 16, ty = tid / 16;
  bool any_failed = false;
  for (int k0 = 0; k0 < n; k0 += NB) {
    const int nb = min(NB, n - k0);

    // 1. diagonal block
    for (int e = tid; e < NB * NB; e += THREADS) {
      const int i = e / NB, j = e % NB;
      if (i < nb && j <= i) D[i][j] = __ldcg(L + (size_t)(k0 + i) * n + k0 + j);
    }
    __syncthreads();
    any_failed |= factor_diag_block<T>(D, nb, failed);
    if (any_failed && !last) return false;  // uniform over the cluster
    const int k1 = k0 + nb;

    // 2. panel rows k1..n-1 (none after the last block; nb == NB before
    // it), split over the cluster: solve x L11^T = a. The block is read
    // through a volatile view: otherwise the compiler hoists its 528
    // row-invariant loads out of the row loop and spills them.
    const volatile T(*Dv)[NB + 1] = D;
    for (int r = k1 + rank * THREADS + tid; r < n; r += CLUSTER * THREADS) {
      T* row = L + (size_t)r * n + k0;
      T x[NB];
#pragma unroll
      for (int j = 0; j < NB; ++j) x[j] = __ldcg(row + j);
#pragma unroll
      for (int j = 0; j < NB; ++j) {
        T acc = x[j];
#pragma unroll
        for (int k = 0; k < j; ++k) acc -= x[k] * Dv[j][k];
        x[j] = acc / Dv[j][j];
      }
#pragma unroll
      for (int j = 0; j < NB; ++j) row[j] = x[j];
    }
    // every block has loaded the diagonal block before rank 0 overwrites it
    cluster_sync(cluster);
    if (rank == 0) {
      for (int e = tid; e < NB * NB; e += THREADS) {
        const int i = e / NB, j = e % NB;
        if (i < nb && j <= i) L[(size_t)(k0 + i) * n + k0 + j] = D[i][j];
      }
    }
    if (k1 >= n) break;

    // 3. trailing lower triangle: L22 -= P P^T with P = L[k1:, k0:k0+NB];
    // tile t of the row-major list of lower tiles goes to block t % CLUSTER
    const int nt = (n - k1 + TILE - 1) / TILE;
    int t = 0;
    for (int ti = 0; ti < nt; ++ti) {
      for (int tj = 0; tj <= ti; ++tj, ++t) {
        if (t % CLUSTER != rank) continue;
        const int r0 = k1 + ti * TILE, c0 = k1 + tj * TILE;
        for (int e = tid; e < TILE * NB; e += THREADS) {
          const int i = e / NB, k = e % NB;
          const int r = r0 + i, c = c0 + i;
          PA[i][k] = r < n ? __ldcg(L + (size_t)r * n + k0 + k) : T(0);
          PB[i][k] = c < n ? __ldcg(L + (size_t)c * n + k0 + k) : T(0);
        }
        __syncthreads();
        T acc[4][4];
#pragma unroll
        for (int p = 0; p < 4; ++p)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[p][q] = T(0);
#pragma unroll 8
        for (int k = 0; k < NB; ++k) {
          T av[4], bv[4];
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            av[q] = PA[ty + 16 * q][k];
            bv[q] = PB[tx + 16 * q][k];
          }
#pragma unroll
          for (int p = 0; p < 4; ++p)
#pragma unroll
            for (int q = 0; q < 4; ++q) acc[p][q] = Num<T>::fma(av[p], bv[q], acc[p][q]);
        }
#pragma unroll
        for (int p = 0; p < 4; ++p) {
          const int r = r0 + ty + 16 * p;
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int c = c0 + tx + 16 * q;
            if (r < n && c <= r) {
              T* dst = L + (size_t)r * n + c;
              *dst = __ldcg(dst) - acc[p][q];
            }
          }
        }
        __syncthreads();
      }
    }
    cluster_sync(cluster);
  }
  return true;
}

// Zero the strict upper triangle of the n x n matrix L, rows split over
// the cluster.
template <typename T>
__device__ __forceinline__ void zero_upper(T* L, int n, int rank) {
  for (int i = rank; i < n; i += CLUSTER)
    for (int j = i + 1 + threadIdx.x; j < n; j += THREADS) L[(size_t)i * n + j] = T(0);
}

}  // namespace mobocmf
