// K2: fused RBF-SVGP predictive (unwhitened, forward only) for a batch of
// layer states, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel mobocmf_tpu/linalg/fused_svgp.py::
// _fused_kernel (helpers _rbf_block, _chol_inplace, _forward_substitute;
// launched by fused_rbf_svgp_forward). For every state s of a batch of B,
// with z (M, d) and x (N, d) shared and a = z / ls_s, b = x / ls_s:
//   K   = os_s * exp(-0.5 ||a_i - a_j||^2) + jitter_s * I   (direct differences)
//   L   = chol(K)                                           (no jitter ladder)
//   W   = L^{-1} [K_zx | L_S | m]
//   mu  = W_kzx^T W_m
//   var = max(os_s - colsum(W_kzx^2) + colsum((W_ls^T W_kzx)^2), 1e-12)
// A failed pivot gives NaN from that pivot on (K1's contract), never a trap.
//
// Design: three launches on the caller's stream.
//   1. gram_factor_kernel, one cluster per state under K1's plan for M:
//      the Gram's lower triangle staged straight into the factor's storage
//      (the cluster's shared memory where it fits, else the scratch
//      factor), K1's cluster factorization (chol_factor.cuh) with no
//      ladder, and L written to the scratch factor for launches 2-3.
//   2. solve_kernel<false>, one block per (state, 32 right-hand sides):
//      W_ls | w_m = L^{-1} [L_S | m] into a (B, M, M+1) scratch.
//   3. solve_kernel<true>, one block per (state, 32 columns of x): K_zx in
//      the block, the same forward substitution, then mu, colsum(W^2) and
//      colsum((W_ls^T W)^2) reduced in the block; writes mu and var.
// The forward substitution is blocked by 32-row panels: the panel's
// right-hand sides less L[panel, :p0] X[:p0] (32x32 tiles of L and X staged
// in shared memory, 4 outputs per thread), then the 32x32 triangle, one
// warp per column with shuffles. The columns are independent, so launch 3
// spreads over B * ceil(N/32) blocks. FMA in the working type, no tensor
// cores (no TF32), no library calls.
// Bound: per state M^3/3 + M^2 (N + M + 1) + 2 M^2 N flops against
// (M + N) d + M^2 + M + 2N words: compute-bound at the slice's shapes.
// The factorization (launch 1) is the serial part: one cluster per state.

#include "chol_factor.cuh"

namespace {

using namespace mobocmf;

constexpr int CT = 32;  // right-hand-side columns per block of the solves
constexpr int PR = 32;  // rows per panel of the forward substitution
constexpr int ROWS = THREADS / CT;  // 8 row groups: thread (tr, tc)

template <typename T>
struct Args {
  const T* z;        // (M, d)
  const T* x;        // (N, d)
  const T* mean;     // (B, M)
  const T* ls_chol;  // (B, M, M), lower triangle read
  const T* ls;       // (B, d) lengthscales
  const T* os;       // (B,) outputscales
  const T* jitter;   // (B,)
  T* fac;            // (B, M, M) scratch: the factor L
  T* wls;            // (B, M, M+1) scratch: L^{-1} [L_S | m]
  T* work;           // (B, M, N) scratch: L^{-1} K_zx
  T* mu;             // (B, N)
  T* var;            // (B, N)
  int batch, m, n, d;
};

// os * exp(-0.5 ||u/ls - v/ls||^2), inputs divided first as in the TPU kernel
template <typename T>
__device__ __forceinline__ T rbf(const T* u, const T* v, const T* ls, T os, int d) {
  T d2 = T(0);
  for (int k = 0; k < d; ++k) {
    const T diff = u[k] / ls[k] - v[k] / ls[k];
    d2 = Num<T>::fma(diff, diff, d2);
  }
  return os * Num<T>::ex(T(-0.5) * d2);
}

// K + jitter * I, lower triangle, from the direct differences
template <typename T>
struct Gram {
  const T* z;
  const T* ls;
  T os, jit;
  int d;
  __device__ T operator()(int r, int c) const {
    return rbf<T>(z + (size_t)r * d, z + (size_t)c * d, ls, os, d) + (r == c ? jit : T(0));
  }
};

template <typename T, bool RESIDENT>
__global__ void __launch_bounds__(THREADS) gram_factor_kernel(Args<T> a) {
  extern __shared__ __align__(16) unsigned char smem[];

  cg::cluster_group cluster = cg::this_cluster();
  const int csize = static_cast<int>(cluster.num_blocks());
  const int s = blockIdx.x / csize;
  T* L = a.fac + (size_t)s * a.m * a.m;
  Work<T> w = carve<T>(smem);
  const Store<T, RESIDENT> S = make_store<T, RESIDENT>(smem, L, a.m, cluster);
  stage<T, RESIDENT>(S, csize, Gram<T>{a.z, a.ls + (size_t)s * a.d, a.os[s], a.jitter[s], a.d});
  factor<T, RESIDENT>(S, OUTER, true, cluster, w);
  write_out<T, RESIDENT>(S, L, csize);
}

// X <- L^{-1} X on the columns [c0, c0 + CT) of the (M, ldx) row-major
// block X (columns >= ncols are outside the matrix). L is lower (M, M).
template <typename T>
__device__ void forward_substitute(const T* L, T* X, int m, int ldx, int c0, int ncols,
                                   T (*Ls)[PR + 1], T (*Xs)[CT + 1]) {
  const int tid = threadIdx.x;
  const int tc = tid % CT, tr = tid / CT;
  const int lane = tid % 32, warp = tid / 32;
  const int col = c0 + tc;
  const bool colok = col < ncols;
  for (int p0 = 0; p0 < m; p0 += PR) {
    const int pb = min(PR, m - p0);
    T acc[PR / ROWS];
#pragma unroll
    for (int q = 0; q < PR / ROWS; ++q) {
      const int r = p0 + tr + ROWS * q;
      acc[q] = (r < m && colok) ? X[(size_t)r * ldx + col] : T(0);
    }
    // acc -= L[p0:p0+PR, k0:k0+PR] X[k0:k0+PR, cols], every earlier panel
    for (int k0 = 0; k0 < p0; k0 += PR) {
      for (int e = tid; e < PR * PR; e += THREADS) {
        const int i = e / PR, k = e % PR;
        Ls[i][k] = (p0 + i < m) ? L[(size_t)(p0 + i) * m + k0 + k] : T(0);
      }
      for (int e = tid; e < PR * CT; e += THREADS) {
        const int k = e / CT, c = e % CT;
        Xs[k][c] = (c0 + c < ncols) ? X[(size_t)(k0 + k) * ldx + c0 + c] : T(0);
      }
      __syncthreads();
#pragma unroll 8
      for (int k = 0; k < PR; ++k) {
        const T xv = Xs[k][tc];
#pragma unroll
        for (int q = 0; q < PR / ROWS; ++q)
          acc[q] = Num<T>::fma(-Ls[tr + ROWS * q][k], xv, acc[q]);
      }
      __syncthreads();
    }
    // the panel's triangle: one warp per column, lane = row
    for (int e = tid; e < PR * PR; e += THREADS) {
      const int i = e / PR, k = e % PR;
      Ls[i][k] = (i < pb && k <= i) ? L[(size_t)(p0 + i) * m + p0 + k] : T(0);
    }
#pragma unroll
    for (int q = 0; q < PR / ROWS; ++q) Xs[tr + ROWS * q][tc] = acc[q];
    __syncthreads();
    for (int c = warp; c < CT; c += THREADS / 32) {
      T v = Xs[lane][c];
      for (int k = 0; k < pb; ++k) {
        const T xk = __shfl_sync(FULL, v, k) / Ls[k][k];
        if (lane == k) v = xk;
        if (lane > k) v = Num<T>::fma(-Ls[lane][k], xk, v);
      }
      Xs[lane][c] = v;
    }
    __syncthreads();
#pragma unroll
    for (int q = 0; q < PR / ROWS; ++q) {
      const int r = p0 + tr + ROWS * q;
      if (r < m && colok) X[(size_t)r * ldx + col] = Xs[tr + ROWS * q][tc];
    }
    __syncthreads();  // the panel is in X before the next one reads it
  }
}

template <typename T, bool PREDICT>
__global__ void __launch_bounds__(THREADS) solve_kernel(Args<T> a) {
  __shared__ T Ls[PR][PR + 1];
  __shared__ T Xs[PR][CT + 1];
  __shared__ T red[3][ROWS][CT];

  const int s = blockIdx.y;
  const int c0 = blockIdx.x * CT;
  const int m = a.m, d = a.d;
  const int tid = threadIdx.x;
  const int tc = tid % CT, tr = tid / CT;
  const T* L = a.fac + (size_t)s * m * m;
  T* wls = a.wls + (size_t)s * m * (m + 1);
  const int ldx = PREDICT ? a.n : m + 1;
  const int ncols = ldx;
  T* X = PREDICT ? a.work + (size_t)s * m * a.n : wls;

  // right-hand sides of this block's columns
  if (PREDICT) {
    const T* ls = a.ls + (size_t)s * d;
    const T os = a.os[s];
    for (int e = tid; e < m * CT; e += THREADS) {
      const int r = e / CT, c = c0 + e % CT;
      if (c < ncols) X[(size_t)r * ldx + c] = rbf<T>(a.z + (size_t)r * d, a.x + (size_t)c * d, ls, os, d);
    }
  } else {
    const T* lsc = a.ls_chol + (size_t)s * m * m;
    const T* mean = a.mean + (size_t)s * m;
    for (int e = tid; e < m * CT; e += THREADS) {
      const int r = e / CT, c = c0 + e % CT;
      if (c < m) X[(size_t)r * ldx + c] = c <= r ? lsc[(size_t)r * m + c] : T(0);
      else if (c == m) X[(size_t)r * ldx + c] = mean[r];
    }
  }
  __syncthreads();
  forward_substitute<T>(L, X, m, ldx, c0, ncols, Ls, Xs);
  if (!PREDICT) return;

  // mu = W^T w_m and colsum(W^2): rows r = tr (mod ROWS) per thread
  const int col = c0 + tc;
  const bool colok = col < ncols;
  T pm = T(0), p1 = T(0), p2 = T(0);
  if (colok) {
    for (int r = tr; r < m; r += ROWS) {
      const T w = X[(size_t)r * ldx + col];
      pm = Num<T>::fma(wls[(size_t)r * (m + 1) + m], w, pm);
      p1 = Num<T>::fma(w, w, p1);
    }
  }
  // colsum((W_ls^T W)^2): W_ls is lower, so row i of W_ls^T W sums r >= i
  for (int i0 = 0; i0 < m; i0 += PR) {
    T acc[PR / ROWS];
#pragma unroll
    for (int q = 0; q < PR / ROWS; ++q) acc[q] = T(0);
    for (int r0 = i0; r0 < m; r0 += PR) {
      for (int e = tid; e < PR * PR; e += THREADS) {
        const int k = e / PR, i = e % PR;
        Ls[k][i] = (r0 + k < m && i0 + i < m) ? wls[(size_t)(r0 + k) * (m + 1) + i0 + i] : T(0);
      }
      for (int e = tid; e < PR * CT; e += THREADS) {
        const int k = e / CT, c = e % CT;
        Xs[k][c] = (r0 + k < m && c0 + c < ncols) ? X[(size_t)(r0 + k) * ldx + c0 + c] : T(0);
      }
      __syncthreads();
#pragma unroll 8
      for (int k = 0; k < PR; ++k) {
        const T xv = Xs[k][tc];
#pragma unroll
        for (int q = 0; q < PR / ROWS; ++q)
          acc[q] = Num<T>::fma(Ls[k][tr + ROWS * q], xv, acc[q]);
      }
      __syncthreads();
    }
#pragma unroll
    for (int q = 0; q < PR / ROWS; ++q) p2 = Num<T>::fma(acc[q], acc[q], p2);
  }
  red[0][tr][tc] = pm;
  red[1][tr][tc] = p1;
  red[2][tr][tc] = p2;
  __syncthreads();
  if (tid < CT && c0 + tid < ncols) {
    T sm = T(0), s1 = T(0), s2 = T(0);
#pragma unroll
    for (int g = 0; g < ROWS; ++g) {
      sm += red[0][g][tid];
      s1 += red[1][g][tid];
      s2 += red[2][g][tid];
    }
    const size_t o = (size_t)s * a.n + c0 + tid;
    a.mu[o] = sm;
    a.var[o] = tmax(T(1e-12), a.os[s] - s1 + s2);  // a NaN variance stays NaN
  }
}

template <typename T>
int launch(const Args<T>& a, int csize, int resident, int smem, void* stream) {
  if (a.batch <= 0 || a.m <= 0 || a.n <= 0 || a.d <= 0 || a.batch > 65535 ||
      smem < smem_bytes<T>(a.m, csize, resident))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int ret =
      resident ? launch_cluster(gram_factor_kernel<T, true>, a.batch * csize, csize, smem, st, a)
               : launch_cluster(gram_factor_kernel<T, false>, a.batch * csize, csize, smem, st, a);
  if (ret != 0) return ret;
  solve_kernel<T, false><<<dim3((a.m + 1 + CT - 1) / CT, a.batch), THREADS, 0, st>>>(a);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  solve_kernel<T, true><<<dim3((a.n + CT - 1) / CT, a.batch), THREADS, 0, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int entry(const T* z, const T* x, const T* mean, const T* ls_chol, const T* ls, const T* os,
          const T* jitter, T* fac, T* wls, T* work, T* mu, T* var, int batch, int m, int n,
          int d, int csize, int resident, int smem, void* stream) {
  Args<T> a{z, x, mean, ls_chol, ls, os, jitter, fac, wls, work, mu, var, batch, m, n, d};
  return launch<T>(a, csize, resident, smem, stream);
}

}  // namespace

extern "C" {

// z (m, d), x (n, d), mean (batch, m), ls_chol (batch, m, m), ls (batch, d),
// os (batch,), jitter (batch,): inputs, row-major and contiguous.
// fac (batch, m, m), wls (batch, m, m+1), work (batch, m, n): scratch.
// mu, var (batch, n): outputs. csize, resident, smem: K1's plan for m
// (linalg/chol.py::plan), used by the Gram + factor launch. Launches the
// three kernels on `stream` and returns the first CUDA launch error (0 = ok),
// or -2 when the card cannot hold one cluster of the plan.
int mobocmf_fused_svgp_f32(const float* z, const float* x, const float* mean,
                           const float* ls_chol, const float* ls, const float* os,
                           const float* jitter, float* fac, float* wls, float* work, float* mu,
                           float* var, int batch, int m, int n, int d, int csize,
                           int resident, int smem, void* stream) {
  return entry<float>(z, x, mean, ls_chol, ls, os, jitter, fac, wls, work, mu, var, batch, m, n,
                      d, csize, resident, smem, stream);
}

int mobocmf_fused_svgp_f64(const double* z, const double* x, const double* mean,
                           const double* ls_chol, const double* ls, const double* os,
                           const double* jitter, double* fac, double* wls, double* work,
                           double* mu, double* var, int batch, int m, int n, int d,
                           int csize, int resident, int smem, void* stream) {
  return entry<double>(z, x, mean, ls_chol, ls, os, jitter, fac, wls, work, mu, var, batch, m,
                       n, d, csize, resident, smem, stream);
}

}  // extern "C"
