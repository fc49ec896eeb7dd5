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
// What bounds it on this card. The function needs about M^3/3 + 2 M^2 N
// flops per state against a few words per flop, so the roofline says
// operations; but at the main path's shapes (M = 128..512, N = 200..1000,
// B = 3..8) the work is spread over a few hundred blocks at most and every
// one of them runs at once on the 132 SMs: the time is the longest
// block's serial chain of dependent panel steps, each a latency of shared
// memory and L2 round trips and barriers, not the FMA rate.
//
// Design: three launches on the caller's stream.
//   1. gram_factor_kernel, one cluster per state under K1's plan for M:
//      the Gram's lower triangle staged straight into the factor's storage
//      (the cluster's shared memory where it fits, else the scratch
//      factor), K1's cluster factorization (chol_factor.cuh) with no
//      ladder, and L written to the scratch factor.
//   2. solve_kernel<false>: W_ls | w_m = L^{-1} [L_S | m]. One block per
//      (stripe of W columns, state). L^{-1} L_S is lower triangular, so
//      the stripe of columns [c0, c0 + W) starts at panel c0 / 32 and the
//      rows above it are never solved, written or read; the last stripe
//      holds the m column and walks every panel (it runs first).
//   3. solve_kernel<true>: one block per (stripe of W columns of x, state):
//      K_zx built in the block, the same solve, then mu = W^T w_m and
//      colsum(W^2) from the resident stripe, and colsum((W_ls^T W)^2) with
//      each warp owning whole 32-row blocks i0 of W_ls^T W (i0 paired with
//      J - 1 - i0 so the warps' work is even), reading W_ls from L2 and W
//      from shared memory, no block barrier inside; writes mu and var. It
//      is a programmatic dependent launch of launch 2: its blocks start
//      once launch 2's have all started, build and solve their stripes
//      beside launch 2's, and wait for launch 2 to finish only before the
//      reductions read W_ls and w_m.
// The solve (both launches) keeps the block's stripe, all M rows by W
// columns, in dynamic shared memory from its right-hand side to its
// outputs, and runs right-looking by 32-row panels p:
//   X[p] <- L[p, p]^{-1} X[p]     forward substitution, lanes as rows, each
//                                 warp's columns as independent chains
//   X[below p] -= L[below p, p] X[p]   each row by one thread group, its 32
//                                      entries of L in registers
// so a stripe's serial chain is one 32-step substitution and one short
// update per panel, between two barriers. L's rows stream from L2 straight
// into registers, the next row's loads in flight during this row's FMAs,
// and the next diagonal block is copied (cp.async) into shared memory
// during the update. The stripe width W (32, 16, 8 or 4, one for both
// solves) and its shared memory are the wrapper's plan
// (linalg/fused_svgp.py::plan), checked here; each grid is (columns / W,
// B). FMA in the working type, no tensor cores (no TF32), no library calls.
//
// The TPU kernel multiplies by the inverse of each diagonal block
// (_tri_lower_inverse_block). That was measured here and not kept: the
// inverse carries error in proportion to the block's condition, and on the
// card an f64 state with jitter 2e-6 came out 2.0e-9 off the plain route,
// where the substitution stays within 1e-9.

#include <cuda_pipeline.h>

#include "chol_factor.cuh"

namespace {

using namespace mobocmf;

constexpr int PANEL = NB;  // rows per panel of the solve
constexpr int WARPS = THREADS / 32;
// shared memory a block may use on an H100 (opt-in limit)
constexpr int SMEM_LIMIT = 232448;

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
  T* mu;             // (B, N)
  T* var;            // (B, N)
  int batch, m, n, d;
};

// Dynamic shared memory of one solve block: the stripe and one diagonal
// block (after the solve, the reduction slots).
template <typename T>
__host__ __device__ inline long solve_smem_bytes(int m, int width) {
  return (long)sizeof(T) * ((long)m * width + NB * LDS);
}

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

// K contiguous values of T from shared memory at p, in 16-byte loads; p is
// aligned to the load.
template <typename T, int K>
__device__ __forceinline__ void ld_vec(const T* p, T* v) {
  using V = typename Vec16<T>::type;
  constexpr int P = 16 / sizeof(T);
  static_assert(K % P == 0, "whole 16-byte loads");
#pragma unroll
  for (int i = 0; i < K / P; ++i) unpack(reinterpret_cast<const V*>(p)[i], v + i * P);
}

// The 32 entries of L at src (a row of a column panel) into registers l:
// 16-byte loads where L's rows are 16-byte aligned (vec), else one by one.
template <typename T>
__device__ __forceinline__ void load_row(const T* src, bool vec, T* l) {
  using V = typename Vec16<T>::type;
  constexpr int P = 16 / sizeof(T);
  if (vec) {
#pragma unroll
    for (int i = 0; i < PANEL / P; ++i)
      unpack(__ldg(reinterpret_cast<const V*>(src) + i), l + i * P);
  } else {
#pragma unroll
    for (int k = 0; k < PANEL; ++k) l[k] = __ldg(src + k);
  }
}

// Start the copies of the lower triangle of panel p's diagonal block of L
// into D (stride LDS) and commit them.
template <typename T>
__device__ __forceinline__ void fetch_diag(const T* L, int m, int p, T* D) {
  const int p0 = p * PANEL;
  for (int e = threadIdx.x; e < TILE_WORDS; e += THREADS) {
    const int i = e / NB, k = e % NB;
    if (p0 + i < m && k <= i)
      __pipeline_memcpy_async(D + i * LDS + k, L + (size_t)(p0 + i) * m + p0 + k, sizeof(T));
  }
  __pipeline_commit();
}

// One step k of the substitution: row k of the panel is final up to its
// pivot; the rows below it take its product with column k of the block
// scaled by the reciprocal pivot (L[i, k] / L[k, k], formed off the
// chain, so a step on the chain is one shuffle and one FMA).
template <typename T, int CPW>
__device__ __forceinline__ void subst_step(T* v, const T* D, T rl, int lane, int k) {
  const T lk = D[lane * LDS + k] * __shfl_sync(FULL, rl, k);
#pragma unroll
  for (int j = 0; j < CPW; ++j) {
    const T yk = __shfl_sync(FULL, v[j], k);
    if (lane > k) v[j] = Num<T>::fma(-lk, yk, v[j]);
  }
}

// X[p0 : p0 + pb] <- L[p, p]^{-1} X[p0 : p0 + pb] for the stripe X (M x W
// in shared memory), D = L's diagonal block: forward substitution with
// lanes as rows and each warp's columns (warp, warp + 8, ...) as
// independent chains, each row scaled by its reciprocal pivot at the end.
// A warp reads and writes only its own columns, so no block barrier.
template <typename T, int W>
__device__ __forceinline__ void triangle(T* X, const T* D, int p0, int pb) {
  constexpr int CPW = (W + WARPS - 1) / WARPS;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  T v[CPW];
#pragma unroll
  for (int j = 0; j < CPW; ++j) {
    const int c = warp + WARPS * j;
    v[j] = c < W && lane < pb ? X[(p0 + lane) * W + c] : T(0);
  }
  const T rl = lane < pb ? T(1) / D[lane * LDS + lane] : T(0);
  if (pb == PANEL) {
#pragma unroll
    for (int k = 0; k < PANEL; ++k) subst_step<T, CPW>(v, D, rl, lane, k);
  } else {
    for (int k = 0; k < pb; ++k) subst_step<T, CPW>(v, D, rl, lane, k);
  }
#pragma unroll
  for (int j = 0; j < CPW; ++j) v[j] *= rl;
#pragma unroll
  for (int j = 0; j < CPW; ++j) {
    const int c = warp + WARPS * j;
    if (c < W && lane < pb) X[(p0 + lane) * W + c] = v[j];
  }
}

// The stripe X (M x W, shared memory) <- L^{-1} X from panel p_first on
// (the rows above it are zero and stay so), right-looking. Per panel p:
// the triangle, a barrier, then every row r below the panel takes
// X[r] -= L[r, p] X[p], thread (tr, tc) the rows tr, tr + RT, ... and the
// TC columns tc * TC, ...; L's rows stream from L2 into registers, the
// next row's loads issued before this row's FMAs (across the panel
// boundary too), and the next diagonal block's copies run during the
// update. Two barriers a panel. D: a 32 x LDS block of shared memory.
template <typename T, int W>
__device__ void solve_stripe(T* X, T* D, const T* L, int m, int p_first) {
  constexpr int TC = W < 8 ? W : 8;
  constexpr int CT = W / TC;
  constexpr int RT = THREADS / CT;
  const int nt = (m + PANEL - 1) / PANEL;
  const int tc = threadIdx.x % CT, tr = threadIdx.x / CT;
  const bool vec = m % (16 / sizeof(T)) == 0;
  // this thread's next update row nr, below panel np (np = nt: none left)
  int np = p_first, nr = (p_first + 1) * PANEL + tr;
  if (nr >= m) np = nt;
  T nxt[PANEL];
  if (np < nt) load_row<T>(L + (size_t)nr * m + np * PANEL, vec, nxt);
  fetch_diag<T>(L, m, p_first, D);
  for (int p = p_first; p < nt; ++p) {
    const int p0 = p * PANEL;
    __pipeline_wait_prior(0);
    __syncthreads();  // the block and the panel's rows are up to date
    triangle<T, W>(X, D, p0, min(PANEL, m - p0));
    __syncthreads();  // X[p] is final and D is free
    if (p + 1 < nt) fetch_diag<T>(L, m, p + 1, D);
    while (np == p) {
      T cur[PANEL];
#pragma unroll
      for (int k = 0; k < PANEL; ++k) cur[k] = nxt[k];
      const int r = nr;
      nr += RT;
      if (nr >= m) {
        ++np;
        nr = (np + 1) * PANEL + tr;
        if (nr >= m) np = nt;
      }
      if (np < nt) load_row<T>(L + (size_t)nr * m + np * PANEL, vec, nxt);
      T acc[TC];
      ld_vec<T, TC>(X + r * W + tc * TC, acc);
#pragma unroll
      for (int k = 0; k < PANEL; ++k) {
        T xv[TC];
        ld_vec<T, TC>(X + (p0 + k) * W + tc * TC, xv);
#pragma unroll
        for (int j = 0; j < TC; ++j) acc[j] = Num<T>::fma(-cur[k], xv[j], acc[j]);
      }
#pragma unroll
      for (int j = 0; j < TC; ++j) X[r * W + tc * TC + j] = acc[j];
    }
  }
  __syncthreads();
}

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

// Rows r .. r + U of column col of W_ls (zero past m) into av.
template <typename T, int U>
__device__ __forceinline__ void load_wls(const T* wls, int m, int r, int col, T* av) {
#pragma unroll
  for (int u = 0; u < U; ++u)
    av[u] = r + u < m && col < m ? wls[(size_t)(r + u) * (m + 1) + col] : T(0);
}

template <typename T, int W, bool PREDICT>
__global__ void __launch_bounds__(THREADS) solve_kernel(Args<T> a) {
  extern __shared__ __align__(16) unsigned char smem[];
  if (!PREDICT) asm volatile("griddepcontrol.launch_dependents;");
  const int s = blockIdx.y, m = a.m, tid = threadIdx.x;
  const int nt = (m + PANEL - 1) / PANEL;
  const int ncols = PREDICT ? a.n : m + 1;
  // launch 2 runs its last stripe (the m column, every panel) first
  int stripe = blockIdx.x;
  if (!PREDICT) stripe = blockIdx.x == 0 ? gridDim.x - 1 : blockIdx.x - 1;
  const int c0 = stripe * W;
  const int p_first = PREDICT || c0 + W > m ? 0 : c0 / PANEL;
  T* X = reinterpret_cast<T*>(smem);
  T* D = X + (size_t)m * W;
  const T* L = a.fac + (size_t)s * m * m;

  if (PREDICT) {
    const T* ls = a.ls + (size_t)s * a.d;
    const T os = a.os[s];
    for (int e = tid; e < m * W; e += THREADS) {
      const int r = e / W, col = c0 + e % W;
      X[e] = col < ncols ? rbf<T>(a.z + (size_t)r * a.d, a.x + (size_t)col * a.d, ls, os, a.d)
                         : T(0);
    }
  } else {
    const T* lsc = a.ls_chol + (size_t)s * m * m;
    for (int e = p_first * PANEL * W + tid; e < m * W; e += THREADS) {
      const int r = e / W, col = c0 + e % W;
      X[e] = col < m ? (col <= r ? lsc[(size_t)r * m + col] : T(0))
                     : (col == m ? a.mean[(size_t)s * m + r] : T(0));
    }
  }
  solve_stripe<T, W>(X, D, L, m, p_first);

  T* wls = a.wls + (size_t)s * m * (m + 1);
  if (!PREDICT) {
    for (int e = p_first * PANEL * W + tid; e < m * W; e += THREADS) {
      const int r = e / W, col = c0 + e % W;
      if (col <= m) wls[(size_t)r * (m + 1) + col] = X[e];
    }
    return;
  }
  // launch 3 ran its solve beside launch 2 (programmatic dependent
  // launch); W_ls and w_m are read only after launch 2 has finished
  asm volatile("griddepcontrol.wait;" ::: "memory");

  // mu = W^T w_m and colsum(W^2): thread (g, c) sums rows g, g + G, ...
  constexpr int G = THREADS / W;
  const int c = tid % W, g = tid / W;
  T pm = T(0), p1 = T(0);
  for (int r = g; r < m; r += G) {
    const T w = X[r * W + c];
    pm = Num<T>::fma(wls[(size_t)r * (m + 1) + m], w, pm);
    p1 = Num<T>::fma(w, w, p1);
  }
  // colsum((W_ls^T W)^2): row block i0 of W_ls^T W (rows i0*32 + lane)
  // sums rows r >= i0*32 of W_ls (lower triangular); warp w takes the
  // pairs (i0, nt - 1 - i0) for i0 = w, w + WARPS, ...; W_ls streams from
  // L2 U rows ahead of the FMAs; lane c < W keeps column c's share
  constexpr int U = 16;
  const int lane = tid % 32, warp = tid / 32;
  T p2 = T(0);
  for (int pair = warp; pair < (nt + 1) / 2; pair += WARPS) {
    for (int h = 0; h < 2; ++h) {
      const int i0 = h == 0 ? pair : nt - 1 - pair;
      if (h == 1 && i0 == pair) break;
      const int col = i0 * PANEL + lane;
      T acc[W], av[U];
#pragma unroll
      for (int j = 0; j < W; ++j) acc[j] = T(0);
      load_wls<T, U>(wls, m, i0 * PANEL, col, av);
      for (int r = i0 * PANEL; r < m; r += U) {
        T an[U];
        load_wls<T, U>(wls, m, r + U, col, an);
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const T* xr = X + min(r + u, m - 1) * W;  // av is 0 past m
#pragma unroll
          for (int j0 = 0; j0 < W; j0 += 4) {
            T xv[4];
            ld_vec<T, 4>(xr + j0, xv);
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[j0 + j] = Num<T>::fma(av[u], xv[j], acc[j0 + j]);
          }
        }
#pragma unroll
        for (int u = 0; u < U; ++u) av[u] = an[u];
      }
#pragma unroll
      for (int j = 0; j < W; ++j) {
        const T sq = warp_sum(acc[j] * acc[j]);
        if (lane == j) p2 += sq;
      }
    }
  }
  T* red = D;  // the diagonal block's buffer is free after the solve
  red[tid] = pm;
  red[THREADS + tid] = p1;
  if (lane < W) red[2 * THREADS + warp * W + lane] = p2;
  __syncthreads();
  if (tid < W && c0 + tid < ncols) {
    T sm = T(0), s1 = T(0), s2 = T(0);
    for (int q = 0; q < G; ++q) {
      sm += red[q * W + tid];
      s1 += red[THREADS + q * W + tid];
    }
#pragma unroll
    for (int q = 0; q < WARPS; ++q) s2 += red[2 * THREADS + q * W + tid];
    const size_t o = (size_t)s * a.n + c0 + tid;
    a.mu[o] = sm;
    a.var[o] = tmax(T(1e-12), a.os[s] - s1 + s2);  // a NaN variance stays NaN
  }
}

template <typename T, int W, bool PREDICT>
int launch_solve(const Args<T>& a, int smem, cudaStream_t st) {
  auto kern = solve_kernel<T, W, PREDICT>;
  // the opt-in shared memory, once per instantiation
  static cudaError_t attr =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_LIMIT);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int cols = PREDICT ? a.n : a.m + 1;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attrs[1];
  attrs[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attrs[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.gridDim = dim3((cols + W - 1) / W, a.batch);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cfg.attrs = attrs;
  cfg.numAttrs = PREDICT ? 1 : 0;  // the predictive may start during the [L_S | m] solve
  cudaError_t err = cudaLaunchKernelEx(&cfg, kern, a);
  if (err == cudaSuccess) err = cudaGetLastError();
  return static_cast<int>(err);
}

template <typename T, bool PREDICT>
int launch_width(const Args<T>& a, int width, int smem, cudaStream_t st) {
  switch (width) {
    case 32: return launch_solve<T, 32, PREDICT>(a, smem, st);
    case 16: return launch_solve<T, 16, PREDICT>(a, smem, st);
    case 8: return launch_solve<T, 8, PREDICT>(a, smem, st);
    case 4: return launch_solve<T, 4, PREDICT>(a, smem, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
bool solve_plan_ok(int m, int width, int smem) {
  return (width == 32 || width == 16 || width == 8 || width == 4) && smem <= SMEM_LIMIT &&
         smem >= solve_smem_bytes<T>(m, width);
}

template <typename T>
int launch(const Args<T>& a, int csize, int resident, int smem, int width, int smem_solve,
           void* stream) {
  if (a.batch <= 0 || a.m <= 0 || a.n <= 0 || a.d <= 0 || a.batch > 65535 ||
      smem < smem_bytes<T>(a.m, csize, resident) || !solve_plan_ok<T>(a.m, width, smem_solve))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int ret =
      resident ? launch_cluster(gram_factor_kernel<T, true>, a.batch * csize, csize, smem, st, a)
               : launch_cluster(gram_factor_kernel<T, false>, a.batch * csize, csize, smem, st, a);
  if (ret != 0) return ret;
  ret = launch_width<T, false>(a, width, smem_solve, st);
  if (ret != 0) return ret;
  return launch_width<T, true>(a, width, smem_solve, st);
}

template <typename T>
int entry(const T* z, const T* x, const T* mean, const T* ls_chol, const T* ls, const T* os,
          const T* jitter, T* fac, T* wls, T* mu, T* var, int batch, int m, int n, int d,
          int csize, int resident, int smem, int width, int smem_solve, void* stream) {
  Args<T> a{z, x, mean, ls_chol, ls, os, jitter, fac, wls, mu, var, batch, m, n, d};
  return launch<T>(a, csize, resident, smem, width, smem_solve, stream);
}

}  // namespace

extern "C" {

// z (m, d), x (n, d), mean (batch, m), ls_chol (batch, m, m), ls (batch, d),
// os (batch,), jitter (batch,): inputs, row-major and contiguous.
// fac (batch, m, m), wls (batch, m, m+1): scratch. mu, var (batch, n):
// outputs. csize, resident, smem: K1's plan for m (linalg/chol.py::plan),
// used by the Gram + factor launch. width, smem_solve: the stripe width and
// dynamic shared memory of both solves (linalg/fused_svgp.py::plan).
// Launches the three kernels on `stream` and returns the first CUDA launch
// error (0 = ok), cudaErrorInvalidValue for a plan that cannot launch, or
// -2 when the card cannot hold one cluster of the factor's plan.
int mobocmf_fused_svgp_f32(const float* z, const float* x, const float* mean,
                           const float* ls_chol, const float* ls, const float* os,
                           const float* jitter, float* fac, float* wls, float* mu, float* var,
                           int batch, int m, int n, int d, int csize, int resident, int smem,
                           int width, int smem_solve, void* stream) {
  return entry<float>(z, x, mean, ls_chol, ls, os, jitter, fac, wls, mu, var, batch, m, n, d,
                      csize, resident, smem, width, smem_solve, stream);
}

int mobocmf_fused_svgp_f64(const double* z, const double* x, const double* mean,
                           const double* ls_chol, const double* ls, const double* os,
                           const double* jitter, double* fac, double* wls, double* mu,
                           double* var, int batch, int m, int n, int d, int csize, int resident,
                           int smem, int width, int smem_solve, void* stream) {
  return entry<double>(z, x, mean, ls_chol, ls, os, jitter, fac, wls, mu, var, batch, m, n, d,
                       csize, resident, smem, width, smem_solve, stream);
}

}  // extern "C"
