// K1: batched lower Cholesky factorization with the escalating-jitter
// ladder, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel mobocmf_tpu/linalg/chol.py::_chol_kernel
// (helpers _chol_block_unblocked, _tri_lower_inverse_block; launched by
// _pallas_cholesky) and, through the ladder, the host-side branch of
// mobocmf_tpu/linalg/ops.py::_chol_escalate / _rescue.
//
// What it computes, for every matrix b of a (B, n, n) batch:
//   j0 = ladder ? max(jitter[b], 4*eps*scale) : jitter[b]
//   L  = chol(A + j0*I)                    lower triangle of A read only
// and, with `ladder`, on a failed pivot the same matrix restarts at
//   j1 = max(100*j0, 256*eps*scale), then j2 = max(100*j1, sqrt(eps)*scale)
// where scale = mean |diag(A)|. Matrices that factorize keep their jitter,
// which is _rescue's per-element semantics (ops.py:60-80) without a host
// read. level[b] is the rung used (0, 1 or 2). A non-positive or
// non-finite pivot of the final attempt turns that pivot into NaN, and the
// NaN flows into every later column: the diagonal is NaN from there on,
// which is the failure signal safe_cholesky reads. The kernel never traps.
// The strict upper triangle of the output is zeroed.
//
// Design: a cluster of CLUSTER thread blocks per matrix, the working
// factor in the output buffer in global memory (L2-resident at these
// sizes: a 512x512 f32 matrix is 1 MB), right-looking with 32-wide column
// panels; the device code is in chol_factor.cuh (shared with K2).
// Bound: n^3/3 flops per matrix against n^2 words read and written — the
// work is compute-bound at any n >= 512 on this card; one cluster per
// matrix caps it at 8*B of the 132 SMs. wgmma/TMA tiles are later work.

#include "chol_factor.cuh"

namespace {

using namespace mobocmf;

template <typename T>
__global__ void __cluster_dims__(CLUSTER, 1, 1) __launch_bounds__(THREADS)
    chol_kernel(const T* __restrict__ a, T* out, const T* __restrict__ jitter,
                int* __restrict__ level, int n, int ladder) {
  __shared__ T D[NB][NB + 1];
  __shared__ T PA[TILE][NB + 1];
  __shared__ T PB[TILE][NB + 1];
  __shared__ T red[THREADS];
  __shared__ int failed;

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int mat = blockIdx.x / CLUSTER;
  const int tid = threadIdx.x;
  const T* A = a + (size_t)mat * n * n;
  T* L = out + (size_t)mat * n * n;

  // scale = mean |diag(A)| (every block of the cluster, identically)
  T s = T(0);
  for (int i = tid; i < n; i += THREADS) s += Num<T>::absval(A[(size_t)i * n + i]);
  red[tid] = s;
  __syncthreads();
  for (int w = THREADS / 2; w > 0; w >>= 1) {
    if (tid < w) red[tid] += red[tid + w];
    __syncthreads();
  }
  const T scale = red[0] / T(n);
  const T eps = Num<T>::eps;

  T jit = jitter[mat];
  if (ladder) jit = tmax(jit, T(4) * eps * scale);
  const int attempts = ladder ? 3 : 1;
  for (int att = 0; att < attempts; ++att) {
    if (att == 1) jit = tmax(T(100) * jit, T(256) * eps * scale);
    if (att == 2) jit = tmax(T(100) * jit, Num<T>::root(eps) * scale);
    const bool last = att == attempts - 1;
    cluster_sync(cluster);  // no block still reads the previous attempt
    for (int i = rank; i < n; i += CLUSTER)
      for (int j = tid; j <= i; j += THREADS)
        L[(size_t)i * n + j] = A[(size_t)i * n + j] + (i == j ? jit : T(0));
    cluster_sync(cluster);
    if (factor<T>(L, n, last, cluster, D, PA, PB, &failed) || last) {
      if (rank == 0 && tid == 0) level[mat] = att;
      break;
    }
  }

  zero_upper<T>(L, n, rank);
}

template <typename T>
int launch(const T* a, T* out, const T* jitter, int* level, int batch, int n, int ladder,
           void* stream) {
  if (batch <= 0 || n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  chol_kernel<T><<<batch * CLUSTER, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      a, out, jitter, level, n, ladder);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// a, out: (batch, n, n) row-major; jitter: (batch,); level: (batch,) int32.
// Launches on `stream` and returns the CUDA error of the launch (0 = ok).
int mobocmf_chol_f32(const float* a, float* out, const float* jitter, int* level, int batch,
                     int n, int ladder, void* stream) {
  return launch<float>(a, out, jitter, level, batch, n, ladder, stream);
}

int mobocmf_chol_f64(const double* a, double* out, const double* jitter, int* level,
                     int batch, int n, int ladder, void* stream) {
  return launch<double>(a, out, jitter, level, batch, n, ladder, stream);
}

}  // extern "C"
