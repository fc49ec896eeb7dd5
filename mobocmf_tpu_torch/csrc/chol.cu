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
// What bounds it on this card: n^3/3 flops per matrix against n^2 words
// read and written, so a perfect kernel would meet the fp32 FMA floor (no
// tensor cores: TF32 is not allowed). This one is bound by latency on the
// serial chain of n/32 panel steps: per step the 32 pivots of the diagonal
// block (a square root and a broadcast each), the panel rows' 32-step
// substitution, the depth-32 update inside the outer panel and two cluster
// barriers; one cluster per matrix caps a launch at 16*B of the 132 SMs.
// Each part of that chain costs more where one warp works while the others
// wait, where loads wait on each other, and where the trailing matrix goes
// to L2 and back (behind a __threadfence()) once per 32 columns.
//
// The design (device code in chol_factor.cuh, shared with K2), after what
// the TPU kernel did with its VMEM-resident matrix and 128-wide blocks:
//   - the diagonal block is factored by all warps of every block (rows on
//     lanes, columns dealt to warps, two pivots per barrier, at f32 the
//     pivot from a refined reciprocal square root);
//   - the panel rows are solved by forward substitution, one row per thread
//     in registers. The TPU kernel multiplied by the explicit inverse of
//     the diagonal block instead; on the card that product moved borderline
//     f32 pivots of the main path's layer-1 Kzz across zero where the
//     library's factorization does not (a different ladder rung), so the
//     solve stays a substitution, as a triangular solve does it;
//   - 32-wide inner panels inside 128-wide outer panels: the trailing
//     matrix takes one update of depth 128 per outer panel, accumulated in
//     registers, a quarter of the read-modify-write passes;
//   - where the lower triangle fits, the factor lives in the cluster's
//     shared memory (read by the other blocks over distributed shared
//     memory in 16-byte vectors) and goes to global memory once, at the
//     end; above that it stays in the output buffer (L2) with the same
//     schedule, and no fence is needed for the resident factor;
//   - 8 blocks per matrix up to n = 256, 16 (the non-portable cluster size)
//     above; linalg/chol.py::plan picks the cluster, the storage and the
//     shared memory, and the launch fails if the card cannot hold such a
//     cluster (no fallback).
// The per-step chain stays in series: no look-ahead yet.

#include "chol_factor.cuh"

namespace {

using namespace mobocmf;

// A + jitter * I, lower triangle
template <typename T>
struct Shifted {
  const T* a;
  int n;
  T jit;
  __device__ T operator()(int r, int c) const {
    return a[(size_t)r * n + c] + (r == c ? jit : T(0));
  }
};

template <typename T, bool RESIDENT>
__global__ void __launch_bounds__(THREADS)
    chol_kernel(const T* __restrict__ a, T* out, const T* __restrict__ jitter,
                int* __restrict__ level, int n, int ladder, int outer) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ T red[THREADS / 32];

  cg::cluster_group cluster = cg::this_cluster();
  const int csize = static_cast<int>(cluster.num_blocks());
  const int mat = blockIdx.x / csize;
  const int tid = threadIdx.x;
  const T* A = a + (size_t)mat * n * n;
  T* L = out + (size_t)mat * n * n;
  Work<T> w = carve<T>(smem);
  const Store<T, RESIDENT> S = make_store<T, RESIDENT>(smem, L, n, cluster);

  // scale = mean |diag(A)| (every block of the cluster, identically)
  T s = T(0);
  for (int i = tid; i < n; i += THREADS) s += Num<T>::absval(A[(size_t)i * n + i]);
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(FULL, s, o);
  if (tid % 32 == 0) red[tid / 32] = s;
  __syncthreads();
  T total = T(0);
  for (int i = 0; i < THREADS / 32; ++i) total += red[i];
  const T scale = total / T(n);
  const T eps = Num<T>::eps;

  T jit = jitter[mat];
  if (ladder) jit = tmax(jit, T(4) * eps * scale);
  const int attempts = ladder ? 3 : 1;
  for (int att = 0; att < attempts; ++att) {
    if (att == 1) jit = tmax(T(100) * jit, T(256) * eps * scale);
    if (att == 2) jit = tmax(T(100) * jit, Num<T>::root(eps) * scale);
    const bool last = att == attempts - 1;
    sync_cluster<RESIDENT>(cluster);  // no block still reads the previous attempt
    stage<T, RESIDENT>(S, csize, Shifted<T>{A, n, jit});
    if (factor<T, RESIDENT>(S, outer, last, cluster, w) || last) {
      if (S.rank == 0 && tid == 0) level[mat] = att;
      break;
    }
  }
  write_out<T, RESIDENT>(S, L, csize);
}

template <typename T>
int launch(const T* a, T* out, const T* jitter, int* level, int batch, int n, int ladder,
           int csize, int resident, int smem, int outer, void* stream) {
  if (batch <= 0 || n <= 0 || outer <= 0 || smem < smem_bytes<T>(n, csize, resident))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (resident)
    return launch_cluster(chol_kernel<T, true>, batch * csize, csize, smem, st, a, out, jitter,
                          level, n, ladder, outer);
  return launch_cluster(chol_kernel<T, false>, batch * csize, csize, smem, st, a, out, jitter,
                        level, n, ladder, outer);
}

template <typename T>
int max_clusters(int csize, int resident, int smem) {
  int active = 0;
  const cudaError_t err =
      resident ? max_active_clusters(chol_kernel<T, true>, csize, smem, &active)
               : max_active_clusters(chol_kernel<T, false>, csize, smem, &active);
  return err == cudaSuccess ? active : -static_cast<int>(err);
}

}  // namespace

extern "C" {

// a, out: (batch, n, n) row-major; jitter: (batch,); level: (batch,) int32.
// csize, resident, smem, outer: the plan (linalg/chol.py::plan): blocks per
// matrix, the factor in the cluster's shared memory (1) or in `out` (0),
// dynamic shared memory per block in bytes, tiles of 32 per outer panel.
// Launches on `stream` and returns the CUDA error of the launch (0 = ok),
// or -2 when the card cannot hold one cluster of the plan.
int mobocmf_chol_f32(const float* a, float* out, const float* jitter, int* level, int batch,
                     int n, int ladder, int csize, int resident, int smem, int outer,
                     void* stream) {
  return launch<float>(a, out, jitter, level, batch, n, ladder, csize, resident, smem, outer,
                       stream);
}

int mobocmf_chol_f64(const double* a, double* out, const double* jitter, int* level,
                     int batch, int n, int ladder, int csize, int resident, int smem, int outer,
                     void* stream) {
  return launch<double>(a, out, jitter, level, batch, n, ladder, csize, resident, smem, outer,
                        stream);
}

#ifdef MOBOCMF_CHOL_PHASES
// Copy the per-phase nanoseconds of block 0 (kPhases of them) to `host` and
// zero them on the card.
int mobocmf_chol_phases(unsigned long long* host) {
  cudaError_t err = cudaMemcpyFromSymbol(host, phase_ns, sizeof(phase_ns));
  const unsigned long long zero[kPhases] = {};
  if (err == cudaSuccess) err = cudaMemcpyToSymbol(phase_ns, zero, sizeof(phase_ns));
  return static_cast<int>(err);
}
#endif

// cudaOccupancyMaxActiveClusters for K1 under a plan (f64 when `f64`), or
// minus the CUDA error of the query.
int mobocmf_chol_max_clusters(int f64, int csize, int resident, int smem) {
  return f64 ? max_clusters<double>(csize, resident, smem)
             : max_clusters<float>(csize, resident, smem);
}

}  // extern "C"
