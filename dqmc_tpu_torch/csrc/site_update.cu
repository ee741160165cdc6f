// #3 and #6: the per-slice engine's Metropolis site loops.
//
// Replaces: dqmc_tpu/ops/kernels.py::_batched_update_kernel (#3, the
// walker-batched delayed rank-k loop with a shared visit order, reached
// through _metropolis_batched_impl) and ::_update_kernel (#6, one walker's
// rank-1 Sherman-Morrison loop in its own order, metropolis_slice_update).
// On the TPU each ran a whole slice as one VMEM-resident program.
//
//   delayed_sites_kernel   k consecutive visits of one slice, one CTA per
//                          walker: each visit forms the effective row and
//                          column of G under the pending rank-k terms,
//                          decides u < R with R = gb (1 + (1 - G_ii) delta)^2
//                          and writes one slot of the U/V buffers (global
//                          memory) and the per-visit accept flag.
//   rank_k_flush_kernel    (rank_k_flush.cuh) G += U^T V over many CTAs,
//                          launched after each group of k visits.
//   rank1_sites_kernel     #6: a whole slice, one CTA per walker; an
//                          accepted visit applies its rank-1 update to G
//                          inside the CTA.
//
// The field-dependent factors gb = gamma ratio * boson ratio and
// delta = exp(g d_eta) - 1 of every visit are computed by the host before
// the slice (ops/kernels.py visit_factors): each site is visited once per
// slice, so its pre-update field is the slice-start field.  The host also
// turns the accept flags into the new fields.  The order has a stride: 0
// for the shared order of #3, n for per-walker orders.
//
// What bounds it on an H100: the visits of a slice are a chain of n
// dependent steps, so one walker is one CTA on one SM (W of 132 SMs
// busy).  At the stretch shape (n = 1024, k = 32) the U and V buffers are
// 2 k n = 256 KB in f32, more than a CTA's 227 KB of shared memory, and a
// visit reads on average k n of them: the site loop is bound by its L2
// reads, and the flushes (2 k n^2 FLOPs each, 2 n^3 per slice) by FP32
// throughput.  G (4 MB per walker) lives in global memory and L2.
//
// What the design does about it: U and V stay in global memory (L2
// resident; 256 KB per walker); a visit stages the 2 t coefficients of the
// visited column through shared memory and each thread streams its own two
// columns of U and V coalesced.  The flush leaves the sequential kernel and
// runs as a tiled kernel over (tiles x walkers) CTAs, so it uses the whole
// card; the launch order on the stream keeps the chain sequential.  Columns
// of G are read strided (no G^T copy).  Plain FP32/FP64 FMA.

#include <cuda_runtime.h>

#include "rank_k_flush.cuh"

namespace {

constexpr int SITE_THREADS = 512;
constexpr int SITE_COLS = 2;  // columns per thread: n <= 1024
constexpr int KMAX = dqmc::FLUSH_KMAX;

template <typename T>
__global__ void __launch_bounds__(SITE_THREADS)
delayed_sites_kernel(const T* __restrict__ G, T* U, T* V, T* __restrict__ acc,
                     const int* __restrict__ order, long long s_order,
                     const T* __restrict__ gb, const T* __restrict__ delta,
                     const T* __restrict__ us, long long s_uv, int n, int v0,
                     int cnt) {
  __shared__ T ucol[KMAX];  // U[s][i]: the visited column of the pending U
  __shared__ T vcol[KMAX];  // V[s][i]
  const int w = blockIdx.x, tid = threadIdx.x, nthr = blockDim.x;
  G += (long long)w * n * n;
  U += w * s_uv;
  V += w * s_uv;
  order += w * s_order;
  const long long ws = (long long)w * n;
  gb += ws;
  delta += ws;
  us += ws;
  acc += ws;

  for (int t = 0; t < cnt; ++t) {
    const int idx = v0 + t;
    const int i = order[idx];
    if (tid < t) {
      ucol[tid] = U[(long long)tid * n + i];
      vcol[tid] = V[(long long)tid * n + i];
    }
    __syncthreads();
    // every thread forms the effective G_ii and the same decision
    T gii = G[(long long)i * n + i];
    for (int s = 0; s < t; ++s) gii += ucol[s] * vcol[s];
    const T d = delta[idx];
    const T rf = T(1) + (T(1) - gii) * d;
    const T R = gb[idx] * rf * rf;  // >= 0: gb > 0 times a square
    const bool accept = us[idx] < R;
    const T prefac = accept ? d / rf : T(0);
#pragma unroll
    for (int c = 0; c < SITE_COLS; ++c) {
      const int j = tid + c * nthr;
      if (j < n) {
        T row = G[(long long)i * n + j];
        T col = G[(long long)j * n + i];
#pragma unroll 4
        for (int s = 0; s < t; ++s) {
          row += ucol[s] * V[(long long)s * n + j];
          col += vcol[s] * U[(long long)s * n + j];
        }
        U[(long long)t * n + j] = prefac * col;
        V[(long long)t * n + j] = row - (j == i ? T(1) : T(0));
      }
    }
    if (tid == 0) acc[idx] = accept ? T(1) : T(0);
    __syncthreads();
  }
}

// #6: one walker's slice, rank-1 update per accepted visit.
template <typename T>
__global__ void rank1_sites_kernel(T* G, T* __restrict__ acc,
                                   const int* __restrict__ order,
                                   long long s_order,
                                   const T* __restrict__ gb,
                                   const T* __restrict__ delta,
                                   const T* __restrict__ us, int n) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* col = reinterpret_cast<T*>(smem_raw);  // prefac * G[:, i]
  T* row = col + n;                         // G[i, :] - e_i
  const int w = blockIdx.x, tid = threadIdx.x, nthr = blockDim.x;
  G += (long long)w * n * n;
  order += w * s_order;
  const long long ws = (long long)w * n;
  gb += ws;
  delta += ws;
  us += ws;
  acc += ws;

  for (int idx = 0; idx < n; ++idx) {
    const int i = order[idx];
    const T gii = G[(long long)i * n + i];
    const T d = delta[idx];
    const T rf = T(1) + (T(1) - gii) * d;
    const bool accept = us[idx] < gb[idx] * rf * rf;
    if (tid == 0) acc[idx] = accept ? T(1) : T(0);
    if (!accept) continue;  // the same branch in every thread
    const T prefac = d / rf;
    for (int j = tid; j < n; j += nthr) {
      col[j] = prefac * G[(long long)j * n + i];
      row[j] = G[(long long)i * n + j] - (j == i ? T(1) : T(0));
    }
    __syncthreads();
    for (long long e = tid; e < (long long)n * n; e += nthr) {
      const int a = (int)(e / n), b = (int)(e - (long long)a * n);
      G[e] += col[a] * row[b];
    }
    __syncthreads();
  }
}

template <typename T>
int launch_delayed_sites(const T* G, T* U, T* V, T* acc, const int* order,
                         long long s_order, const T* gb, const T* delta,
                         const T* us, long long s_uv, int n, int v0, int cnt,
                         int batch, void* stream) {
  if (n <= 0 || n > SITE_THREADS * SITE_COLS || cnt <= 0 || cnt > KMAX ||
      v0 < 0 || v0 + cnt > n || batch <= 0)
    return (int)cudaErrorInvalidValue;
  const int threads = n >= SITE_THREADS ? SITE_THREADS : (n + 31) / 32 * 32;
  delayed_sites_kernel<T><<<batch, threads, 0, (cudaStream_t)stream>>>(
      G, U, V, acc, order, s_order, gb, delta, us, s_uv, n, v0, cnt);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_rank1_sites(T* G, T* acc, const int* order, long long s_order,
                       const T* gb, const T* delta, const T* us, int n,
                       int batch, void* stream) {
  // 2 n elements of shared memory: 16 KB in f64 at n = 1024
  if (n <= 0 || n > 1024 || batch <= 0) return (int)cudaErrorInvalidValue;
  const int threads = (n + 31) / 32 * 32;
  const size_t smem = 2 * sizeof(T) * (size_t)n;
  rank1_sites_kernel<T><<<batch, threads, smem, (cudaStream_t)stream>>>(
      G, acc, order, s_order, gb, delta, us, n);
  return (int)cudaGetLastError();
}

}  // namespace

#define DQMC_SITE_API(T, SFX)                                                \
  extern "C" int dqmc_delayed_sites##SFX(                                    \
      const T* G, T* U, T* V, T* acc, const int* order, long long s_order,   \
      const T* gb, const T* delta, const T* us, long long s_uv, int n,       \
      int v0, int cnt, int batch, void* stream) {                            \
    return launch_delayed_sites<T>(G, U, V, acc, order, s_order, gb, delta,  \
                                   us, s_uv, n, v0, cnt, batch, stream);     \
  }                                                                          \
  extern "C" int dqmc_delayed_flush##SFX(T* G, const T* U, const T* V,       \
                                         long long s_uv, int n, int k,       \
                                         int batch, void* stream) {          \
    return dqmc::launch_rank_k_flush<T>(G, U, V, s_uv, n, k, batch, stream); \
  }                                                                          \
  extern "C" int dqmc_rank1_sites##SFX(                                      \
      T* G, T* acc, const int* order, long long s_order, const T* gb,        \
      const T* delta, const T* us, int n, int batch, void* stream) {         \
    return launch_rank1_sites<T>(G, acc, order, s_order, gb, delta, us, n,   \
                                 batch, stream);                             \
  }

DQMC_SITE_API(float, _f32)
DQMC_SITE_API(double, _f64)
