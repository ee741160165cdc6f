// #5: the submatrix site update of the per-slice engine.
//
// Replaces: dqmc_tpu/ops/kernels.py::_batched_submatrix_kernel (reached
// through _metropolis_batched_sub_impl), the Pallas TPU kernel that ran a
// whole slice in VMEM: per block of k candidate sites I (known in advance,
// the visit order does not depend on the state) it decided all k visits on
// the k x k submatrix G[I, I] of the block-base G through the bordered
// Woodbury inverse W = M^{-1}, M = D_P^{-1} + (I - G)[P, P] over the
// accepted subset P, then flushed G += G[:, I] W (G[I, :] - E_I).
//
//   submatrix_decide_kernel  one warp per walker: gathers G[I, I], runs the
//                            k sequential decisions on k x k data in shared
//                            memory (submatrix_decide.cuh: G_II, W and the
//                            accept mask, 9 KB at k = 32 in f32) and writes
//                            W and the accept flags.  A rejected candidate
//                            leaves W's row and column exactly zero.
//   submatrix_prep_kernel    over (column blocks x walkers) CTAs: the flush
//                            operands Ut = G[:, I]^T (strided reads, no G^T
//                            copy) and M = W (G[I, :] - E_I), both (k, n).
//   rank_k_flush_kernel      (rank_k_flush.cuh) G += Ut^T M.
//
// The factors gb and delta of each visit come from the host
// (ops/kernels.py visit_factors), as for #3.  The order has a stride: 0 for
// the shared order of the JAX kernel, n for per-walker orders (the
// submatrix scheme of engine/sweep.py).
//
// What bounds it on an H100: the decisions are O(k^2) per visit on data
// that fits in one SM's shared memory, a short latency-bound chain; the
// three flush products are 2 k n^2 + 2 k^2 n FLOPs per block, so at the
// stretch shape (n = 1024, k = 32) the slice is bound by the flush's FP32
// throughput and by the launch chain (three launches per block).
//
// What the design does about it: only the k x k decisions stay sequential,
// on one warp per walker; the operand preparation and the rank-k flush run
// over many CTAs.  The flush operands are copied out of G before the
// in-place flush, so no CTA reads a G entry another CTA is updating.
// Plain FP32/FP64 FMA, no tensor cores.

#include <cuda_runtime.h>

#include "rank_k_flush.cuh"
#include "submatrix_decide.cuh"

namespace {

constexpr int KMAX = dqmc::FLUSH_KMAX;
constexpr int PREP_THREADS = 128;

// blockDim = 32 (one warp), blockIdx.x = walker; the decisions themselves
// are submatrix_decide.cuh's, shared with the fused block's site loop.
template <typename T>
__global__ void __launch_bounds__(32)
submatrix_decide_kernel(const T* __restrict__ G, T* __restrict__ Wout,
                        T* __restrict__ acc, const int* __restrict__ order,
                        long long s_order, const T* __restrict__ gb,
                        const T* __restrict__ delta,
                        const T* __restrict__ us, int n, int k, int v0,
                        int cnt) {
  __shared__ dqmc::DecideSmem<T> sm;
  const int w = blockIdx.x, lane = threadIdx.x;
  const long long ws = (long long)w * n;
  dqmc::submatrix_decide_warp(sm, G + (long long)w * n * n, n,
                              order + w * s_order, v0, cnt, gb + ws,
                              delta + ws, us + ws, acc + ws, false, lane);
  Wout += (long long)w * k * k;
  for (int e = lane; e < cnt * cnt; e += 32)
    Wout[(e / cnt) * k + e % cnt] = sm.Wm[e / cnt][e % cnt];
}

// grid (ceil(n / PREP_THREADS), walkers); thread a fills column a of
// Ut[p][a] = G[a][I_p] and M[p][a] = sum_q W[p][q] (G[I_q][a] - [I_q == a]).
template <typename T>
__global__ void __launch_bounds__(PREP_THREADS)
submatrix_prep_kernel(const T* __restrict__ G, const T* __restrict__ Win,
                      T* __restrict__ Ut, T* __restrict__ M,
                      const int* __restrict__ order, long long s_order,
                      int n, int k, int v0, int cnt) {
  __shared__ T Ws[KMAX][KMAX];
  __shared__ int I[KMAX];
  const int w = blockIdx.y, tid = threadIdx.x;
  G += (long long)w * n * n;
  Win += (long long)w * k * k;
  Ut += (long long)w * k * n;
  M += (long long)w * k * n;
  order += w * s_order;
  for (int e = tid; e < cnt * cnt; e += PREP_THREADS)
    Ws[e / cnt][e % cnt] = Win[(e / cnt) * k + e % cnt];
  if (tid < cnt) I[tid] = order[v0 + tid];
  __syncthreads();
  const int a = blockIdx.x * PREP_THREADS + tid;
  if (a >= n) return;
  T v[KMAX];
#pragma unroll
  for (int q = 0; q < KMAX; ++q)
    v[q] = q < cnt ? G[(long long)I[q] * n + a] - (I[q] == a ? T(1) : T(0))
                   : T(0);
  for (int p = 0; p < cnt; ++p) {
    T m = T(0);
#pragma unroll
    for (int q = 0; q < KMAX; ++q)
      if (q < cnt) m += Ws[p][q] * v[q];
    M[(long long)p * n + a] = m;
    Ut[(long long)p * n + a] = G[(long long)a * n + I[p]];
  }
}

template <typename T>
int launch_decide(const T* G, T* Wout, T* acc, const int* order,
                  long long s_order, const T* gb, const T* delta, const T* us,
                  int n, int k, int v0, int cnt, int batch, void* stream) {
  if (n <= 0 || k <= 0 || k > KMAX || cnt <= 0 || cnt > k || v0 < 0 ||
      v0 + cnt > n || batch <= 0)
    return (int)cudaErrorInvalidValue;
  submatrix_decide_kernel<T><<<batch, 32, 0, (cudaStream_t)stream>>>(
      G, Wout, acc, order, s_order, gb, delta, us, n, k, v0, cnt);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_prep(const T* G, const T* Win, T* Ut, T* M, const int* order,
                long long s_order, int n, int k, int v0, int cnt, int batch,
                void* stream) {
  if (n <= 0 || k <= 0 || k > KMAX || cnt <= 0 || cnt > k || v0 < 0 ||
      v0 + cnt > n || batch <= 0 || batch > 65535)
    return (int)cudaErrorInvalidValue;
  dim3 grid((n + PREP_THREADS - 1) / PREP_THREADS, batch);
  submatrix_prep_kernel<T><<<grid, PREP_THREADS, 0, (cudaStream_t)stream>>>(
      G, Win, Ut, M, order, s_order, n, k, v0, cnt);
  return (int)cudaGetLastError();
}

}  // namespace

#define DQMC_SUB_API(T, SFX)                                                  \
  extern "C" int dqmc_submatrix_decide##SFX(                                  \
      const T* G, T* Wout, T* acc, const int* order, long long s_order,       \
      const T* gb, const T* delta, const T* us, int n, int k, int v0,         \
      int cnt, int batch, void* stream) {                                     \
    return launch_decide<T>(G, Wout, acc, order, s_order, gb, delta, us, n,   \
                            k, v0, cnt, batch, stream);                       \
  }                                                                           \
  extern "C" int dqmc_submatrix_prep##SFX(                                    \
      const T* G, const T* Win, T* Ut, T* M, const int* order,                \
      long long s_order, int n, int k, int v0, int cnt, int batch,            \
      void* stream) {                                                         \
    return launch_prep<T>(G, Win, Ut, M, order, s_order, n, k, v0, cnt,       \
                          batch, stream);                                     \
  }                                                                           \
  extern "C" int dqmc_submatrix_flush##SFX(T* G, const T* Ut, const T* M,     \
                                           long long s_uv, int n, int k,      \
                                           int batch, void* stream) {         \
    return dqmc::launch_rank_k_flush<T>(G, Ut, M, s_uv, n, k, batch, stream); \
  }

DQMC_SUB_API(float, _f32)
DQMC_SUB_API(double, _f64)
