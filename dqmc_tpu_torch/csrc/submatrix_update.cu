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
// One C call per slice (dqmc_submatrix_slice) issues two launches per group
// of k visits (each also has an entry point of its own, for timing:
// dqmc_submatrix_group, dqmc_submatrix_flush):
//   submatrix_group_kernel  C CTAs per walker (C = ceil(n / 64), each
//                           owning R <= 64 indices): every CTA gathers
//                           G[I, I] and takes the group's decisions on the
//                           same bits (submatrix_decide.cuh), its other
//                           warps meanwhile copying Ut = G[:, I]^T at its
//                           own rows; then it forms M = W (G[I, :] - E_I)
//                           at its own columns.  Ut and M, (k, n) per
//                           walker, go to global memory; CTA 0 writes the
//                           accept flags.
//   rank_k_flush_kernel     (rank_k_flush.cuh) G += Ut^T M over the whole
//                           card.
//
// The factors gb and delta of each visit come from the host
// (ops/kernels.py visit_factors), as for #3.  The order has a stride: 0 for
// the shared order of the JAX kernel, n for per-walker orders (the
// submatrix scheme of engine/sweep.py); the last group of a slice may be
// short.
//
// What bounds it on an H100: the decisions are O(k^2) per visit on data
// that fits in one SM's shared memory, a short latency-bound chain (about
// a quarter of a microsecond per visit); the flush is 2 k n^2 FLOPs per
// walker and group on G in L2 (4 MB per walker at the stretch shape, 16 MB
// at W = 4), which the all-card flush moves in about 13 us in float32.
//
// What the design does about it: the first design ran each group as three
// launches -- one warp per walker for the decisions, gathering G[I, I] in k
// dependent rounds and reading gb, delta and u from global memory visit by
// visit; an operand kernel reading G[I, :] down columns; the flush -- from
// the host, one Python call each.  Now the decisions and the operands are
// one launch, the gathers are batched, the operands are spread over the
// walker's CTAs and formed while the decisions run, and the whole slice is
// issued from one C call.  The flush stays a separate launch over the
// whole card: a flush inside the walker's own C SMs (one cluster launch per
// slice, submatrix_slice_body with R <= 64) ran slower at the stretch shape
// (scripts/seed_split.py submatrix --parts probes).  No data passes between
// a walker's CTAs within a launch (each decides on the same bits), so the
// launch needs no cluster.  The decisions, M and the flush keep the first
// design's arithmetic and so its bits.  Plain FP32/FP64 FMA, no tensor
// cores, no atomics.

#include <cuda_runtime.h>

#include "rank_k_flush.cuh"
#include "submatrix_decide.cuh"

namespace {

constexpr int KMAX = dqmc::DECIDE_KMAX;
constexpr int GROUP_THREADS = 256;
constexpr int GROUP_RMAX = 64;  // indices per CTA

static_assert(KMAX == dqmc::FLUSH_KMAX, "one block rank for both kernels");

// C = ceil(n / 64) CTAs per walker, R = ceil(n / C) indices each
struct GroupGrid {
  int C, R;
};

inline GroupGrid group_grid(int n) {
  const int C = (n + GROUP_RMAX - 1) / GROUP_RMAX;
  return {C, (n + C - 1) / C};
}

template <typename T>
struct GroupArgs {
  const T* G;
  T* acc;
  const int* order;
  long long s_order;
  const T* gb;
  const T* delta;
  const T* us;
  T* Ut;
  T* M;
  int n, k, v0, cnt, R;
};

// grid (C, walkers): blockIdx.x = c owns the indices a0 = c R ...
template <typename T>
__global__ void __launch_bounds__(GROUP_THREADS)
submatrix_group_kernel(const GroupArgs<T> a) {
  __shared__ dqmc::DecideSmem<T> sm;
  __shared__ T GR[KMAX * GROUP_RMAX];  // G[I, own] - E
  __shared__ T gbs[KMAX], dls[KMAX], uss[KMAX];
  __shared__ int I[KMAX], accs[KMAX];
  const int n = a.n, cnt = a.cnt, R = a.R;
  const int c = blockIdx.x, w = blockIdx.y;
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int a0 = c * R;
  const int own = max(0, min(R, n - a0));
  const T* Gw = a.G + (long long)w * n * n;
  const long long ws = (long long)w * n + a.v0;
  if (tid < cnt) {
    I[tid] = a.order[w * a.s_order + a.v0 + tid];
    gbs[tid] = a.gb[ws + tid];
    dls[tid] = a.delta[ws + tid];
    uss[tid] = a.us[ws + tid];
  }
  __syncthreads();
  dqmc::sub_gather(sm, Gw, n, I, cnt, tid, nthreads);
  __syncthreads();
  T* Ut = a.Ut + (long long)w * a.k * n + a0;
  if (tid < 32)
    dqmc::sub_decide_warp(sm, cnt, gbs, dls, uss, accs, tid);
  else
    dqmc::sub_panels(Gw, n, I, cnt, a0, own, Ut, n, GR, GROUP_RMAX,
                     tid - 32, nthreads - 32);
  __syncthreads();
  if (c == 0 && tid < cnt) a.acc[ws + tid] = accs[tid] ? T(1) : T(0);
  dqmc::sub_m(sm, GR, GROUP_RMAX, a.M + (long long)w * a.k * n + a0, n, cnt,
              own, tid, nthreads);
}

template <typename T>
int launch_group(const T* G, T* acc, const int* order, long long s_order,
                 const T* gb, const T* delta, const T* us, T* Ut, T* M,
                 int n, int k, int v0, int cnt, int batch, void* stream) {
  if (n <= 0 || k <= 0 || k > KMAX || cnt <= 0 || cnt > k || v0 < 0 ||
      v0 + cnt > n || batch <= 0 || batch > 65535 ||
      (s_order != 0 && s_order != n))
    return (int)cudaErrorInvalidValue;
  const GroupGrid g = group_grid(n);
  const GroupArgs<T> args{G,  acc, order, s_order, gb, delta, us,
                          Ut, M,   n,     k,       v0, cnt,   g.R};
  submatrix_group_kernel<T><<<dim3(g.C, batch), GROUP_THREADS, 0,
                              (cudaStream_t)stream>>>(args);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_slice(T* G, T* acc, const int* order, long long s_order,
                 const T* gb, const T* delta, const T* us, T* Ut, T* M,
                 int n, int k, int batch, void* stream) {
  if (n <= 0 || k <= 0 || k > KMAX || batch <= 0 || batch > 65535 ||
      (s_order != 0 && s_order != n))
    return (int)cudaErrorInvalidValue;
  for (int v0 = 0; v0 < n; v0 += k) {
    const int cnt = min(k, n - v0);
    int err = launch_group<T>(G, acc, order, s_order, gb, delta, us, Ut, M,
                              n, k, v0, cnt, batch, stream);
    if (err) return err;
    err = dqmc::launch_rank_k_flush<T>(G, Ut, M, (long long)k * n, n, cnt,
                                       batch, stream);
    if (err) return err;
  }
  return 0;
}

}  // namespace

#define DQMC_SUB_API(T, SFX)                                                  \
  extern "C" int dqmc_submatrix_slice##SFX(                                   \
      T* G, T* acc, const int* order, long long s_order, const T* gb,         \
      const T* delta, const T* us, T* Ut, T* M, int n, int k, int batch,      \
      void* stream) {                                                         \
    return launch_slice<T>(G, acc, order, s_order, gb, delta, us, Ut, M, n,   \
                           k, batch, stream);                                 \
  }                                                                           \
  extern "C" int dqmc_submatrix_group##SFX(                                   \
      const T* G, T* acc, const int* order, long long s_order, const T* gb,   \
      const T* delta, const T* us, T* Ut, T* M, int n, int k, int v0,         \
      int cnt, int batch, void* stream) {                                     \
    return launch_group<T>(G, acc, order, s_order, gb, delta, us, Ut, M, n,   \
                           k, v0, cnt, batch, stream);                        \
  }                                                                           \
  extern "C" int dqmc_submatrix_flush##SFX(T* G, const T* Ut, const T* M,     \
                                           long long s_uv, int n, int k,      \
                                           int batch, void* stream) {         \
    return dqmc::launch_rank_k_flush<T>(G, Ut, M, s_uv, n, k, batch, stream); \
  }

DQMC_SUB_API(float, _f32)
DQMC_SUB_API(double, _f64)

// The CTAs per walker of submatrix_group_kernel for a slice of n sites
// (ops/kernels.py submatrix_group_ctas mirrors it for the host).
extern "C" int dqmc_submatrix_group_ctas(int n) { return group_grid(n).C; }
