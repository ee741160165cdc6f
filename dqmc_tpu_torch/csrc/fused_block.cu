// K2: one stabilization block of the fused sweep, as two kernels.
//
// Replaces: dqmc_tpu/engine/fused.py::_fused_block_kernel (delayed scheme,
// one stored flavor), the Pallas TPU kernel that ran a whole block -- the
// slice wraps of G, the delayed rank-k Metropolis site loop and the block
// propagator product -- as one VMEM-resident program.
//
//   wrap_gemm_kernel   C[w] = diag(r) A[w] diag(m) B[w] diag(c), batched;
//                      A or B may be shared by the batch (stride 0) and
//                      each scale vector is optional.  The host chains two
//                      of them per slice for the similarity wrap
//                      G' = B G B^{-1} (forward) / B^{-1} G B (backward) and
//                      one for the block product Bbar.
//   site_loop_kernel   the sequential Metropolis loop over the ns sites of
//                      one slice, one CTA per walker: each site forms its
//                      effective row and column of G from the pending
//                      rank-k U/V buffers, decides u < R with
//                      R = gb (1 + (1 - G_ii) delta)^2, writes one U/V slot
//                      and the accept mask, and every k sites flushes
//                      G += U^T V.
//
// What bounds it on an H100: G does not fit in one CTA's shared memory
// (256 KB in f32 at ns = 256 against 227 KB), so it lives in global memory
// and L2.  The site loop is a chain of ns dependent steps per slice, each a
// few __syncthreads apart, with one CTA per walker (W of 132 SMs busy); the
// wraps are ns^3 FLOPs per matrix and are throughput-bound.
//
// What the design does about it: the wraps leave the sequential kernel and
// run as a tiled FFMA GEMM over (tiles x walkers) CTAs, so all SMs share
// them.  The site loop keeps U and V (2 k ns elements, 64 KB at k = 32,
// ns = 256, f32) in dynamic shared memory and reads row i of G coalesced
// and column i strided from L2 -- no G^T chain (G^T existed on the TPU
// only because transposes were costly there).  The flush reads V's column
// slice into registers once and streams G row by row.  Plain FP32/FP64
// FMA, no tensor cores.

#include <cuda_runtime.h>

namespace {

constexpr int TILE = 64;
constexpr int TK = 16;
constexpr int GEMM_THREADS = 256;
constexpr int KMAX = 32;

template <typename T>
__global__ void __launch_bounds__(GEMM_THREADS)
wrap_gemm_kernel(T* __restrict__ C, const T* __restrict__ A, long long sA,
                 const T* __restrict__ B, long long sB,
                 const T* __restrict__ rv, const T* __restrict__ mv,
                 const T* __restrict__ cv, long long sV, int n) {
  __shared__ T As[TK][TILE];
  __shared__ T Bs[TK][TILE];
  const int w = blockIdx.z;
  A += w * sA;
  B += w * sB;
  C += (long long)w * n * n;
  if (rv) rv += w * sV;
  if (mv) mv += w * sV;
  if (cv) cv += w * sV;

  const int tid = threadIdx.x;
  const int tr = tid / 16, tc = tid % 16;
  const int row0 = blockIdx.y * TILE, col0 = blockIdx.x * TILE;
  T acc[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) acc[a][b] = T(0);

  for (int k0 = 0; k0 < n; k0 += TK) {
    for (int e = tid; e < TILE * TK; e += GEMM_THREADS) {
      const int rr = e / TK, kk = e % TK;
      const int gr = row0 + rr, gk = k0 + kk;
      T v = T(0);
      if (gr < n && gk < n) {
        v = A[(long long)gr * n + gk];
        if (mv) v *= mv[gk];
      }
      As[kk][rr] = v;
    }
    for (int e = tid; e < TK * TILE; e += GEMM_THREADS) {
      const int kk = e / TILE, cc = e % TILE;
      const int gk = k0 + kk, gc = col0 + cc;
      Bs[kk][cc] = (gk < n && gc < n) ? B[(long long)gk * n + gc] : T(0);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < TK; ++kk) {
      T a[4], b[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        a[q] = As[kk][tr * 4 + q];
        b[q] = Bs[kk][tc * 4 + q];
      }
#pragma unroll
      for (int x = 0; x < 4; ++x)
#pragma unroll
        for (int y = 0; y < 4; ++y) acc[x][y] += a[x] * b[y];
    }
    __syncthreads();
  }

#pragma unroll
  for (int x = 0; x < 4; ++x) {
    const int gr = row0 + tr * 4 + x;
    if (gr >= n) continue;
#pragma unroll
    for (int y = 0; y < 4; ++y) {
      const int gc = col0 + tc * 4 + y;
      if (gc >= n) continue;
      T v = acc[x][y];
      if (rv) v = rv[gr] * v;
      if (cv) v = v * cv[gc];
      C[(long long)gr * n + gc] = v;
    }
  }
}

// One slice of the Metropolis site loop; blockIdx.x = walker, one thread
// per column j (blockDim = ns rounded up to a warp).
template <typename T>
__global__ void site_loop_kernel(T* __restrict__ G, T* __restrict__ mask,
                                 long long s_mask,
                                 const int* __restrict__ order,
                                 const T* __restrict__ gb,
                                 const T* __restrict__ delta,
                                 const T* __restrict__ us, long long s_stream,
                                 int n, int k) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* U = reinterpret_cast<T*>(smem_raw);  // k x n: prefac * col_eff
  T* V = U + (long long)k * n;            // k x n: row_eff - e_i
  __shared__ T s_gii;

  const int w = blockIdx.x;
  const int j = threadIdx.x;
  const bool own = j < n;
  T* Gw = G + (long long)w * n * n;
  mask += w * s_mask;
  gb += w * s_stream;
  delta += w * s_stream;
  us += w * s_stream;

  for (int idx = 0; idx < n; ++idx) {
    const int slot = idx % k;
    const int i = order[idx];
    T row = T(0), col = T(0);
    if (own) {
      row = Gw[(long long)i * n + j];
      col = Gw[(long long)j * n + i];
      for (int s = 0; s < slot; ++s) {
        row += U[s * n + i] * V[s * n + j];
        col += V[s * n + i] * U[s * n + j];
      }
      if (j == i) s_gii = row;
    }
    __syncthreads();
    const T gii = s_gii;
    const T d = delta[i];
    const T rf = T(1) + (T(1) - gii) * d;
    const T R = gb[i] * rf * rf;  // >= 0: gb > 0 and a square
    const bool accept = us[idx] < R;
    const T prefac = accept ? d / rf : T(0);
    if (own) {
      U[slot * n + j] = prefac * col;
      V[slot * n + j] = row - (j == i ? T(1) : T(0));
    }
    if (j == 0 && accept) mask[i] = T(1);
    __syncthreads();
    if (slot == k - 1 && own) {
      // G[a][j] += sum_s U[s][a] V[s][j]
      T v[KMAX];
#pragma unroll
      for (int s = 0; s < KMAX; ++s) v[s] = s < k ? V[s * n + j] : T(0);
      for (int a = 0; a < n; ++a) {
        T acc = T(0);
#pragma unroll
        for (int s = 0; s < KMAX; ++s)
          if (s < k) acc += U[s * n + a] * v[s];
        Gw[(long long)a * n + j] += acc;
      }
    }
    if (slot == k - 1) __syncthreads();
  }
}

template <typename T>
int launch_gemm(T* C, const T* A, long long sA, const T* B, long long sB,
                const T* rv, const T* mv, const T* cv, long long sV, int n,
                int batch, void* stream) {
  if (n <= 0 || batch <= 0 || batch > 65535) return (int)cudaErrorInvalidValue;
  const int tiles = (n + TILE - 1) / TILE;
  dim3 grid(tiles, tiles, batch);
  wrap_gemm_kernel<T><<<grid, GEMM_THREADS, 0, (cudaStream_t)stream>>>(
      C, A, sA, B, sB, rv, mv, cv, sV, n);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_sites(T* G, T* mask, long long s_mask, const int* order,
                 const T* gb, const T* delta, const T* us, long long s_stream,
                 int n, int k, int batch, void* stream) {
  if (n <= 0 || n > 512 || k <= 0 || k > KMAX || n % k != 0 || batch <= 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(T) * 2 * (size_t)k * n;
  cudaError_t err = cudaFuncSetAttribute(
      site_loop_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int threads = (n + 31) / 32 * 32;
  site_loop_kernel<T><<<batch, threads, smem, (cudaStream_t)stream>>>(
      G, mask, s_mask, order, gb, delta, us, s_stream, n, k);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int dqmc_wrap_gemm_f32(float* C, const float* A, long long sA,
                                  const float* B, long long sB,
                                  const float* rv, const float* mv,
                                  const float* cv, long long sV, int n,
                                  int batch, void* stream) {
  return launch_gemm<float>(C, A, sA, B, sB, rv, mv, cv, sV, n, batch, stream);
}

extern "C" int dqmc_wrap_gemm_f64(double* C, const double* A, long long sA,
                                  const double* B, long long sB,
                                  const double* rv, const double* mv,
                                  const double* cv, long long sV, int n,
                                  int batch, void* stream) {
  return launch_gemm<double>(C, A, sA, B, sB, rv, mv, cv, sV, n, batch,
                             stream);
}

extern "C" int dqmc_site_loop_f32(float* G, float* mask, long long s_mask,
                                  const int* order, const float* gb,
                                  const float* delta, const float* us,
                                  long long s_stream, int n, int k, int batch,
                                  void* stream) {
  return launch_sites<float>(G, mask, s_mask, order, gb, delta, us, s_stream,
                             n, k, batch, stream);
}

extern "C" int dqmc_site_loop_f64(double* G, double* mask, long long s_mask,
                                  const int* order, const double* gb,
                                  const double* delta, const double* us,
                                  long long s_stream, int n, int k, int batch,
                                  void* stream) {
  return launch_sites<double>(G, mask, s_mask, order, gb, delta, us, s_stream,
                              n, k, batch, stream);
}
