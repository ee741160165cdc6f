// K2: one stabilization block of the fused sweep, as a GEMM kernel and a
// site-loop kernel per scheme.
//
// Replaces: dqmc_tpu/engine/fused.py::_fused_block_kernel, the Pallas TPU
// kernel that ran a whole block -- the slice wraps of G, the Metropolis site
// loop and the block propagator product -- as one VMEM-resident program, in
// its three variants: the delayed scheme with one stored flavor, the delayed
// scheme with two (nfl = 2: both flavor chains resident, decisions coupled
// through R = gb r_up r_dn, a per-walker sign), and scheme = "submatrix"
// (site_loop_sub: bordered-Woodbury decisions on G[I, I] and a composite
// flush inside the block, one flavor).
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
//                      G += U^T V.  Two flavors: one CTA keeps both.
//   site_loop_sub_kernel the same slice by the submatrix scheme: per group
//                      of k sites, the k decisions on k x k data (one warp),
//                      then G += G[:, I] W (G[I, :] - E_I) in the CTA.
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
//
// Two flavors need 4 k ns elements of U/V.  One CTA per walker keeps both
// flavors (the decision needs both G_ii, and a second CTA would only wait
// for it), so the two-flavor loop takes the shapes whose buffers fit 227 KB:
// at k = 32, ns <= 448 in f32 and ns <= 224 in f64; the host's
// supports_fused gates on exactly that and the per-slice engine (#4, U/V in
// global memory) serves the rest.  The submatrix loop's flush operands
// (2 k ns elements) replace U/V, beside 9 KB (f32) of decision data; its
// in-CTA flush costs what the delayed loop's does.

#include <cuda_runtime.h>

#include <type_traits>

#include "submatrix_decide.cuh"

namespace {

constexpr int TILE = 64;
constexpr int TK = 16;
constexpr int GEMM_THREADS = 256;
constexpr int KMAX = 32;
constexpr int SITE_THREADS_MAX = 512;  // one thread per column, ns <= 512

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

// One slice of the delayed Metropolis site loop; blockIdx.x = walker, one
// thread per column j (blockDim = ns rounded up to a warp).  NFL = 1: one
// stored flavor, R = gb r^2 (>= 0).  NFL = 2 (the repulsive model): the
// walker's two flavor chains are consecutive matrices of G and consecutive
// rows of delta, both kept by this CTA; each visit forms both flavors'
// effective G_ii before the one decision on R = gb r_up r_dn, accepted on
// |R|, and the walker's sgn is multiplied by -1 per accepted R < 0.
template <typename T, int NFL>
__device__ __forceinline__ void site_loop_body(
    T* __restrict__ G, T* __restrict__ mask, long long s_mask,
    const int* __restrict__ order, const T* __restrict__ gb,
    const T* __restrict__ delta, const T* __restrict__ us,
    long long s_stream, T* __restrict__ sgn, int n, int k) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // The width of the shared-memory offsets decides nvcc 12.8's address
  // code in the flush's inner loop: 64-bit offsets are the faster form with
  // one flavor (by a fifth) and 32-bit ones with two (by a factor of 2.9;
  // H100, f32, ns = 256, when this was written), so each keeps its own.
  using offset_t = typename std::conditional<NFL == 1, long long, int>::type;
  const offset_t kn = (offset_t)k * n;
  T* U = reinterpret_cast<T*>(smem_raw);  // NFL x k x n: prefac * col_eff
  T* V = U + NFL * kn;                    // NFL x k x n: row_eff - e_i
  __shared__ T s_gii[NFL];

  const int w = blockIdx.x;
  const int j = threadIdx.x;
  const bool own = j < n;
  const long long nn = (long long)n * n;
  T* Gw = G + w * NFL * nn;
  mask += w * s_mask;
  gb += w * s_stream;
  delta += w * NFL * s_stream;
  us += w * s_stream;
  T sign = T(1);

  for (int idx = 0; idx < n; ++idx) {
    const int slot = idx % k;
    const int i = order[idx];
    T row[NFL], col[NFL];
#pragma unroll
    for (int f = 0; f < NFL; ++f) {
      row[f] = T(0);
      col[f] = T(0);
      if (own) {
        const T* Gf = Gw + f * nn;
        const T* Uf = U + f * kn;
        const T* Vf = V + f * kn;
        row[f] = Gf[(long long)i * n + j];
        col[f] = Gf[(long long)j * n + i];
        for (int s = 0; s < slot; ++s) {
          row[f] += Uf[s * n + i] * Vf[s * n + j];
          col[f] += Vf[s * n + i] * Uf[s * n + j];
        }
        if (j == i) s_gii[f] = row[f];
      }
    }
    __syncthreads();
    T d[NFL], rf[NFL];
#pragma unroll
    for (int f = 0; f < NFL; ++f) {
      d[f] = delta[f * s_stream + i];
      rf[f] = T(1) + (T(1) - s_gii[f]) * d[f];
    }
    bool accept;
    if (NFL == 1) {
      const T R = gb[i] * rf[0] * rf[0];  // >= 0: gb > 0 and a square
      accept = us[idx] < R;
    } else {
      const T R = gb[i] * rf[0] * rf[NFL - 1];
      accept = us[idx] < (R < T(0) ? -R : R);  // u < 1 strictly
      if (accept && R < T(0)) sign = -sign;
    }
    if (own) {
#pragma unroll
      for (int f = 0; f < NFL; ++f) {
        const T prefac = accept ? d[f] / rf[f] : T(0);
        U[f * kn + slot * n + j] = prefac * col[f];
        V[f * kn + slot * n + j] = row[f] - (j == i ? T(1) : T(0));
      }
    }
    if (j == 0 && accept) mask[i] = T(1);
    __syncthreads();
    if (slot == k - 1 && own) {
      // G[a][j] += sum_s U[s][a] V[s][j], flavor by flavor
#pragma unroll
      for (int f = 0; f < NFL; ++f) {
        T* Gf = Gw + f * nn;
        const T* Uf = U + f * kn;
        const T* Vf = V + f * kn;
        T v[KMAX];
#pragma unroll
        for (int s = 0; s < KMAX; ++s) v[s] = s < k ? Vf[s * n + j] : T(0);
        for (int a = 0; a < n; ++a) {
          T acc = T(0);
#pragma unroll
          for (int s = 0; s < KMAX; ++s)
            if (s < k) acc += Uf[s * n + a] * v[s];
          Gf[(long long)a * n + j] += acc;
        }
      }
    }
    if (slot == k - 1) __syncthreads();
  }
  if (NFL == 2 && j == 0) sgn[w] *= sign;
}

// The one-flavor kernel carries no launch bound: with one, nvcc 12.8 trims
// its registers from 72 to 64 and the slice takes 1.24 ms instead of 1.01
// (ns = 256, f32, on an H100).  The two-flavor and submatrix kernels are
// bounded so that 512 threads always launch.
template <typename T>
__global__ void site_loop_kernel(T* G, T* mask, long long s_mask,
                                 const int* order, const T* gb,
                                 const T* delta, const T* us,
                                 long long s_stream, T* sgn, int n, int k) {
  site_loop_body<T, 1>(G, mask, s_mask, order, gb, delta, us, s_stream, sgn,
                       n, k);
}

template <typename T>
__global__ void __launch_bounds__(SITE_THREADS_MAX)
site_loop_2f_kernel(T* G, T* mask, long long s_mask, const int* order,
                    const T* gb, const T* delta, const T* us,
                    long long s_stream, T* sgn, int n, int k) {
  site_loop_body<T, 2>(G, mask, s_mask, order, gb, delta, us, s_stream, sgn,
                       n, k);
}

// One slice of the submatrix scheme (one stored flavor); blockIdx.x =
// walker, one thread per column j.  Per group of k visits: warp 0 gathers
// G[I, I] and runs the k bordered-inverse decisions (submatrix_decide.cuh;
// a rejected candidate leaves W's row and column exactly zero); every thread
// then copies its column of the flush operands out of the block-base G,
// Ut[p][j] = G[j][I_p] and M[p][j] = sum_q W[p][q] (G[I_q][j] - [I_q == j]),
// into shared memory; then the composite flush G += Ut^T M runs in the CTA,
// column by column as in the delayed loop.  gb and delta are site-indexed.
template <typename T>
__global__ void __launch_bounds__(SITE_THREADS_MAX)
site_loop_sub_kernel(T* __restrict__ G, T* __restrict__ mask,
                     long long s_mask, const int* __restrict__ order,
                     const T* __restrict__ gb, const T* __restrict__ delta,
                     const T* __restrict__ us, long long s_stream, int n,
                     int k) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Ut = reinterpret_cast<T*>(smem_raw);  // k x n: G[:, I]^T
  T* M = Ut + (long long)k * n;            // k x n: W (G[I, :] - E_I)
  __shared__ dqmc::DecideSmem<T> sm;

  const int w = blockIdx.x;
  const int j = threadIdx.x;
  const bool own = j < n;
  T* Gw = G + (long long)w * n * n;
  mask += w * s_mask;
  gb += w * s_stream;
  delta += w * s_stream;
  us += w * s_stream;

  for (int v0 = 0; v0 < n; v0 += k) {
    if (j < 32)
      dqmc::submatrix_decide_warp(sm, Gw, n, order, v0, k, gb, delta, us,
                                  mask, true, j);
    __syncthreads();
    T v[KMAX];
    if (own) {
#pragma unroll
      for (int q = 0; q < KMAX; ++q)
        v[q] = q < k ? Gw[(long long)sm.I[q] * n + j] -
                           (sm.I[q] == j ? T(1) : T(0))
                     : T(0);
      for (int p = 0; p < k; ++p) {
        T m = T(0);
#pragma unroll
        for (int q = 0; q < KMAX; ++q)
          if (q < k) m += sm.Wm[p][q] * v[q];
        M[p * n + j] = m;
        Ut[p * n + j] = Gw[(long long)j * n + sm.I[p]];
      }
    }
    __syncthreads();
    if (own) {
#pragma unroll
      for (int s = 0; s < KMAX; ++s) v[s] = s < k ? M[s * n + j] : T(0);
      for (int a = 0; a < n; ++a) {
        T acc = T(0);
#pragma unroll
        for (int s = 0; s < KMAX; ++s)
          if (s < k) acc += Ut[s * n + a] * v[s];
        Gw[(long long)a * n + j] += acc;
      }
    }
    __syncthreads();
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

template <typename T, int NFL>
int launch_sites(T* G, T* mask, long long s_mask, const int* order,
                 const T* gb, const T* delta, const T* us, long long s_stream,
                 T* sgn, int n, int k, int batch, void* stream) {
  if (n <= 0 || n > 512 || k <= 0 || k > KMAX || n % k != 0 || batch <= 0 ||
      (NFL == 2 && sgn == nullptr))
    return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(T) * 2 * NFL * (size_t)k * n;
  auto kernel = NFL == 1 ? site_loop_kernel<T> : site_loop_2f_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int threads = (n + 31) / 32 * 32;
  kernel<<<batch, threads, smem, (cudaStream_t)stream>>>(
      G, mask, s_mask, order, gb, delta, us, s_stream, sgn, n, k);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_sites_sub(T* G, T* mask, long long s_mask, const int* order,
                     const T* gb, const T* delta, const T* us,
                     long long s_stream, int n, int k, int batch,
                     void* stream) {
  if (n <= 0 || n > 512 || k <= 0 || k > KMAX || n % k != 0 || batch <= 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(T) * 2 * (size_t)k * n;
  cudaError_t err = cudaFuncSetAttribute(
      site_loop_sub_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int threads = (n + 31) / 32 * 32;
  site_loop_sub_kernel<T><<<batch, threads, smem, (cudaStream_t)stream>>>(
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

#define DQMC_SITE_LOOP_API(T, SFX)                                            \
  extern "C" int dqmc_site_loop##SFX(                                         \
      T* G, T* mask, long long s_mask, const int* order, const T* gb,         \
      const T* delta, const T* us, long long s_stream, T* sgn, int n, int k,  \
      int batch, void* stream) {                                              \
    return launch_sites<T, 1>(G, mask, s_mask, order, gb, delta, us,          \
                              s_stream, sgn, n, k, batch, stream);            \
  }                                                                           \
  extern "C" int dqmc_site_loop_2f##SFX(                                      \
      T* G, T* mask, long long s_mask, const int* order, const T* gb,         \
      const T* delta, const T* us, long long s_stream, T* sgn, int n, int k,  \
      int batch, void* stream) {                                              \
    return launch_sites<T, 2>(G, mask, s_mask, order, gb, delta, us,          \
                              s_stream, sgn, n, k, batch, stream);            \
  }                                                                           \
  extern "C" int dqmc_site_loop_sub##SFX(                                     \
      T* G, T* mask, long long s_mask, const int* order, const T* gb,         \
      const T* delta, const T* us, long long s_stream, int n, int k,          \
      int batch, void* stream) {                                              \
    return launch_sites_sub<T>(G, mask, s_mask, order, gb, delta, us,         \
                               s_stream, n, k, batch, stream);                \
  }

DQMC_SITE_LOOP_API(float, _f32)
DQMC_SITE_LOOP_API(double, _f64)
