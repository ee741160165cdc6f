// The rank-k flush G += U^T V of the submatrix site update (#5), as a
// tiled kernel over (column strips, row ranges, matrices) CTAs.
//
// U and V are (k, n) per matrix: G[a][b] += sum_{s < k} U[s][a] V[s][b]
// (U = G[:, I]^T and V = W (G[I, :] - E_I)).  What bounds it on an H100:
// every flush reads and writes all of G (2 n^2 elements per matrix) for
// 2 k n^2 FLOPs, 8 FLOPs per byte at k = 32 in float32: the bytes, from
// L2 where G fits (16 MB at the stretch shape).
//
// What the design does about it: a CTA owns a BN-column strip of G over a
// range of rows, stages the strip's k x BN slice of V once and walks down
// the range in blocks of 64 rows, each block's k x 64 slice of U in one of
// two shared buffers.  Its 256 threads are 8 row groups of 32: the threads
// of a warp share their 8 rows (U's entries reach them as broadcast
// 16-byte shared loads) and each owns TN = 4 (float32) or 2 (float64)
// neighbouring columns, so a warp reads and writes G as 512 contiguous
// bytes per row, in 16-byte vectors.  The next block's U and the thread's
// next 8 x TN tile of G are loaded into registers before the current
// block's FMAs, so the loads are in flight under them; the ranges are cut
// so that every SM gets two CTAs.  Plain FP32/FP64 FMA, no tensor
// cores; the k-long dot products are summed from 0 in s order, then added
// to G.  A ragged n (n % 4 != 0) or a misaligned pointer takes the same
// tiles with scalar loads and stores.

#pragma once

#include <cuda_runtime.h>

namespace dqmc {

constexpr int FLUSH_THREADS = 256;
constexpr int FLUSH_KMAX = 32;

// a thread's TM rows x TN columns; a block of 8 x 32 threads covers BM rows
// of a BN-column strip.  float64 takes 2 columns (its V loads of 4 doubles
// per thread and step bound it on shared memory) and one block per SM (its
// registers); float32 two blocks per SM.
template <typename T>
struct FlushTile {
  static constexpr int TM = 8;
  static constexpr int TN = sizeof(T) == 4 ? 4 : 2;
  static constexpr int BM = 8 * TM, BN = 32 * TN;
  static constexpr int BLOCKS_PER_SM = sizeof(T) == 4 ? 2 : 1;
};

// 16 bytes of T: one float4 or double2 load or store
template <typename T>
struct alignas(16) FlushVec {
  T v[16 / sizeof(T)];
};

// dst[0 ... VW) = src[0 ... VW), zeros from index n - at on: one 16-byte
// load (VEC: at and n are multiples of VW, so a vector is wholly in or out)
// or VW guarded scalar loads
template <typename T, bool VEC>
__device__ __forceinline__ FlushVec<T> flush_load(const T* src, int at,
                                                  int n) {
  constexpr int VW = 16 / sizeof(T);
  FlushVec<T> t{};
  if (VEC) {
    if (at < n) t = *reinterpret_cast<const FlushVec<T>*>(src);
  } else {
#pragma unroll
    for (int q = 0; q < VW; ++q) t.v[q] = at + q < n ? src[q] : T(0);
  }
  return t;
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(FLUSH_THREADS,
                                  FlushTile<T>::BLOCKS_PER_SM)
rank_k_flush_kernel(T* __restrict__ G, const T* __restrict__ U,
                    const T* __restrict__ V, long long s_uv, int n, int k,
                    int rows_per_cta) {
  constexpr int TM = FlushTile<T>::TM, TN = FlushTile<T>::TN;
  constexpr int BM = FlushTile<T>::BM, BN = FlushTile<T>::BN;
  constexpr int VW = 16 / sizeof(T);
  constexpr int UV = FLUSH_KMAX * BM / VW / FLUSH_THREADS;  // U loads
  __shared__ __align__(16) T Us[2][FLUSH_KMAX][BM];
  __shared__ __align__(16) T Vs[FLUSH_KMAX][BN];
  const int w = blockIdx.z;
  G += (long long)w * n * n;
  U += w * s_uv;
  V += w * s_uv;
  const int col0 = blockIdx.x * BN;
  const int rbeg = blockIdx.y * rows_per_cta;
  const int rend = min(n, rbeg + rows_per_cta);
  const int tid = threadIdx.x;
  const int ty = tid / 32, tx = tid % 32;
  const int c0 = col0 + tx * TN;

  // V[s][col0 ... col0 + BN), zero past n, once
  for (int e = tid * VW; e < k * BN; e += FLUSH_THREADS * VW) {
    const int s = e / BN, c = e % BN;
    *reinterpret_cast<FlushVec<T>*>(&Vs[s][c]) =
        flush_load<T, VEC>(V + (long long)s * n + col0 + c, col0 + c, n);
  }
  // a block's U[s][row0 ... row0 + BM) and the thread's TM x TN tile of G,
  // into registers
  FlushVec<T> up[UV];
  auto load_u = [&](int row0) {
#pragma unroll
    for (int i = 0; i < UV; ++i) {
      const int e = (tid + i * FLUSH_THREADS) * VW;
      const int s = e / BM, c = e % BM;
      if (s < k)
        up[i] = flush_load<T, VEC>(U + (long long)s * n + row0 + c, row0 + c,
                                   n);
    }
  };
  auto put_u = [&](int buf) {
#pragma unroll
    for (int i = 0; i < UV; ++i) {
      const int e = (tid + i * FLUSH_THREADS) * VW;
      const int s = e / BM, c = e % BM;
      if (s < k) *reinterpret_cast<FlushVec<T>*>(&Us[buf][s][c]) = up[i];
    }
  };
  auto load_g = [&](T(&dst)[TM][TN], int row0) {
#pragma unroll
    for (int x = 0; x < TM; ++x) {
      const int r = row0 + ty * TM + x;
      const T* gr = G + (long long)r * n + c0;
#pragma unroll
      for (int y = 0; y < TN; y += VW) {
        const FlushVec<T> t =
            flush_load<T, VEC>(gr + y, r < rend ? c0 + y : n, n);
#pragma unroll
        for (int q = 0; q < VW; ++q) dst[x][y + q] = t.v[q];
      }
    }
  };

  T g[TM][TN], gn[TM][TN];
  load_u(rbeg);
  load_g(g, rbeg);
  put_u(0);
  __syncthreads();
  int buf = 0;
  for (int row0 = rbeg; row0 < rend; row0 += BM, buf ^= 1) {
    // the next block's loads in flight under this block's FMAs
    const bool more = row0 + BM < rend;
    if (more) {
      load_u(row0 + BM);
      load_g(gn, row0 + BM);
    }
    T acc[TM][TN];
#pragma unroll
    for (int x = 0; x < TM; ++x)
#pragma unroll
      for (int y = 0; y < TN; ++y) acc[x][y] = T(0);
    for (int s = 0; s < k; ++s) {
      T a[TM], b[TN];
#pragma unroll
      for (int x = 0; x < TM; x += VW) {
        const FlushVec<T> t =
            *reinterpret_cast<const FlushVec<T>*>(&Us[buf][s][ty * TM + x]);
#pragma unroll
        for (int q = 0; q < VW; ++q) a[x + q] = t.v[q];
      }
#pragma unroll
      for (int y = 0; y < TN; y += VW) {
        const FlushVec<T> t =
            *reinterpret_cast<const FlushVec<T>*>(&Vs[s][tx * TN + y]);
#pragma unroll
        for (int q = 0; q < VW; ++q) b[y + q] = t.v[q];
      }
#pragma unroll
      for (int x = 0; x < TM; ++x)
#pragma unroll
        for (int y = 0; y < TN; ++y) acc[x][y] = fma(a[x], b[y], acc[x][y]);
    }
#pragma unroll
    for (int x = 0; x < TM; ++x) {
      const int r = row0 + ty * TM + x;
      if (r >= rend) continue;
      T* gr = G + (long long)r * n + c0;
#pragma unroll
      for (int y = 0; y < TN; y += VW) {
        FlushVec<T> t;
#pragma unroll
        for (int q = 0; q < VW; ++q) t.v[q] = g[x][y + q] + acc[x][y + q];
        if (VEC) {
          if (c0 < n) *reinterpret_cast<FlushVec<T>*>(gr + y) = t;
        } else {
#pragma unroll
          for (int q = 0; q < VW; ++q)
            if (c0 + y + q < n) gr[y + q] = t.v[q];
        }
      }
    }
    if (more) {
      put_u(buf ^ 1);
#pragma unroll
      for (int x = 0; x < TM; ++x)
#pragma unroll
        for (int y = 0; y < TN; ++y) g[x][y] = gn[x][y];
    }
    __syncthreads();
  }
}

// Rows per CTA: whole row blocks, enough CTAs to give every SM two (the
// strips times the matrices times the splits of a strip's rows), as few
// splits as that allows so each CTA pipelines over several blocks.
template <typename T>
int flush_rows_per_cta(int n, int batch) {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    sms = 132;
  constexpr int BM = FlushTile<T>::BM;
  const int blocks = (n + BM - 1) / BM;
  constexpr int BN = FlushTile<T>::BN;
  const long long strips = (long long)((n + BN - 1) / BN) * batch;
  const int splits = (int)min((long long)blocks,
                              max(1LL, (2LL * sms + strips - 1) / strips));
  return (blocks + splits - 1) / splits * BM;
}

template <typename T>
int launch_rank_k_flush(T* G, const T* U, const T* V, long long s_uv, int n,
                        int k, int batch, void* stream) {
  if (n <= 0 || k <= 0 || k > FLUSH_KMAX || batch <= 0 || batch > 65535)
    return (int)cudaErrorInvalidValue;
  const int rows = flush_rows_per_cta<T>(n, batch);
  const dim3 grid((n + FlushTile<T>::BN - 1) / FlushTile<T>::BN,
                  (n + rows - 1) / rows, batch);
  const auto aligned = [](const void* p) {
    return reinterpret_cast<unsigned long long>(p) % 16 == 0;
  };
  // every row, strip and a thread's columns start on a 16-byte boundary
  const bool vec = n % 4 == 0 && s_uv % 4 == 0 && aligned(G) &&
                   aligned(U) && aligned(V);
  if (vec)
    rank_k_flush_kernel<T, true><<<grid, FLUSH_THREADS, 0,
                                   (cudaStream_t)stream>>>(G, U, V, s_uv, n,
                                                           k, rows);
  else
    rank_k_flush_kernel<T, false><<<grid, FLUSH_THREADS, 0,
                                    (cudaStream_t)stream>>>(G, U, V, s_uv,
                                                            n, k, rows);
  return (int)cudaGetLastError();
}

}  // namespace dqmc
