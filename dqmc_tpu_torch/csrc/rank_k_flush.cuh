// The rank-k flush G += U^T V of the delayed (#3) and submatrix (#5) site
// updates, as a tiled kernel over (column tiles, row tiles, walkers) CTAs.
//
// U and V are (k, n) per walker: G[a][b] += sum_{s < k} U[s][a] V[s][b].
// The delayed scheme flushes its pending buffers (U = prefac * column,
// V = row - e_i); the submatrix scheme flushes U = G[:, I]^T and
// V = W (G[I, :] - E_I).  Each CTA stages the k x 64 slices of U and V it
// needs in shared memory and owns a 64 x 64 tile of G; a thread owns a
// 4 x 4 lattice of that tile spaced 16 apart, so a warp's read-modify-write
// of G covers contiguous 64-byte runs.  Plain FP32/FP64 FMA, no tensor
// cores; the k-long dot products are summed in order, then added to G.

#pragma once

#include <cuda_runtime.h>

namespace dqmc {

constexpr int FLUSH_TILE = 64;
constexpr int FLUSH_THREADS = 256;
constexpr int FLUSH_KMAX = 32;

template <typename T>
__global__ void __launch_bounds__(FLUSH_THREADS)
rank_k_flush_kernel(T* __restrict__ G, const T* __restrict__ U,
                    const T* __restrict__ V, long long s_uv, int n, int k) {
  __shared__ T Us[FLUSH_KMAX][FLUSH_TILE];
  __shared__ T Vs[FLUSH_KMAX][FLUSH_TILE];
  const int w = blockIdx.z;
  G += (long long)w * n * n;
  U += w * s_uv;
  V += w * s_uv;
  const int row0 = blockIdx.y * FLUSH_TILE, col0 = blockIdx.x * FLUSH_TILE;
  const int tid = threadIdx.x;
  for (int e = tid; e < k * FLUSH_TILE; e += FLUSH_THREADS) {
    const int s = e / FLUSH_TILE, c = e % FLUSH_TILE;
    Us[s][c] = row0 + c < n ? U[(long long)s * n + row0 + c] : T(0);
    Vs[s][c] = col0 + c < n ? V[(long long)s * n + col0 + c] : T(0);
  }
  __syncthreads();

  const int tr = tid / 16, tc = tid % 16;
  T acc[4][4];
#pragma unroll
  for (int x = 0; x < 4; ++x)
#pragma unroll
    for (int y = 0; y < 4; ++y) acc[x][y] = T(0);
  for (int s = 0; s < k; ++s) {
    T a[4], b[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      a[q] = Us[s][tr + 16 * q];
      b[q] = Vs[s][tc + 16 * q];
    }
#pragma unroll
    for (int x = 0; x < 4; ++x)
#pragma unroll
      for (int y = 0; y < 4; ++y) acc[x][y] += a[x] * b[y];
  }
#pragma unroll
  for (int x = 0; x < 4; ++x) {
    const int gr = row0 + tr + 16 * x;
    if (gr >= n) continue;
#pragma unroll
    for (int y = 0; y < 4; ++y) {
      const int gc = col0 + tc + 16 * y;
      if (gc < n) G[(long long)gr * n + gc] += acc[x][y];
    }
  }
}

template <typename T>
int launch_rank_k_flush(T* G, const T* U, const T* V, long long s_uv, int n,
                        int k, int batch, void* stream) {
  if (n <= 0 || k <= 0 || k > FLUSH_KMAX || batch <= 0 || batch > 65535)
    return (int)cudaErrorInvalidValue;
  const int tiles = (n + FLUSH_TILE - 1) / FLUSH_TILE;
  rank_k_flush_kernel<T><<<dim3(tiles, tiles, batch), FLUSH_THREADS, 0,
                           (cudaStream_t)stream>>>(G, U, V, s_uv, n, k);
  return (int)cudaGetLastError();
}

}  // namespace dqmc
