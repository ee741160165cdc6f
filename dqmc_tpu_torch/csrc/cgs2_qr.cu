// K1: batched CGS2 QR factorization, optionally with R^{-1}.
//
// Replaces: dqmc_tpu/ops/qr_kernel.py::_cgs2_kernel (the Pallas TPU kernel
// behind cgs2_qr / cgs2_qr_inv), which every LDR fold (to_ldr) and every
// stabilized solve and log-det (_qr_solve_logdet) of the main path runs.
//
// What it computes, per matrix A (n x n, n a multiple of 32; n <= 1728 in
// float32, where the 32-row panel still fits in a block's 232,448 bytes of
// shared memory, and n <= 512 in float64, which the engines factor by
// Householder):
// classical Gram-Schmidt with reorthogonalization (CGS2) on the columns of
// A, in 32-column panels.  Every column receives two complete projection
// passes against all earlier columns: two block passes against the finished
// panels, then two in-panel passes against the earlier columns of its own
// panel.  R is accumulated from the projection coefficients of both passes
// (never rebuilt as triu(Q^T A), which costs chain accuracy), its diagonal
// is the column norm (>= 0), and the optional W = R^{-1} is built blockwise
// as the TPU kernel built it: the 32 x 32 inverse S of each diagonal block,
// then the cross-panel block W[:p0, P] = -W[:p0, :p0] (R[:p0, P] S).  The
// kernels work on A^T, so a column of A is a contiguous row: the caller
// passes A^T and receives Q^T.
//
// What bounds it on an H100: about 4 n^3 FLOPs per matrix sit in the block
// passes and 2 n^3 / 3 in the cross-panel products of R^{-1}, but the
// in-panel column loop sets the time: 32 columns x 2 passes per panel, each
// a dot-product phase and an update phase a block barrier apart, on one SM
// per matrix, so it is latency-bound (about 2.5 us per column at n = 256).
// A batch holds only W = 4..16 matrices: one CTA per matrix for everything
// left 116..128 of the 132 SMs idle while the FLOPs waited on one SM each.
//
// What the design does about it: the C entry point issues, per panel, a
// short sequence of launches on the caller's stream, so the FLOPs spread
// over (matrix x tile) CTAs and only the sequential column loop stays on
// one CTA per matrix:
//   block_dot_kernel    C = P Q[:p0]^T (32 x p0, contraction over n) and
//                       R[:p0, P] += C^T, in 32 x 32 output tiles; while
//                       p0 is small the contraction is split into chunks
//                       whose partial sums the last CTA of each tile (by an
//                       integer ticket) adds up in chunk order -- no
//                       floating-point atomics, so the same input gives the
//                       same bits;
//   block_update_kernel P -= C Q[:p0] in 32 x 32 tiles of the panel; both
//                       kernels run twice per panel (CGS2);
//   panel_kernel        the in-panel loop, one CTA of 256 threads per
//                       matrix with the 32 x n panel in shared memory; a
//                       warp forms four of a pass's dot products side by
//                       side; it writes R's diagonal block and, for R^{-1},
//                       its inverse S (back substitution, R_PP S = I) into
//                       W's diagonal block;
//   x_kernel            X = R[:p0, P] S into the workspace;
//   cross_kernel        W[:p0, P] = -W[:p0, :p0] X in 32 x 32 tiles (W is
//                       upper triangular, so a row tile starts its
//                       contraction at its own diagonal).
// R^{-1} is built as the TPU kernel builds it, blockwise, but associated
// as the block column of R W = I, -W11 (R12 S), like the column back
// substitution it replaces, where the TPU kernel forms -(W11 R12) S (the
// block row of W R = I).  The choice is a judgement: on one float32
// stretch sweep pair per variant the TPU association read mean self-check
// errors 1.5x (#3) and 340x (#5) those of the back substitution, the kept
// one 0.02x and 0.7x, and such single readings are heavy-tailed.
// The tiled kernels share tile_gemm: 64 threads with 4 x 4 outputs each,
// operands staged through padded shared memory (conflict-free reads), the
// next step's loads in flight during the current step's FMAs.  R and R^{-1}
// are zeroed with cudaMemsetAsync and Q^T starts as a copy of A^T, so every
// kernel writes only what it computes.  Plain FP32/FP64 FMA, no tensor
// cores.  A thread-block cluster per matrix for the in-panel loop was not
// built: the loop's time is barriers and reduction latency, not work, and a
// cluster barrier costs more than a block barrier.

#include <cuda_runtime.h>

namespace {

constexpr int PANEL = 32;
constexpr int TILE_THREADS = 64;  // 8 x 8 threads, 4 x 4 outputs each
constexpr int PANEL_THREADS = 256;

// Chunks of the block-pass contraction: the workspace holds n / 128 (at
// least one) partial C blocks (32 x n) per matrix plus X (n x 32), then one
// ticket per C tile (n / 32 per matrix), one element each.  The wrapper
// allocates what dqmc_cgs2_workspace returns.
inline int max_chunks(int n) { return n / 128 > 1 ? n / 128 : 1; }

inline long long workspace_elems(int batch, int n) {
  return (long long)batch * (max_chunks(n) + 1) * PANEL * n +
         (long long)batch * (n / PANEL);
}

// How the contraction over n is cut at panel p0: 1024 / p0 chunks of at
// least four 32-deep steps, so about 32 CTAs per matrix while the C tiles
// are few and one chunk once they are many.  Depends on (n, p0) only, so
// a matrix's bits do not depend on the batch it came in.
struct Split {
  int per;     // 32-deep steps per chunk
  int chunks;  // chunks actually used (<= max_chunks(n))
};

inline Split dot_split(int n, int p0) {
  const int kt = n / PANEL;
  int ks = 1024 / p0;
  if (ks > max_chunks(n)) ks = max_chunks(n);
  if (ks < 1) ks = 1;
  const int per = (kt + ks - 1) / ks;
  return {per, (kt + per - 1) / per};
}

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T>
__device__ __forceinline__ void zero(T (&acc)[4][4]) {
#pragma unroll
  for (int x = 0; x < 4; ++x)
#pragma unroll
    for (int y = 0; y < 4; ++y) acc[x][y] = T(0);
}

// acc[x][y] += sum_kk A(ty + 8x, kk) B(kk, tx + 8y) over `steps` 32-deep
// steps, for a 32 x 32 output tile and 64 threads (4 x 4 outputs each).
// load_a(s, u, v) / load_b(s, u, v) read element (u, v) of step s's
// 32 x 32 operand block, v along the contiguous global axis; B_T: B's
// block is read as (column, depth) and stored transposed.  Each thread
// fetches its 16 + 16 elements of step s + 1 into registers before the
// FMAs of step s, so the L2 latency hides behind them.
template <bool B_T, typename T, typename LoadA, typename LoadB>
__device__ __forceinline__ void tile_gemm(int steps, LoadA load_a,
                                          LoadB load_b, T (&acc)[4][4]) {
  __shared__ T As[PANEL][PANEL + 1];  // [row][depth]
  __shared__ T Bs[PANEL][PANEL + 1];  // [depth][column]
  constexpr int PER = PANEL * PANEL / TILE_THREADS;
  const int tid = threadIdx.x, tx = tid & 7, ty = tid >> 3;
  T ra[PER], rb[PER];
  auto fetch = [&](int s) {
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int e = tid + TILE_THREADS * j;
      ra[j] = load_a(s, e >> 5, e & 31);
      rb[j] = load_b(s, e >> 5, e & 31);
    }
  };
  if (steps > 0) fetch(0);
  for (int s = 0; s < steps; ++s) {
    __syncthreads();
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int e = tid + TILE_THREADS * j, u = e >> 5, v = e & 31;
      As[u][v] = ra[j];
      if (B_T)
        Bs[v][u] = rb[j];
      else
        Bs[u][v] = rb[j];
    }
    __syncthreads();
    if (s + 1 < steps) fetch(s + 1);
    // each step's 32 products sum on their own before they join acc: a
    // two-level sum, whose rounding grows with 32 + steps, not 32 x steps
    T step[4][4];
    zero(step);
#pragma unroll 8
    for (int kk = 0; kk < PANEL; ++kk) {
      T a[4], b[4];
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        a[x] = As[ty + 8 * x][kk];
        b[x] = Bs[kk][tx + 8 * x];
      }
#pragma unroll
      for (int x = 0; x < 4; ++x)
#pragma unroll
        for (int y = 0; y < 4; ++y) step[x][y] += a[x] * b[y];
    }
#pragma unroll
    for (int x = 0; x < 4; ++x)
#pragma unroll
      for (int y = 0; y < 4; ++y) acc[x][y] += step[x][y];
  }
}


// C[t][i0 + i] = sum_k P[t][k] Q[i0 + i][k], with P = Q^T rows
// p0..p0+31, into the workspace's slot 0, and R[i0 + i][p0 + t] += C.
// Grid (p0 / 32, chunks, batch): each CTA sums one chunk of the
// contraction.  With several chunks, each writes its partial sums to its
// own slot and takes a ticket (an integer counter per C tile); the CTA
// that takes the last ticket adds the partials up in chunk order, so the
// sum -- and every bit of C -- is the same whichever CTA finishes last,
// and resets the counter for the next pass.
template <typename T>
__global__ void __launch_bounds__(TILE_THREADS)
block_dot_kernel(const T* __restrict__ qt, T* __restrict__ r,
                 T* __restrict__ work, unsigned* __restrict__ tickets,
                 int n, int p0, int per, int chunks, long long wstride) {
  const int b = blockIdx.z, chunk = blockIdx.y, i0 = blockIdx.x * PANEL;
  const T* P = qt + (long long)b * n * n + (long long)p0 * n;
  const T* Q = qt + (long long)b * n * n + (long long)i0 * n;
  const int k_begin = chunk * per * PANEL;
  const int steps = min(per, (n - k_begin) / PANEL);
  T acc[4][4];
  zero(acc);
  tile_gemm<true>(
      steps,
      [&](int s, int u, int v) {
        return P[(long long)u * n + k_begin + s * PANEL + v];
      },
      [&](int s, int u, int v) {
        return Q[(long long)u * n + k_begin + s * PANEL + v];
      },
      acc);
  const int tid = threadIdx.x, tx = tid & 7, ty = tid >> 3;
  T* C = work + b * wstride;  // slot s at C + s * PANEL * n, rows [t][i]
  r += (long long)b * n * n;
  if (chunks == 1) {
#pragma unroll
    for (int x = 0; x < 4; ++x)
#pragma unroll
      for (int y = 0; y < 4; ++y) {
        const int t = ty + 8 * x, i = i0 + tx + 8 * y;
        C[t * n + i] = acc[x][y];
        r[(long long)i * n + p0 + t] += acc[x][y];
      }
    return;
  }
  T* mine = C + (long long)chunk * PANEL * n;
#pragma unroll
  for (int x = 0; x < 4; ++x)
#pragma unroll
    for (int y = 0; y < 4; ++y)
      mine[(ty + 8 * x) * n + i0 + tx + 8 * y] = acc[x][y];
  __shared__ bool last;
  __threadfence();  // the partials are visible before the ticket
  __syncthreads();
  unsigned* ticket = tickets + b * (n / PANEL) + blockIdx.x;
  if (tid == 0) last = atomicAdd(ticket, 1u) == (unsigned)chunks - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  constexpr int PER = PANEL * PANEL / TILE_THREADS;
  T c[PER];
#pragma unroll
  for (int j = 0; j < PER; ++j) c[j] = T(0);
  for (int s = 0; s < chunks; ++s) {  // a chunk's 16 loads in flight at once
    const T* part = C + (long long)s * PANEL * n;
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int e = tid + TILE_THREADS * j;
      c[j] += __ldcg(part + (e >> 5) * n + i0 + (e & 31));
    }
  }
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const int e = tid + TILE_THREADS * j, t = e >> 5, i = i0 + (e & 31);
    C[t * n + i] = c[j];
    r[(long long)i * n + p0 + t] += c[j];
  }
  if (tid == 0) *ticket = 0u;
}

// P[t][k] -= sum_{i < p0} C[t][i] Q[i][k] for the CTA's 32 columns k.
// Grid (n / 32, batch).
template <typename T>
__global__ void __launch_bounds__(TILE_THREADS)
block_update_kernel(T* __restrict__ qt, const T* __restrict__ work, int n,
                    int p0, long long wstride) {
  const int b = blockIdx.y, k0 = blockIdx.x * PANEL;
  T* q = qt + (long long)b * n * n;
  const T* C = work + b * wstride;
  T acc[4][4];
  zero(acc);
  tile_gemm<false>(
      p0 / PANEL,
      [&](int s, int u, int v) { return C[u * n + s * PANEL + v]; },
      [&](int s, int u, int v) {
        return q[(long long)(s * PANEL + u) * n + k0 + v];
      },
      acc);
  const int tx = threadIdx.x & 7, ty = threadIdx.x >> 3;
#pragma unroll
  for (int x = 0; x < 4; ++x)
#pragma unroll
    for (int y = 0; y < 4; ++y)
      q[(long long)(p0 + ty + 8 * x) * n + k0 + tx + 8 * y] -= acc[x][y];
}

// Sum over the block; every thread returns the same value (summed in the
// same order).  Must be reached by all threads.
template <typename T>
__device__ T block_sum(T v, T* red) {
  v = warp_sum(v);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  T s = T(0);
#pragma unroll
  for (int w = 0; w < PANEL_THREADS / 32; ++w) s += red[w];
  return s;
}

// The in-panel CGS2 of columns p0..p0+31, one CTA of 256 threads per
// matrix: per pass, warp w forms the dots of columns w, w + 8, w + 16 and
// w + 24 (those below t) side by side, then every thread updates its own
// entries; then R's diagonal block and, with rinv, S = (R_PP)^{-1} into
// W's diagonal block.
template <typename T>
__global__ void __launch_bounds__(PANEL_THREADS)
panel_kernel(T* __restrict__ qt, T* __restrict__ r, T* __restrict__ rinv,
             int n, int p0) {
  constexpr int threads = PANEL_THREADS, warps = PANEL_THREADS / 32;
  constexpr int DOTS = PANEL / warps;  // dots per warp and pass
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* P = reinterpret_cast<T*>(smem_raw);  // PANEL x n: rows = panel columns
  T* rpp = P + PANEL * n;                 // PANEL x (PANEL + 1): R_PP
  T* S = rpp + PANEL * (PANEL + 1);       // PANEL x (PANEL + 1): R_PP^{-1}
  T* c1 = S + PANEL * (PANEL + 1);        // in-panel pass-1 coefficients
  T* c2 = c1 + PANEL;                     // in-panel pass-2 coefficients
  T* red = c2 + PANEL;                    // one partial sum per warp

  const long long off = (long long)blockIdx.x * n * n;
  T* q = qt + off + (long long)p0 * n;
  r += off;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  for (int k = tid; k < n; k += threads) {
#pragma unroll
    for (int s0 = 0; s0 < PANEL; s0 += 8) {
      T col[8];  // eight loads in flight before the stores
#pragma unroll
      for (int s = 0; s < 8; ++s) col[s] = q[(long long)(s0 + s) * n + k];
#pragma unroll
      for (int s = 0; s < 8; ++s) P[(s0 + s) * n + k] = col[s];
    }
  }
  __syncthreads();

  for (int t = 0; t < PANEL; ++t) {
    T* y = P + t * n;
    for (int pass = 0; pass < 2; ++pass) {
      T* cc = pass ? c2 : c1;
      if (warp < t) {
        T acc[DOTS];
#pragma unroll
        for (int m = 0; m < DOTS; ++m) acc[m] = T(0);
#pragma unroll 4
        for (int k = lane; k < n; k += 32) {
          const T yk = y[k];
#pragma unroll
          for (int m = 0; m < DOTS; ++m)
            if (warp + warps * m < t)
              acc[m] += P[(warp + warps * m) * n + k] * yk;
        }
#pragma unroll
        for (int m = 0; m < DOTS; ++m) acc[m] = warp_sum(acc[m]);
        if (lane == 0) {
#pragma unroll
          for (int m = 0; m < DOTS; ++m)
            if (warp + warps * m < t) cc[warp + warps * m] = acc[m];
        }
      }
      __syncthreads();
      for (int k = tid; k < n; k += threads) {
        T acc = T(0);
        for (int s = 0; s < t; ++s) acc += cc[s] * P[s * n + k];
        y[k] -= acc;
      }
      __syncthreads();
    }
    T part = T(0);
    for (int k = tid; k < n; k += threads) part += y[k] * y[k];
    const T nrm = sqrt(block_sum(part, red));
    const T safe = nrm == T(0) ? T(1) : nrm;
    for (int k = tid; k < n; k += threads) y[k] = y[k] / safe;
    if (tid < t) rpp[tid * (PANEL + 1) + t] = c1[tid] + c2[tid];
    if (tid == 0) rpp[t * (PANEL + 1) + t] = nrm;
    __syncthreads();
  }

  for (int e = tid; e < PANEL * n; e += threads) q[e] = P[e];
  for (int e = tid; e < PANEL * PANEL; e += threads) {
    const int i = e >> 5, j = e & 31;
    if (i <= j) r[(long long)(p0 + i) * n + p0 + j] = rpp[i * (PANEL + 1) + j];
  }
  if (rinv == nullptr) return;

  // S = R_PP^{-1} by back substitution, R_PP S = I, lane j owning column
  // j (columns are independent, so the warp needs no synchronization)
  if (warp == 0) {
    const int j = lane;
    for (int i = PANEL - 1; i >= 0; --i) {
      T acc = i == j ? T(1) : T(0);
      for (int l = i + 1; l <= j; ++l)
        acc -= rpp[i * (PANEL + 1) + l] * S[l * (PANEL + 1) + j];
      const T d = rpp[i * (PANEL + 1) + i];
      S[i * (PANEL + 1) + j] = i <= j ? acc / (d == T(0) ? T(1) : d) : T(0);
    }
  }
  __syncthreads();
  rinv += off;
  for (int e = tid; e < PANEL * PANEL; e += threads) {
    const int i = e >> 5, j = e & 31;
    if (i <= j)
      rinv[(long long)(p0 + i) * n + p0 + j] = S[i * (PANEL + 1) + j];
  }
}

// X = R[:p0, P] S (p0 x 32) into the workspace, with S the diagonal block
// of W that panel_kernel wrote.  Grid (p0 / 32, batch).
template <typename T>
__global__ void __launch_bounds__(TILE_THREADS)
x_kernel(const T* __restrict__ r, const T* __restrict__ rinv,
         T* __restrict__ work, int n, int p0, long long wstride,
         long long x_offset) {
  const int b = blockIdx.y, i0 = blockIdx.x * PANEL;
  const T* rb = r + (long long)b * n * n;
  const T* wb = rinv + (long long)b * n * n;
  T acc[4][4];
  zero(acc);
  tile_gemm<false>(
      1,
      [&](int, int u, int v) { return rb[(long long)(i0 + u) * n + p0 + v]; },
      [&](int, int u, int v) { return wb[(long long)(p0 + u) * n + p0 + v]; },
      acc);
  const int tx = threadIdx.x & 7, ty = threadIdx.x >> 3;
  T* X = work + b * wstride + x_offset;
#pragma unroll
  for (int x = 0; x < 4; ++x)
#pragma unroll
    for (int y = 0; y < 4; ++y)
      X[(i0 + ty + 8 * x) * PANEL + tx + 8 * y] = acc[x][y];
}

// W[i][p0 + j] = -sum_{l in [i0, p0)} W[i][l] X[l][j] for the CTA's rows
// i0..i0+31 (W[i][l] = 0 for l < i): the block column of R W = I,
// R[:p0, :p0] W[:p0, P] = -R[:p0, P] S, through the inverse already built.
// Grid (p0 / 32, batch).
template <typename T>
__global__ void __launch_bounds__(TILE_THREADS)
cross_kernel(T* __restrict__ rinv, const T* __restrict__ work, int n,
             int p0, long long wstride, long long x_offset) {
  const int b = blockIdx.y, i0 = blockIdx.x * PANEL;
  T* w = rinv + (long long)b * n * n;
  const T* X = work + b * wstride + x_offset;
  T acc[4][4];
  zero(acc);
  tile_gemm<false>(
      (p0 - i0) / PANEL,
      [&](int s, int u, int v) {
        return w[(long long)(i0 + u) * n + i0 + s * PANEL + v];
      },
      [&](int s, int u, int v) {
        return X[(i0 + s * PANEL + u) * PANEL + v];
      },
      acc);
  const int tx = threadIdx.x & 7, ty = threadIdx.x >> 3;
#pragma unroll
  for (int x = 0; x < 4; ++x)
#pragma unroll
    for (int y = 0; y < 4; ++y)
      w[(long long)(i0 + ty + 8 * x) * n + p0 + tx + 8 * y] = -acc[x][y];
}

#define DQMC_CHECK(expr)                           \
  do {                                             \
    const cudaError_t e_ = (expr);                 \
    if (e_ != cudaSuccess) return (int)e_;         \
  } while (0)

template <typename T>
int launch_cgs2(const T* at, T* qt, T* r, T* rinv, T* work, int batch, int n,
                void* stream_ptr) {
  // float32: panel_kernel's 4 (32 n + 2 32 33 + 72) bytes <= 232,448
  const int max_n = sizeof(T) == 4 ? 1728 : 512;
  if (n <= 0 || n % PANEL != 0 || n > max_n || batch <= 0 || batch > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  const size_t bytes = sizeof(T) * (size_t)batch * n * n;
  const long long x_offset = (long long)max_chunks(n) * PANEL * n;
  const long long wstride = x_offset + (long long)n * PANEL;
  const size_t smem = sizeof(T) * ((size_t)PANEL * n +
                                   2 * PANEL * (PANEL + 1) + 2 * PANEL +
                                   PANEL_THREADS / 32);
  DQMC_CHECK(cudaFuncSetAttribute(panel_kernel<T>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)smem));
  DQMC_CHECK(cudaMemcpyAsync(qt, at, bytes, cudaMemcpyDeviceToDevice,
                             stream));
  DQMC_CHECK(cudaMemsetAsync(r, 0, bytes, stream));
  if (rinv) DQMC_CHECK(cudaMemsetAsync(rinv, 0, bytes, stream));
  // the tickets sit after the last matrix's X block
  unsigned* tickets = reinterpret_cast<unsigned*>(work + batch * wstride);
  DQMC_CHECK(cudaMemsetAsync(tickets, 0,
                             sizeof(unsigned) * batch * (n / PANEL), stream));

  for (int p0 = 0; p0 < n; p0 += PANEL) {
    const int tiles = p0 / PANEL;
    if (p0 > 0) {
      const Split sp = dot_split(n, p0);
      for (int pass = 0; pass < 2; ++pass) {
        block_dot_kernel<T>
            <<<dim3(tiles, sp.chunks, batch), TILE_THREADS, 0, stream>>>(
                qt, r, work, tickets, n, p0, sp.per, sp.chunks, wstride);
        DQMC_CHECK(cudaGetLastError());
        block_update_kernel<T>
            <<<dim3(n / PANEL, batch), TILE_THREADS, 0, stream>>>(
                qt, work, n, p0, wstride);
        DQMC_CHECK(cudaGetLastError());
      }
    }
    panel_kernel<T><<<batch, PANEL_THREADS, smem, stream>>>(qt, r, rinv, n,
                                                            p0);
    DQMC_CHECK(cudaGetLastError());
    if (rinv && p0 > 0) {
      x_kernel<T><<<dim3(tiles, batch), TILE_THREADS, 0, stream>>>(
          r, rinv, work, n, p0, wstride, x_offset);
      DQMC_CHECK(cudaGetLastError());
      cross_kernel<T><<<dim3(tiles, batch), TILE_THREADS, 0, stream>>>(
          rinv, work, n, p0, wstride, x_offset);
      DQMC_CHECK(cudaGetLastError());
    }
  }
  return (int)cudaSuccess;
}

}  // namespace

extern "C" int dqmc_cgs2_qr_f32(const float* at, float* qt, float* r,
                                float* rinv, float* work, int batch, int n,
                                void* stream) {
  return launch_cgs2<float>(at, qt, r, rinv, work, batch, n, stream);
}

extern "C" int dqmc_cgs2_qr_f64(const double* at, double* qt, double* r,
                                double* rinv, double* work, int batch, int n,
                                void* stream) {
  return launch_cgs2<double>(at, qt, r, rinv, work, batch, n, stream);
}

// Elements of T the `work` buffer of dqmc_cgs2_qr_f32/_f64 must hold.
extern "C" long long dqmc_cgs2_workspace(int batch, int n) {
  return workspace_elems(batch, n);
}

extern "C" const char* dqmc_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
