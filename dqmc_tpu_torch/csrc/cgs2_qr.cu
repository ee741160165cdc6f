// K1: batched CGS2 QR factorization, optionally with R^{-1}.
//
// Replaces: dqmc_tpu/ops/qr_kernel.py::_cgs2_kernel (the Pallas TPU kernel
// behind cgs2_qr / cgs2_qr_inv), which every LDR fold (to_ldr) and every
// stabilized solve and log-det (_qr_solve_logdet) of the main path runs.
//
// What it computes, per matrix A (n x n, n a multiple of 32, n <= 512):
// classical Gram-Schmidt with reorthogonalization (CGS2) on the columns of
// A, in 32-column panels.  Every column receives two complete projection
// passes against all earlier columns: two block passes against the finished
// panels, then two in-panel passes against the earlier columns of its own
// panel.  R is accumulated from the projection coefficients of both passes
// (never rebuilt as triu(Q^T A), which costs chain accuracy), its diagonal
// is the column norm (>= 0), and the optional W = R^{-1} is formed by
// back substitution.  The kernel works on A^T, so a column of A is a
// contiguous row: the caller passes A^T and receives Q^T.
//
// What bounds it on an H100: the in-panel column loop is a chain of
// dependent block reductions (one __syncthreads-separated dot/axpy pair per
// pass per column), so a matrix is latency-bound, not FLOP-bound.  One CTA
// per matrix means a batch of B = W = 4..16 matrices occupies 4..16 of the
// 132 SMs.  Q^T lives in global memory (L2 holds 16 x 256 KB at the
// headline size); the current 32-row panel is staged in shared memory
// (32 KB at n = 256 f32, 128 KB at n = 512 f64).
//
// What the design does about it: the block passes, which hold most of the
// FLOPs, read Q^T rows coalesced and keep 32 accumulators per thread in
// registers; coefficients are staged through shared memory in 32 x 32
// chunks so the inner loop reads them as broadcasts.  Plain FP32/FP64 FMA,
// no tensor cores.  Spreading one matrix over a cluster of CTAs is left to
// a later change.

#include <cuda_runtime.h>

namespace {

constexpr int PANEL = 32;
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
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
  for (int w = 0; w < WARPS; ++w) s += red[w];
  return s;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
cgs2_qr_kernel(const T* __restrict__ at, T* __restrict__ qt, T* __restrict__ r,
               T* __restrict__ rinv, T* __restrict__ cbuf, int n) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* P = reinterpret_cast<T*>(smem_raw);  // PANEL x n: rows = panel columns
  T* Cs = P + PANEL * n;                  // PANEL x PANEL coefficient chunk
  T* c1 = Cs + PANEL * PANEL;             // in-panel pass-1 coefficients
  T* c2 = c1 + PANEL;                     // in-panel pass-2 coefficients
  T* red = c2 + PANEL;                    // WARPS partial sums

  const long long off = (long long)blockIdx.x * n * n;
  at += off;
  qt += off;
  r += off;
  if (rinv) rinv += off;
  T* C = cbuf + (long long)blockIdx.x * PANEL * n;  // one pass's coefficients

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (long long e = tid; e < (long long)n * n; e += THREADS) r[e] = T(0);

  for (int p0 = 0; p0 < n; p0 += PANEL) {
    for (int e = tid; e < PANEL * n; e += THREADS)
      P[e] = at[(long long)p0 * n + e];
    __syncthreads();

    // ---- two block passes against the finished columns 0..p0-1 ----
    for (int pass = 0; pass < 2 && p0 > 0; ++pass) {
      // C[t][i] = <P_t, q_i>: one warp per finished column i
      for (int i = warp; i < p0; i += WARPS) {
        const T* q = qt + (long long)i * n;
        T acc[PANEL];
#pragma unroll
        for (int t = 0; t < PANEL; ++t) acc[t] = T(0);
        for (int k = lane; k < n; k += 32) {
          const T qk = q[k];
#pragma unroll
          for (int t = 0; t < PANEL; ++t) acc[t] += P[t * n + k] * qk;
        }
#pragma unroll
        for (int t = 0; t < PANEL; ++t) {
          const T s = warp_sum(acc[t]);
          if (lane == 0) {
            C[t * n + i] = s;
            r[(long long)i * n + p0 + t] += s;  // R from the coefficients
          }
        }
      }
      __syncthreads();
      // P_t -= sum_i C[t][i] q_i  (classical: all C from the same P)
      for (int k0 = 0; k0 < n; k0 += THREADS) {
        const int k = k0 + tid;
        T acc[PANEL];
#pragma unroll
        for (int t = 0; t < PANEL; ++t) acc[t] = T(0);
        for (int i0 = 0; i0 < p0; i0 += PANEL) {
          __syncthreads();
          for (int e = tid; e < PANEL * PANEL; e += THREADS)
            Cs[e] = C[(e / PANEL) * n + i0 + e % PANEL];
          __syncthreads();
          if (k < n) {
            for (int ii = 0; ii < PANEL; ++ii) {
              const T qk = qt[(long long)(i0 + ii) * n + k];
#pragma unroll
              for (int t = 0; t < PANEL; ++t) acc[t] += Cs[t * PANEL + ii] * qk;
            }
          }
        }
        if (k < n) {
#pragma unroll
          for (int t = 0; t < PANEL; ++t) P[t * n + k] -= acc[t];
        }
      }
      __syncthreads();
    }

    // ---- in-panel CGS2, one column at a time ----
    for (int t = 0; t < PANEL; ++t) {
      T* y = P + t * n;
      for (int pass = 0; pass < 2; ++pass) {
        T* cc = pass ? c2 : c1;
        for (int s = warp; s < t; s += WARPS) {
          T acc = T(0);
          for (int k = lane; k < n; k += 32) acc += P[s * n + k] * y[k];
          acc = warp_sum(acc);
          if (lane == 0) cc[s] = acc;
        }
        __syncthreads();
        for (int k = tid; k < n; k += THREADS) {
          T acc = T(0);
          for (int s = 0; s < t; ++s) acc += cc[s] * P[s * n + k];
          y[k] -= acc;
        }
        __syncthreads();
      }
      T part = T(0);
      for (int k = tid; k < n; k += THREADS) part += y[k] * y[k];
      const T nrm = sqrt(block_sum(part, red));
      const T safe = nrm == T(0) ? T(1) : nrm;
      for (int k = tid; k < n; k += THREADS) y[k] = y[k] / safe;
      if (tid < t) r[(long long)(p0 + tid) * n + p0 + t] += c1[tid] + c2[tid];
      if (tid == 0) r[(long long)(p0 + t) * n + p0 + t] = nrm;
      __syncthreads();
    }

    for (int e = tid; e < PANEL * n; e += THREADS)
      qt[(long long)p0 * n + e] = P[e];
    __syncthreads();
  }

  if (rinv == nullptr) return;
  // W = R^{-1} (upper triangular): each thread back-substitutes its own
  // columns, so no synchronization is needed beyond R being complete.
  for (int j = tid; j < n; j += THREADS) {
    for (int i = n - 1; i > j; --i) rinv[(long long)i * n + j] = T(0);
    for (int i = j; i >= 0; --i) {
      T acc = (i == j) ? T(1) : T(0);
      for (int k = i + 1; k <= j; ++k)
        acc -= r[(long long)i * n + k] * rinv[(long long)k * n + j];
      const T d = r[(long long)i * n + i];
      rinv[(long long)i * n + j] = acc / (d == T(0) ? T(1) : d);
    }
  }
}

template <typename T>
int launch_cgs2(const T* at, T* qt, T* r, T* rinv, T* cbuf, int batch, int n,
                void* stream) {
  if (n <= 0 || n % PANEL != 0 || n > 512 || batch <= 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem =
      sizeof(T) * ((size_t)PANEL * n + PANEL * PANEL + 2 * PANEL + WARPS);
  cudaError_t err = cudaFuncSetAttribute(
      cgs2_qr_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  cgs2_qr_kernel<T><<<batch, THREADS, smem, (cudaStream_t)stream>>>(
      at, qt, r, rinv, cbuf, n);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int dqmc_cgs2_qr_f32(const float* at, float* qt, float* r,
                                float* rinv, float* cbuf, int batch, int n,
                                void* stream) {
  return launch_cgs2<float>(at, qt, r, rinv, cbuf, batch, n, stream);
}

extern "C" int dqmc_cgs2_qr_f64(const double* at, double* qt, double* r,
                                double* rinv, double* cbuf, int batch, int n,
                                void* stream) {
  return launch_cgs2<double>(at, qt, r, rinv, cbuf, batch, n, stream);
}

extern "C" const char* dqmc_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
