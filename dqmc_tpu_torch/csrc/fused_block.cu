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
//                      one slice, one thread-block cluster per walker: each
//                      site forms its effective row and column of G from
//                      the pending rank-k U/V buffers, decides u < R with
//                      R = gb (1 + (1 - G_ii) delta)^2, writes one U/V slot
//                      and the accept mask, and every k sites flushes
//                      G += U^T V.  Two flavors: the same cluster keeps
//                      both (site_loop_2f_kernel).
//   site_loop_sub_kernel the same slice by the submatrix scheme, on the
//                      same clusters: per group of k sites, the k decisions
//                      on k x k data (warp 0 of every CTA, on the same
//                      bits), then G += G[:, I] W (G[I, :] - E_I) over the
//                      cluster (submatrix_decide.cuh).
//
// What bounds it on an H100: the site loop is a chain of ns dependent
// visits per slice, and every k visits a rank-k flush streams all of G
// (2 k ns^2 FLOPs).  On one CTA per walker (the first design) the flush ran
// on W of 132 SMs, one thread per column, and took 69% of the slice (79%
// with two flavors; scripts/seed_split.py sites); the visits waited on L2
// for a strided column of G each.
// The wraps are 2 ns^3 FLOPs per matrix on data that sits in L2: bound by
// the FP32 FMA rate (67 TFLOP/s, 8 us for the headline's 16 x 256^3), and
// in practice by how well the tiles feed the FMA units from shared memory
// and how many SMs they fill.
//
// What the design does about it: the wraps leave the sequential kernel and
// run as a tiled FFMA GEMM over (tiles x walkers) CTAs, so all SMs share
// them.  The tile follows n: 64 x 64 with an 8 x 4 register tile per
// thread (float32) from n = 65 (256 CTAs at the headline), 32 x 64 with
// 4 x 4 below.  A and B arrive in 16-byte loads; A is transposed (and
// scaled by m) on its way into a padded shared tile, so the FMA loop reads
// both operands as 16-byte shared loads; the shared tiles are
// double-buffered, with the next tile's global loads in flight during the
// current tile's FMAs (staged through registers rather than cp.async,
// because of that transpose and scale).  When B is shared by the batch
// (every wrap's second product), the walkers' rows form one tall GEMM, so
// a ragged n wastes one partial row tile in all instead of one per walker.
// It stays about 1.3x behind cuBLAS's FP32 GEMM at the headline: 22
// TFLOP/s, a third of the FP32 FMA peak, against cuBLAS's 31; none of the
// twelve tile shapes scripts/wrap_gemm_tiles.py times comes within 1.25x.
//
// The site loop spreads each walker over a thread-block cluster of C CTAs
// (C = 2 ... 16 from ns, so that a CTA owns at most 32 indices: 8 at the
// headline's ns = 256, 128 CTAs for 16 walkers), in the body it shares with
// the per-slice engine's delayed slice (site_loop.cuh): a CTA keeps U and V
// only for its own indices and the group's panels of G, the owner of a
// pending U/V entry sends it to every CTA with st.async, each CTA takes
// every decision itself on the same bits, and the flush runs on all C SMs
// at once.  G stays in global memory (L2).  Every shape of the JAX kernel
// fits (ns <= 512, k <= 32, one or two flavors, f32 or f64: at most 119,680
// bytes of shared memory).
// Plain FP32/FP64 FMA, no tensor cores; no atomics, so a second call gives
// the same bits, and the same bits as the one-CTA loop it replaced.
// The submatrix loop had kept one CTA per walker (its flush operands, 2 k
// ns elements, in that CTA's shared memory: no float64 at ns >= 448; its
// flush one thread per column in the CTA).  It now runs on the same
// clusters: each CTA gathers G[I, I] and decides on the same bits while
// its other warps load its share of the flush operands, forms M at its own
// columns, and flushes its own rows by column as the delayed loop does,
// with M read from its owners' shared memory; every ns <= 512 fits in both
// float types (at most 69,120 bytes of shared memory).

#include <cuda_runtime.h>

#include "site_loop.cuh"
#include "submatrix_decide.cuh"

namespace {

using dqmc::SITE_THREADS;  // the delayed loop's CTA
using dqmc::Vec;
constexpr int KMAX = dqmc::SITE_KMAX;

// C = diag(r) A diag(m) B diag(c) for a batch, one BM x BN output tile per
// CTA and a TM x TN register tile per thread, BK deep per shared tile.
// stacked (B shared, A per walker): the W x n rows of A and C form one
// tall matrix of `rows` rows, tiled as one GEMM; otherwise blockIdx.z is
// the walker and rows = n.  The tiles of A (transposed and scaled by m on
// the way) and B are staged in two shared buffers: the loads of tile k+1
// go out to registers before the FMAs of tile k and land in the other
// buffer after them.  VEC: 16-byte loads and stores (n a multiple of
// 16 / sizeof(T), 16-byte aligned pointers); ragged edges read zeros.
template <typename T, int BM, int BN, int TM, int TN, int BK, bool VEC>
__global__ void __launch_bounds__((BM / TM) * (BN / TN))
wrap_gemm_kernel(T* __restrict__ C, const T* __restrict__ A, long long sA,
                 const T* __restrict__ B, long long sB,
                 const T* __restrict__ rv, const T* __restrict__ mv,
                 const T* __restrict__ cv, long long sV, int n, int rows,
                 bool stacked) {
  constexpr int THREADS = (BM / TM) * (BN / TN);
  constexpr int VW = 16 / sizeof(T);
  constexpr int A_VECS = BM * BK / VW / THREADS;
  constexpr int B_VECS = BK * BN / VW / THREADS;
  static_assert(A_VECS * VW * THREADS == BM * BK, "A tile split");
  static_assert(B_VECS * VW * THREADS == BK * BN, "B tile split");
  static_assert(TM % 4 == 0 && TN % 4 == 0, "register tile width");
  // rows padded by 4 elements: 16-byte aligned, and the transposed stores
  // of A land on at most two threads per bank
  __shared__ __align__(16) T As[2][BK][BM + 4];
  __shared__ __align__(16) T Bs[2][BK][BN + 4];

  const int tid = threadIdx.x;
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;
  // the walker and local row of global row gr; false past the last row
  auto locate = [&](int gr, int& w, int& lr) {
    if (stacked) {
      w = gr / n;
      lr = gr - w * n;
      return gr < rows;
    }
    w = blockIdx.z;
    lr = gr;
    return gr < n;
  };

  // the rows and depths this thread loads, fixed for the whole k loop
  const T* a_src[A_VECS];
  const T* m_src[A_VECS];
  int a_r[A_VECS], a_k[A_VECS];
  bool a_ok[A_VECS];
#pragma unroll
  for (int i = 0; i < A_VECS; ++i) {
    const int e = tid + i * THREADS;
    a_r[i] = e / (BK / VW);
    a_k[i] = (e % (BK / VW)) * VW;
    int w, lr;
    a_ok[i] = locate(row0 + a_r[i], w, lr);
    a_src[i] = A + w * sA + (long long)lr * n;
    m_src[i] = mv ? mv + w * sV : nullptr;
  }
  int b_k[B_VECS], b_c[B_VECS];
#pragma unroll
  for (int i = 0; i < B_VECS; ++i) {
    const int e = tid + i * THREADS;
    b_k[i] = e / (BN / VW);
    b_c[i] = (e % (BN / VW)) * VW;
  }
  const T* Bw = B + (stacked ? 0 : blockIdx.z * sB);

  T ra[A_VECS][VW], rb[B_VECS][VW];
  auto load = [&](int k0) {
#pragma unroll
    for (int i = 0; i < A_VECS; ++i) {
      const int k = k0 + a_k[i];
      if (VEC) {
        Vec<T> v{};
        if (a_ok[i] && k < n) v = *reinterpret_cast<const Vec<T>*>(a_src[i] + k);
#pragma unroll
        for (int j = 0; j < VW; ++j)
          ra[i][j] = m_src[i] && a_ok[i] && k < n ? v.v[j] * m_src[i][k + j]
                                                  : v.v[j];
      } else {
#pragma unroll
        for (int j = 0; j < VW; ++j) {
          const int kk = k + j;
          T v = T(0);
          if (a_ok[i] && kk < n) {
            v = a_src[i][kk];
            if (m_src[i]) v *= m_src[i][kk];
          }
          ra[i][j] = v;
        }
      }
    }
#pragma unroll
    for (int i = 0; i < B_VECS; ++i) {
      const int k = k0 + b_k[i], c = col0 + b_c[i];
      if (VEC) {
        Vec<T> v{};
        if (k < n && c < n)
          v = *reinterpret_cast<const Vec<T>*>(Bw + (long long)k * n + c);
#pragma unroll
        for (int j = 0; j < VW; ++j) rb[i][j] = v.v[j];
      } else {
#pragma unroll
        for (int j = 0; j < VW; ++j)
          rb[i][j] = k < n && c + j < n ? Bw[(long long)k * n + c + j] : T(0);
      }
    }
  };
  auto store = [&](int buf) {
#pragma unroll
    for (int i = 0; i < A_VECS; ++i)
#pragma unroll
      for (int j = 0; j < VW; ++j) As[buf][a_k[i] + j][a_r[i]] = ra[i][j];
#pragma unroll
    for (int i = 0; i < B_VECS; ++i) {
      Vec<T> v;
#pragma unroll
      for (int j = 0; j < VW; ++j) v.v[j] = rb[i][j];
      *reinterpret_cast<Vec<T>*>(&Bs[buf][b_k[i]][b_c[i]]) = v;
    }
  };

  // a thread's rows (columns) come in groups of four, the groups BM / (TM
  // / 4) apart, so the four-wide shared reads of a warp's threads fall on
  // distinct banks
  const int tr = tid / (BN / TN), tc = tid % (BN / TN);
  auto row_of = [](int tr_, int x) {
    return (x / 4) * (BM / (TM / 4)) + tr_ * 4 + x % 4;
  };
  auto col_of = [](int tc_, int y) {
    return (y / 4) * (BN / (TN / 4)) + tc_ * 4 + y % 4;
  };
  T acc[TM][TN];
#pragma unroll
  for (int x = 0; x < TM; ++x)
#pragma unroll
    for (int y = 0; y < TN; ++y) acc[x][y] = T(0);

  const int n_tiles = (n + BK - 1) / BK;
  load(0);
  store(0);
  __syncthreads();
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int buf = kt & 1;
    const bool more = kt + 1 < n_tiles;
    if (more) load((kt + 1) * BK);
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      T a[TM], b[TN];
#pragma unroll
      for (int x = 0; x < TM; x += VW) {
        const Vec<T> v =
            *reinterpret_cast<const Vec<T>*>(&As[buf][kk][row_of(tr, x)]);
#pragma unroll
        for (int j = 0; j < VW; ++j) a[x + j] = v.v[j];
      }
#pragma unroll
      for (int y = 0; y < TN; y += VW) {
        const Vec<T> v =
            *reinterpret_cast<const Vec<T>*>(&Bs[buf][kk][col_of(tc, y)]);
#pragma unroll
        for (int j = 0; j < VW; ++j) b[y + j] = v.v[j];
      }
#pragma unroll
      for (int x = 0; x < TM; ++x)
#pragma unroll
        for (int y = 0; y < TN; ++y) acc[x][y] += a[x] * b[y];
    }
    if (more) store(buf ^ 1);
    __syncthreads();
  }

#pragma unroll
  for (int x = 0; x < TM; ++x) {
    int w, lr;
    if (!locate(row0 + row_of(tr, x), w, lr)) continue;
    T* crow = C + (long long)w * n * n + (long long)lr * n;
    const T rs = rv ? rv[w * sV + lr] : T(1);
    const T* cs = cv ? cv + w * sV : nullptr;
#pragma unroll
    for (int y = 0; y < TN; y += VW) {
      const int c = col0 + col_of(tc, y);
      Vec<T> v;
#pragma unroll
      for (int j = 0; j < VW; ++j) {
        T e = acc[x][y + j];
        if (rv) e = rs * e;
        if (cs && c + j < n) e = e * cs[c + j];
        v.v[j] = e;
      }
      if (VEC) {
        if (c < n) *reinterpret_cast<Vec<T>*>(crow + c) = v;
      } else {
#pragma unroll
        for (int j = 0; j < VW; ++j)
          if (c + j < n) crow[c + j] = v.v[j];
      }
    }
  }
}

// Two CTAs per SM at most 128 registers each: a cluster of 8 then finds
// room on any 4 SMs of a GPC.  The body is site_loop.cuh's, with R <= 32.
template <typename T>
__global__ void __launch_bounds__(SITE_THREADS, 2)
site_loop_kernel(const dqmc::SiteLoopArgs<T> args) {
  dqmc::site_loop_body<T, 1, 32>(args);
}

template <typename T>
__global__ void __launch_bounds__(SITE_THREADS, 2)
site_loop_2f_kernel(const dqmc::SiteLoopArgs<T> args) {
  dqmc::site_loop_body<T, 2, 32>(args);
}

// One slice of the submatrix scheme (one stored flavor) on one cluster per
// walker, R <= 32 indices per CTA: submatrix_decide.cuh's body, gb and
// delta indexed by site.
// Two CTAs per SM in float32; one in float64, whose decision warp keeps W
// in 128 registers.
template <typename T>
__global__ void __launch_bounds__(SITE_THREADS, sizeof(T) == 4 ? 2 : 1)
site_loop_sub_kernel(const dqmc::SiteLoopArgs<T> args) {
  dqmc::submatrix_slice_body<T>(args);
}

template <typename T, int BM, int BN, int TM, int TN, int BK>
int launch_gemm_tiles(T* C, const T* A, long long sA, const T* B,
                      long long sB, const T* rv, const T* mv, const T* cv,
                      long long sV, int n, int batch, cudaStream_t stream) {
  constexpr int VW = 16 / sizeof(T);
  // B shared by the batch: the walkers' rows of A and C are one tall GEMM
  const bool stacked = sB == 0 && sA == (long long)n * n;
  const int rows = stacked ? batch * n : n;
  const dim3 grid((n + BN - 1) / BN, (rows + BM - 1) / BM,
                  stacked ? 1 : batch);
  if (grid.y > 65535 || grid.z > 65535) return (int)cudaErrorInvalidValue;
  const auto aligned = [](const void* p) {
    return reinterpret_cast<unsigned long long>(p) % 16 == 0;
  };
  const bool vec = n % VW == 0 && sA % VW == 0 && sB % VW == 0 &&
                   aligned(A) && aligned(B) && aligned(C);
  constexpr int threads = (BM / TM) * (BN / TN);
  if (vec)
    wrap_gemm_kernel<T, BM, BN, TM, TN, BK, true><<<grid, threads, 0, stream>>>(
        C, A, sA, B, sB, rv, mv, cv, sV, n, rows, stacked);
  else
    wrap_gemm_kernel<T, BM, BN, TM, TN, BK, false><<<grid, threads, 0, stream>>>(
        C, A, sA, B, sB, rv, mv, cv, sV, n, rows, stacked);
  return (int)cudaGetLastError();
}

// The tile from n (chosen among eleven shapes by scripts/wrap_gemm_tiles.py
// on an H100): 64 x 64 tiles from n = 65 (the headline's (16, 256) gives
// 256 CTAs, two per SM), with 128 threads of 8 x 4 outputs in float32 (32
// FMAs per three 16-byte shared loads) and 256 threads of 4 x 4 in float64
// (registers); 32 x 64 tiles of 128 threads (4 x 4 each) below, where a
// 64-row tile would be mostly padding (examples/basic's n = 36; the
// repulsive preset's 64 chains of n = 64 give 128 CTAs).
template <typename T>
int launch_gemm(T* C, const T* A, long long sA, const T* B, long long sB,
                const T* rv, const T* mv, const T* cv, long long sV, int n,
                int batch, void* stream) {
  if (n <= 0 || batch <= 0 || batch > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (n > 64)
    return launch_gemm_tiles<T, 64, 64, sizeof(T) == 4 ? 8 : 4, 4, 16>(
        C, A, sA, B, sB, rv, mv, cv, sV, n, batch, st);
  return launch_gemm_tiles<T, 32, 64, 4, 4, 16>(C, A, sA, B, sB, rv, mv, cv,
                                                sV, n, batch, st);
}

template <typename T, int NFL>
int launch_sites(T* G, T* mask, long long s_mask, const int* order,
                 const T* gb, const T* delta, const T* us, long long s_stream,
                 T* sgn, int n, int k, int batch, void* stream) {
  if (n <= 0 || n > 512 || k <= 0 || k > KMAX || n % k != 0 || batch <= 0 ||
      batch > 65535 || (NFL == 2 && sgn == nullptr))
    return (int)cudaErrorInvalidValue;
  static dqmc::SiteLaunchCache caches;
  const dqmc::SiteLoopArgs<T> args{G,  mask,  s_mask,   order, 0,   gb, delta,
                                   us, s_stream, sgn, n,     k,   false};
  return dqmc::launch_site_loop<T>(
      NFL == 1 ? site_loop_kernel<T> : site_loop_2f_kernel<T>, caches, args,
      dqmc::site_smem_bytes<T>(n, k, NFL, 32), 32, batch, stream);
}

template <typename T>
int launch_sites_sub(T* G, T* mask, long long s_mask, const int* order,
                     const T* gb, const T* delta, const T* us,
                     long long s_stream, int n, int k, int batch,
                     void* stream) {
  if (n <= 0 || n > 512 || k <= 0 || k > KMAX || n % k != 0 || batch <= 0 ||
      batch > 65535)
    return (int)cudaErrorInvalidValue;
  static dqmc::SiteLaunchCache caches;
  const dqmc::SiteLoopArgs<T> args{G,  mask,     s_mask,  order, 0, gb, delta,
                                   us, s_stream, nullptr, n,     k, false};
  return dqmc::launch_site_loop<T>(site_loop_sub_kernel<T>, caches, args,
                                   dqmc::sub_smem_bytes<T>(n, k),
                                   dqmc::SUB_RMAX, batch, stream);
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

// The dynamic shared memory of one CTA of the submatrix site loop's
// cluster (R <= 32) at n sites, rank k, itemsize 4 or 8 (ops/kernels.py
// submatrix_slice_smem mirrors it for the host).
extern "C" long long dqmc_sub_smem_bytes(int n, int k, int itemsize) {
  return itemsize == 8 ? dqmc::sub_smem_bytes<double>(n, k)
                       : dqmc::sub_smem_bytes<float>(n, k);
}
