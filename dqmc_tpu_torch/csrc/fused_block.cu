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
//   site_loop_sub_kernel the same slice by the submatrix scheme: per group
//                      of k sites, the k decisions on k x k data (one warp),
//                      then G += G[:, I] W (G[I, :] - E_I) in the CTA.
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
// headline's ns = 256, 128 CTAs for 16 walkers).  A CTA keeps U and V only
// for its own indices, a panel of G's rows and columns at the group's k
// sites, and the pending U/V entries at the sites still to be visited,
// which their owner sends to every CTA with st.async as it makes them; so
// each CTA takes every decision itself on the same bits, no decision
// travels, and a visit waits only for its own site's entries (an mbarrier
// per slot).  The flush then runs on all C SMs at once, each over its own
// rows, with V read from its owners' shared memory.  G stays in global
// memory (L2).  Every shape of the JAX kernel fits (ns <= 512, k <= 32, one
// or two flavors, f32 or f64: at most 119,680 bytes of shared memory).
// Plain FP32/FP64 FMA, no tensor cores; no atomics, so a second call gives
// the same bits, and the same bits as the one-CTA loop it replaced.  The
// submatrix loop keeps one CTA per walker: its flush operands (2 k ns
// elements) beside 9 KB (f32) of decision data, its in-CTA flush as the
// first design of the delayed loop had it.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "submatrix_decide.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int KMAX = 32;
constexpr int SITE_THREADS_MAX = 512;  // one thread per column, ns <= 512
constexpr int SITE_THREADS = 256;      // the delayed loop's CTA
constexpr int SITE_CLUSTER_MAX = 16;   // CTAs per walker (non-portable > 8)

// 16 bytes of T: one float4 or double2 load or store
template <typename T>
struct alignas(16) Vec {
  T v[16 / sizeof(T)];
};

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

// The delayed site loop's cluster for a slice of n sites: C CTAs (a power
// of two, at most 16) split the n indices into blocks of R <= 32, so that
// one warp of each CTA carries its block's part of every visit.  The
// shared-memory layout below: one 8-byte mbarrier per slot (kp, k rounded
// up to 8); in elements of T, own U, own V, and the group's column and row
// panels of G (each NFL x k x Rp, Rp = R rounded up to 4 so that each row
// of U is 16-byte aligned), the future-column buffers FU, FV (NFL x k x
// kp), the group's diagonal (NFL x k), and the slice's gb, us (n each) and
// delta (NFL x n); then, as ints, the visit order (n), the accept flags (n)
// and the visit slot of each own index (Rp).  engine/fused.py
// site_loop_smem mirrors it.
struct SiteCluster {
  int C, R, Rp, threads;
};

__host__ __device__ inline SiteCluster site_cluster(int n) {
  int C = 1;
  while (C < SITE_CLUSTER_MAX && (n + C - 1) / C > 32) C *= 2;
  const int R = (n + C - 1) / C;
  // 16-CTA clusters (ns > 256) ran faster with 128 threads per CTA than
  // with 256 (an H100: 1.12 against 1.58 ms per slice at (16, 448) f32)
  const int cap = C == SITE_CLUSTER_MAX ? SITE_THREADS / 2 : SITE_THREADS;
  const int threads = n >= cap ? cap : (n + 31) / 32 * 32;
  return {C, R, (R + 3) / 4 * 4, threads};
}

template <typename T>
size_t site_smem_bytes(int n, int k, int nfl) {
  const size_t Rp = site_cluster(n).Rp, kp = (k + 7) / 8 * 8;
  return 8 * kp +
         sizeof(T) * (nfl * (4 * k * Rp + 2 * k * kp + k) +
                      (2 + nfl) * (size_t)n) +
         sizeof(int) * (2 * n + Rp);
}

// The visits' handoff between the CTAs of a cluster (PTX for sm_90): a
// pending U or V entry goes to a peer's shared memory with st.async, which
// also counts its bytes on the peer's mbarrier of the entry's slot; the
// peer waits for that barrier's phase (one per group) with acquire
// semantics, and the entries are then visible.  No fence and no flag.
__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ unsigned peer_addr(unsigned a, int rank) {
  unsigned r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(r)
               : "r"(a), "r"(rank));
  return r;
}

__device__ __forceinline__ void mbar_init(unsigned bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect(unsigned bar, unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
  unsigned done = 0;
  while (!done)
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
        "%2;\n selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
}

__device__ __forceinline__ void st_async(unsigned dst, float v,
                                         unsigned bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, "
      "[%2];" ::"r"(dst),
      "r"(__float_as_uint(v)), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void st_async(unsigned dst, double v,
                                         unsigned bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.b64 [%0], %1, "
      "[%2];" ::"r"(dst),
      "l"(__double_as_longlong(v)), "r"(bar)
      : "memory");
}

// One slice of the delayed Metropolis site loop on one cluster per walker
// (blockIdx.y = walker, blockIdx.x = the CTA's rank c in the cluster).  CTA
// c owns the indices a0 = c R ... a0 + own - 1: their rows of U (U[s][a] =
// prefac_s col_s[a]) and columns of V (V[s][a] = row_s[a] - [a == i_s]),
// and their rows of G for the flush.  Per group of k visits:
//   1. the group's panels from G (global memory, L2): GC[t][l] = G[a][i_t],
//      GR[t][l] = G[i_t][a] and GD[t] = G[i_t][i_t], and pos[l], the slot
//      at which own index a is visited in this group (or -1);
//   2. k visits by warp 0 of every CTA (the other warps wait at the
//      cluster barrier that ends the visits).  Every CTA forms G_ii of the
//      visit's site from GD and the future-column buffers FU[t][s] =
//      U[s][i_t], FV[t][s] = V[s][i_t], and takes the same decision on the
//      same bits, so no decision travels; lane l then forms its index's
//      effective column and row entries and its U and V slot.  An own index
//      visited later in the group (at slot p > t) sends its new U and V
//      entries to FU[p][t], FV[p][t] of every CTA with st.async, counted on
//      that CTA's mbarrier of slot p; visit p waits for the barrier's phase
//      of this group, which completes when all 2 NFL p entries are in;
//   3. the flush of the CTA's own rows, G[a][j] += sum_s U[s][a] V[s][j],
//      with V[s][j] read from the shared memory of j's owner, then one
//      cluster barrier (G's rows and the V slots are free again).
// The accept mask is written once, at the end.  Every sum keeps the order,
// and every product and sum the rounding, of the one-CTA loop this
// replaces (written as fma() so that no compiler choice moves it): the
// visit dots in s order on G's entry, r = fma(1 - G_ii, delta, 1), and the
// flush's sum from 0 in s order before it is added to G.  NFL = 1: one
// stored flavor, R = gb r^2 (>= 0).  NFL = 2 (the repulsive model): the
// walker's two flavor chains are consecutive matrices of G and consecutive
// rows of delta; each visit forms both flavors' G_ii before the one
// decision on R = gb r_up r_dn, accepted on |R|, and the walker's sgn is
// multiplied by -1 per accepted R < 0.
template <typename T, int NFL>
__device__ __forceinline__ void site_loop_body(
    T* __restrict__ G, T* __restrict__ mask, long long s_mask,
    const int* __restrict__ order, const T* __restrict__ gb,
    const T* __restrict__ delta, const T* __restrict__ us,
    long long s_stream, T* __restrict__ sgn, int n, int k) {
  constexpr int VW = 16 / sizeof(T);
  constexpr int BS = sizeof(T) == 4 ? 8 : 4;  // a block of the visit dots
  extern __shared__ __align__(16) unsigned char smem_raw[];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int c = (int)cluster.block_rank();
  const int R = (n + C - 1) / C;
  const int Rp = (R + 3) / 4 * 4;
  const int a0 = c * R;
  const int own = max(0, min(R, n - a0));
  const int kR = k * Rp;
  const int kp = (k + 7) / 8 * 8;
  unsigned long long* bars =                // kp: slot p's entries
      reinterpret_cast<unsigned long long*>(smem_raw);
  T* Uo = reinterpret_cast<T*>(bars + kp);  // NFL x k x Rp
  T* Vo = Uo + NFL * kR;                   // NFL x k x Rp
  T* GC = Vo + NFL * kR;                   // NFL x k x Rp: G[a][i_t]
  T* GR = GC + NFL * kR;                   // NFL x k x Rp: G[i_t][a]
  T* FU = GR + NFL * kR;                   // NFL x k x kp: U[s][i_t]
  T* FV = FU + NFL * k * kp;               // NFL x k x kp: V[s][i_t]
  T* GD = FV + NFL * k * kp;               // NFL x k: G[i_t][i_t]
  T* gbs = GD + NFL * k;
  T* uss = gbs + n;
  T* dls = uss + n;                        // NFL x n
  int* ords = reinterpret_cast<int*>(dls + NFL * n);
  int* accs = ords + n;                    // n, by visit
  int* pos = accs + n;                     // Rp

  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int w = blockIdx.y;
  const long long nn = (long long)n * n;
  T* Gw = G + w * NFL * nn;
  mask += w * s_mask;
  gb += w * s_stream;
  delta += w * NFL * s_stream;
  us += w * s_stream;
  for (int e = tid; e < n; e += nthreads) {
    ords[e] = order[e];
    gbs[e] = gb[e];
    uss[e] = us[e];
#pragma unroll
    for (int f = 0; f < NFL; ++f) dls[f * n + e] = delta[f * s_stream + e];
  }
  if (tid < kp) mbar_init(smem_addr(bars + tid), 1);
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  T sign = T(1);
  // every CTA of the cluster runs before any writes to another's memory
  cluster.sync();

  for (int g0 = 0; g0 < n; g0 += k) {
    const int group = g0 / k;
    // 1. the group's panels of G and the slots of the own indices
    for (int l = tid; l < Rp; l += nthreads) pos[l] = -1;
    __syncthreads();
    for (int t = tid; t < k; t += nthreads) {
      const int i = ords[g0 + t];
      if (i >= a0 && i < a0 + own) pos[i - a0] = t;
    }
    for (int e = tid; e < NFL * kR; e += nthreads) {
      const int l = e % Rp;
      if (l >= own) continue;
      const int f = e / kR, t = (e / Rp) % k;
      const int i = ords[g0 + t];
      const T* Gf = Gw + f * nn;
      GC[e] = __ldcg(Gf + (long long)(a0 + l) * n + i);
      GR[e] = __ldcg(Gf + (long long)i * n + a0 + l);
    }
    for (int e = tid; e < NFL * k; e += nthreads) {
      const int i = ords[g0 + e % k];
      GD[e] = __ldcg(Gw + (e / k) * nn + (long long)i * n + i);
    }
    __syncthreads();

    // 2. the group's visits, by warp 0; lane l carries own index a0 + l
    // (lanes at or past `own` compute on other entries and keep nothing)
    if (tid < 32) {
      const int l = tid;
      const int p = l < own ? pos[l] : -1;
      // this group's phase of each slot's barrier: 2 NFL t entries of T
      for (int t = 1 + l; t < k; t += 32)
        mbar_expect(smem_addr(bars + t), 2 * NFL * t * sizeof(T));
      for (int t = 0; t < k; ++t) {
        const int i = ords[g0 + t];
        if (t > 0) mbar_wait(smem_addr(bars + t), group & 1);
        T gii[NFL], col[NFL], row[NFL];
#pragma unroll
        for (int f = 0; f < NFL; ++f) {
          gii[f] = GD[f * k + t];
          col[f] = GC[(f * k + t) * Rp + l];
          row[f] = GR[(f * k + t) * Rp + l];
        }
        // in blocks of BS steps: every load of a block issued at once from
        // an address clamped into its buffer, each step's result kept only
        // for s < t
#pragma unroll
        for (int s0 = 0; s0 < KMAX; s0 += BS) {
          if (s0 < t) {
#pragma unroll
            for (int f = 0; f < NFL; ++f) {
              const T* fu = FU + (f * k + t) * kp + s0;
              const T* fv = FV + (f * k + t) * kp + s0;
              T a[BS], b[BS], uo[BS], vo[BS];
#pragma unroll
              for (int q = 0; q < BS; q += VW) {
                const Vec<T> x = *reinterpret_cast<const Vec<T>*>(fu + q);
                const Vec<T> y = *reinterpret_cast<const Vec<T>*>(fv + q);
#pragma unroll
                for (int e = 0; e < VW; ++e) {
                  a[q + e] = x.v[e];
                  b[q + e] = y.v[e];
                }
              }
#pragma unroll
              for (int q = 0; q < BS; ++q) {
                const int at = f * kR + min(s0 + q, k - 1) * Rp + l;
                uo[q] = Uo[at];
                vo[q] = Vo[at];
              }
#pragma unroll
              for (int q = 0; q < BS; ++q) {
                const bool on = s0 + q < t;
                const T g2 = fma(a[q], b[q], gii[f]);
                const T r2 = fma(a[q], vo[q], row[f]);
                const T c2 = fma(b[q], uo[q], col[f]);
                gii[f] = on ? g2 : gii[f];
                row[f] = on ? r2 : row[f];
                col[f] = on ? c2 : col[f];
              }
            }
          }
        }
        T d[NFL], rf[NFL];
#pragma unroll
        for (int f = 0; f < NFL; ++f) {
          d[f] = dls[f * n + i];
          rf[f] = fma(T(1) - gii[f], d[f], T(1));
        }
        bool accept;
        if (NFL == 1) {
          const T ratio = gbs[i] * rf[0] * rf[0];  // >= 0: gb > 0, a square
          accept = uss[g0 + t] < ratio;
        } else {
          const T ratio = gbs[i] * rf[0] * rf[NFL - 1];
          // u < 1 strictly
          accept = uss[g0 + t] < (ratio < T(0) ? -ratio : ratio);
          if (accept && ratio < T(0)) sign = -sign;
        }
        if (l < own) {
#pragma unroll
          for (int f = 0; f < NFL; ++f) {
            const T prefac = accept ? d[f] / rf[f] : T(0);
            const T u = prefac * col[f];
            const T v = row[f] - (a0 + l == i ? T(1) : T(0));
            Uo[f * kR + t * Rp + l] = u;
            Vo[f * kR + t * Rp + l] = v;
            if (p > t) {
              const int at = (f * k + p) * kp + t;
              const unsigned du = smem_addr(FU + at), dv = smem_addr(FV + at);
              const unsigned bar = smem_addr(bars + p);
              for (int r = 0; r < C; ++r) {
                const unsigned rb = peer_addr(bar, r);
                st_async(peer_addr(du, r), u, rb);
                st_async(peer_addr(dv, r), v, rb);
              }
            }
          }
        }
        if (l == 0) accs[g0 + t] = accept;
      }
    }
    cluster.sync();

    // 3. G[a][j] += sum_s U[s][a] V[s][j] over the own rows a
#pragma unroll
    for (int f = 0; f < NFL; ++f) {
      const T* Uf = Uo + f * kR;
      T* Gf = Gw + f * nn + (long long)a0 * n;
      for (int j = tid; j < n; j += nthreads) {
        const int r = j / R;
        const T* Vr = cluster.map_shared_rank(Vo, r) + f * kR + (j - r * R);
        // float32: the column of V in registers first, its loads in flight
        // together (float64 needs those registers for the sums)
        T vv[KMAX];
        if (sizeof(T) == 4) {
#pragma unroll
          for (int s = 0; s < KMAX; ++s) vv[s] = Vr[min(s, k - 1) * Rp];
        }
        T acc[32];
#pragma unroll
        for (int l = 0; l < 32; ++l) acc[l] = T(0);
        if (k == KMAX && Rp == 32) {
          // the full block (the headline's shape): no step to skip
#pragma unroll
          for (int s = 0; s < KMAX; ++s) {
            const T v = sizeof(T) == 4 ? vv[s] : Vr[s * Rp];
#pragma unroll
            for (int l = 0; l < 32; l += VW) {
              const Vec<T> u =
                  *reinterpret_cast<const Vec<T>*>(Uf + s * 32 + l);
#pragma unroll
              for (int q = 0; q < VW; ++q)
                acc[l + q] = fma(u.v[q], v, acc[l + q]);
            }
          }
        } else {
#pragma unroll
          for (int s = 0; s < KMAX; ++s) {
            if (s < k) {
              const T v = sizeof(T) == 4 ? vv[s] : Vr[s * Rp];
#pragma unroll
              for (int l = 0; l < 32; l += VW) {
                if (l < Rp) {
                  const Vec<T> u =
                      *reinterpret_cast<const Vec<T>*>(Uf + s * Rp + l);
#pragma unroll
                  for (int q = 0; q < VW; ++q)
                    acc[l + q] = fma(u.v[q], v, acc[l + q]);
                }
              }
            }
          }
        }
#pragma unroll
        for (int l = 0; l < 32; ++l)
          if (l < own) {
            T* g = Gf + (long long)l * n + j;
            *g = __ldcg(g) + acc[l];
          }
      }
    }
    __threadfence();
    cluster.sync();
  }
  if (c == 0) {
    for (int e = tid; e < n; e += nthreads)
      if (accs[e]) mask[ords[e]] = T(1);
    if (NFL == 2 && tid == 0) sgn[w] *= sign;
  }
}

// Two CTAs per SM at most 128 registers each: a cluster of 8 then finds
// room on any 4 SMs of a GPC.
template <typename T>
__global__ void __launch_bounds__(SITE_THREADS, 2)
site_loop_kernel(T* G, T* mask, long long s_mask, const int* order,
                 const T* gb, const T* delta, const T* us,
                 long long s_stream, T* sgn, int n, int k) {
  site_loop_body<T, 1>(G, mask, s_mask, order, gb, delta, us, s_stream, sgn,
                       n, k);
}

template <typename T>
__global__ void __launch_bounds__(SITE_THREADS, 2)
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
  const SiteCluster cl = site_cluster(n);
  const size_t smem = site_smem_bytes<T>(n, k, NFL);
  auto kernel = NFL == 1 ? site_loop_kernel<T> : site_loop_2f_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess && cl.C > 8)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cl.C, batch, 1);
  cfg.blockDim = dim3(cl.threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cl.C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, G, mask, s_mask, order, gb, delta,
                           us, s_stream, sgn, n, k);
  if (err != cudaSuccess) return (int)err;
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
