// The delayed Metropolis site loop of one slice on one thread-block cluster
// per walker: the body of the fused block's site loop (#2, #2b;
// fused_block.cu) and of the per-slice engine's delayed slice (#3, #4;
// site_update.cu), and the launch both share.
//
// The loop visits the n sites of a slice in a given order.  Each visit forms
// its effective row and column of G from the pending rank-k U/V buffers,
// decides u < R with R = gb (1 + (1 - G_ii) delta)^2 (one stored flavor) or
// R = gb r_up r_dn accepted on |R| (two flavors, a per-walker sign), and
// writes one U/V slot; every k visits (a group; the last one may be short)
// the loop flushes G += U^T V.
//
// A walker is a cluster of C CTAs (a power of two, at most 16, the fewest
// with R = ceil(n / C) <= rmax indices per CTA: rmax 32 for the fused loop,
// n <= 512; 64 for the per-slice engine, and past n = 1024 its 16 CTAs take
// up to 128 each, n <= 2048).  A CTA keeps U and V
// only for its own indices, a panel of G's
// rows and columns at the group's sites, and the pending U/V entries at the
// sites still to be visited, which their owner sends to every CTA with
// st.async as it makes them; so each CTA takes every decision itself on
// the same bits, no decision travels, and a visit waits only for its own
// site's entries (an mbarrier per slot).  The flush runs on all C SMs at
// once, each over its own rows, with V read from its owners' shared memory.
// G stays in global memory (L2).  Plain FP32/FP64 FMA, no tensor cores; no
// atomics, so a second call gives the same bits.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace dqmc {

namespace cg = cooperative_groups;

constexpr int SITE_KMAX = 32;          // largest group (block rank)
constexpr int SITE_THREADS = 256;      // a CTA of a cluster of C <= 8
constexpr int SITE_CLUSTER_MAX = 16;   // CTAs per walker (non-portable > 8)
// the per-slice engine's largest slice: 16 CTAs of at most 128 indices
constexpr int SITE_SLICE_MAX_N = SITE_CLUSTER_MAX * 128;
// dynamic shared memory one block may use on an H100
constexpr size_t SITE_SMEM_MAX = 232448;

// N elements of T in 16-byte pieces (by default one float4 or double2
// load or store)
template <typename T, int N = 16 / sizeof(T)>
struct alignas(16) Vec {
  T v[N];
};

// The cluster for a slice of n sites: C CTAs (the fewest, a power of two,
// at most 16, with R = ceil(n / C) <= rmax indices each: rmax 32 for the
// fused loop, 64 for the per-slice engine's, whose 16 CTAs take R <= 128
// past n = 1024) split the n indices into blocks of R, so that the first
// ceil(R / 32) warps of each CTA carry its block's part of every visit.
// The shared-memory layout below: one 8-byte mbarrier per
// slot (kp, k rounded up to 8); in elements of T, own U, own V, and the
// group's column and row panels of G (each NFL x k x Rp, Rp = R rounded up
// to 4 so that each row of U is 16-byte aligned), the future-column buffers
// FU, FV (NFL x k x kp), the group's diagonal (NFL x k), and the slice's
// gb, us (n each) and delta (NFL x n), all three in visit order; then, as
// ints, the visit order (n), the accept flags (n) and the visit slot of each
// own index (Rp).  Where that passes SITE_SMEM_MAX (the per-slice engine in
// float64 with two flavors past n = 1152) the lean layout drops the panels
// and holds the slice's arrays for one group: own U and V, two flush
// buffers of k x Rp (one flavor's owner block each), FU, FV, the diagonal,
// the group's gb, us and delta (k, k, NFL x k) and, as ints, its order (k)
// and the own slots (Rp); each visit thread then reads its own index's
// entries of G's column and row from L2, and the flags are written at the
// visit.  site_update.cu exports the cluster and the byte count of the
// layout it launches (dqmc_site_cluster, dqmc_site_smem_bytes);
// ops/kernels.py delayed_slice_smem mirrors the byte count for the host,
// where no library may be built.
struct SiteCluster {
  int C, R, Rp, threads;
};

__host__ __device__ inline SiteCluster site_cluster(int n, int rmax = 32) {
  int C = 1;
  while (C < SITE_CLUSTER_MAX && (n + C - 1) / C > rmax) C *= 2;
  const int R = (n + C - 1) / C;
  // rmax 64: up to four visit warps, and the flush by owner (its MAXV)
  // wants at least 128 threads, and 256 for R > 64
  if (rmax > 32)
    return {C, R, (R + 3) / 4 * 4, n >= SITE_THREADS ? SITE_THREADS : 128};
  // 16-CTA clusters (ns > 256) ran faster with 128 threads per CTA than
  // with 256 (an H100: 1.12 against 1.58 ms per slice at (16, 448) f32)
  const int cap = C == SITE_CLUSTER_MAX ? SITE_THREADS / 2 : SITE_THREADS;
  const int threads = n >= cap ? cap : (n + 31) / 32 * 32;
  return {C, R, (R + 3) / 4 * 4, threads};
}

template <typename T>
size_t site_smem_bytes(int n, int k, int nfl, int rmax = 32,
                       bool lean = false) {
  const size_t Rp = site_cluster(n, rmax).Rp, kp = (k + 7) / 8 * 8;
  if (lean)
    return 8 * kp +
           sizeof(T) * (nfl * (2 * k * Rp + 2 * k * kp + k) + 2 * k * Rp +
                        (2 + nfl) * (size_t)k) +
           sizeof(int) * (k + Rp);
  return 8 * kp +
         sizeof(T) * (nfl * (4 * k * Rp + 2 * k * kp + k) +
                      (2 + nfl) * (size_t)n) +
         sizeof(int) * (2 * n + Rp);
}

// Whether the per-slice engine's slice takes the lean layout: only where
// the full one does not fit
template <typename T>
bool site_lean(int n, int k, int nfl, int rmax) {
  return rmax > 32 && site_smem_bytes<T>(n, k, nfl, rmax) > SITE_SMEM_MAX;
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

// a * b rounded on its own: never contracted into an FMA
__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}

__device__ __forceinline__ double mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}

// One slice's operands.  Walker w (blockIdx.y) reads G + w NFL n^2, its
// order at order + w s_order (s_order 0: one shared order), and gb, us and
// the NFL rows of delta at walker stride s_stream (delta's rows s_stream
// apart).  per_visit: gb and delta are indexed by visit (the per-slice
// engine), and flags (walker stride s_flags) receives 0 or 1 for every
// visit; otherwise gb and delta are indexed by site (the fused engine) and
// flags is a mask by site, set to 1 where a visit was accepted.  us is
// always indexed by visit.  sgn (W,) is multiplied by the slice's sign
// (two flavors only).
template <typename T>
struct SiteLoopArgs {
  T* G;
  T* flags;
  long long s_flags;
  const int* order;
  long long s_order;
  const T* gb;
  const T* delta;
  const T* us;
  long long s_stream;
  T* sgn;
  int n, k;
  bool per_visit;
};

// 16 bytes of G past L1, as every read of G here (L1 is not coherent
// across the SMs that write G)
__device__ __forceinline__ Vec<float> ldcg_vec(const float* p) {
  const float4 v = __ldcg(reinterpret_cast<const float4*>(p));
  return {{v.x, v.y, v.z, v.w}};
}

__device__ __forceinline__ Vec<double> ldcg_vec(const double* p) {
  const double2 v = __ldcg(reinterpret_cast<const double2*>(p));
  return {{v.x, v.y}};
}

// The flush of one flavor in the per-slice engine's clusters (R <= 64 on
// 128 or 256 threads, R <= 128 on 256), G[a0 + l][j] += sum_s Uf[s][l]
// V[s][j] for the CTA's own
// rows l < own, owner by owner, CTA c starting at owner c (so that no two
// CTAs read one owner's shared memory at once): the tile of the own rows
// and owner r's R columns, cut into 4 x 4 pieces, each thread taking every
// nthreads-th piece.  Owner r's cnt x Rp block of V (at Vo + off in its
// shared memory) is copied into one of two local buffers, the next owner's
// copy in registers while this owner's pieces are computed; a piece's rows
// of U are read as broadcast 16-byte loads, and the thread's next piece of
// G is loaded before the current one's FMAs.  The sums are those of the
// per-column flush (from 0 in s order, then added to G).
template <typename T>
__device__ __forceinline__ void flush_by_owner(
    cg::cluster_group& cluster, T* __restrict__ Gf, const T* Uf, const T* Vo,
    int off, T* buf0, T* buf1, int n, int R, int Rp, int own, int cnt) {
  constexpr int VW = 16 / sizeof(T);
  constexpr int TM = 4;
  // an owner block's vectors per thread: k Rp / VW over 128 threads for
  // Rp <= 64, over 256 for Rp <= 128
  constexpr int MAXV = SITE_KMAX * 64 / VW / 128;
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int C = (int)cluster.num_blocks();
  const int c = (int)cluster.block_rank();
  const int CG = Rp / 4, pieces = (own + TM - 1) / TM * CG;
  const int per = (pieces + nthreads - 1) / nthreads;  // per thread, owner
  const int items = C * per;
  const int nv = cnt * Rp / VW;  // vectors of an owner's block
  const bool vec = n % 4 == 0 && R % 4 == 0;
  Vec<T> pre[MAXV];
  // the block of the owner of step `step`
  auto fetch = [&](int step) {
    const Vec<T>* src = reinterpret_cast<const Vec<T>*>(
        cluster.map_shared_rank(Vo, (c + step) % C) + off);
#pragma unroll
    for (int i = 0; i < MAXV; ++i)
      if (tid + i * nthreads < nv) pre[i] = src[tid + i * nthreads];
  };
  auto put = [&](T* buf) {
#pragma unroll
    for (int i = 0; i < MAXV; ++i)
      if (tid + i * nthreads < nv)
        reinterpret_cast<Vec<T>*>(buf)[tid + i * nthreads] = pre[i];
  };
  // work item i: step i / per (owner c + i / per), piece tid + (i % per)
  // nthreads (none past the last piece: l0 = own rounded up to TM, so that
  // its reads of U stay 16-byte aligned when R is not a multiple of 4)
  auto locate = [&](int i, int& r, int& l0, int& c0) {
    r = (c + i / per) % C;
    const int t = tid + (i % per) * nthreads;
    l0 = t < pieces ? t / CG * TM : (own + TM - 1) / TM * TM;
    c0 = t % CG * 4;
  };
  auto load_g = [&](T(&dst)[TM][4], int i) {
    int r, l0, c0;
    locate(i, r, l0, c0);
    const int cols = min(R, n - r * R);
    const T* g0 = Gf + (long long)l0 * n + r * R + c0;
#pragma unroll
    for (int x = 0; x < TM; ++x) {
      const bool in = l0 + x < own;
      if (vec) {
#pragma unroll
        for (int y = 0; y < 4; y += VW) {
          Vec<T> v{};
          if (in && c0 < cols) v = ldcg_vec(g0 + (long long)x * n + y);
#pragma unroll
          for (int q = 0; q < VW; ++q) dst[x][y + q] = v.v[q];
        }
      } else {
#pragma unroll
        for (int y = 0; y < 4; ++y)
          dst[x][y] = in && c0 + y < cols
                          ? __ldcg(g0 + (long long)x * n + y)
                          : T(0);
      }
    }
  };

  fetch(0);
  // buf0 may still be read by the flush of the flavor before (with one
  // CTA its only step reads buf0 and ends with no barrier)
  __syncthreads();
  put(buf0);
  __syncthreads();
  if (C > 1) fetch(1);
  T g[TM][4], gn[TM][4];
  load_g(g, 0);
  for (int i = 0; i < items; ++i) {
    int r, l0, c0;
    locate(i, r, l0, c0);
    if (i + 1 < items) load_g(gn, i + 1);
    const int step = i / per;
    const T* Vs = step & 1 ? buf1 : buf0;
    const int cols = min(R, n - r * R);
    T acc[TM][4];
#pragma unroll
    for (int x = 0; x < TM; ++x)
#pragma unroll
      for (int y = 0; y < 4; ++y) acc[x][y] = T(0);
#pragma unroll 4
    for (int s = 0; s < cnt; ++s) {
      T u[TM], v[4];
#pragma unroll
      for (int x = 0; x < TM; x += VW) {
        // (rows past Rp read the next row of U, or V: in bounds, unused)
        const Vec<T> e =
            *reinterpret_cast<const Vec<T>*>(Uf + s * Rp + l0 + x);
#pragma unroll
        for (int q = 0; q < VW; ++q) u[x + q] = e.v[q];
      }
#pragma unroll
      for (int y = 0; y < 4; y += VW) {
        const Vec<T> e =
            *reinterpret_cast<const Vec<T>*>(Vs + s * Rp + c0 + y);
#pragma unroll
        for (int q = 0; q < VW; ++q) v[y + q] = e.v[q];
      }
#pragma unroll
      for (int x = 0; x < TM; ++x)
#pragma unroll
        for (int y = 0; y < 4; ++y) acc[x][y] = fma(u[x], v[y], acc[x][y]);
    }
    T* g0 = Gf + (long long)l0 * n + r * R + c0;
#pragma unroll
    for (int x = 0; x < TM; ++x) {
      if (l0 + x < own) {
        T* gx = g0 + (long long)x * n;
        if (vec) {
          if (c0 < cols) {
#pragma unroll
            for (int y = 0; y < 4; y += VW) {
              Vec<T> e;
#pragma unroll
              for (int q = 0; q < VW; ++q)
                e.v[q] = g[x][y + q] + acc[x][y + q];
              *reinterpret_cast<Vec<T>*>(gx + y) = e;
            }
          }
        } else {
#pragma unroll
          for (int y = 0; y < 4; ++y)
            if (c0 + y < cols) gx[y] = g[x][y] + acc[x][y];
        }
      }
#pragma unroll
      for (int y = 0; y < 4; ++y) g[x][y] = gn[x][y];
    }
    // the end of a step's pieces: the next step's block into the other
    // buffer (read last in the step before, whose pieces every thread has
    // finished), then the copy of the step after it out to registers
    if ((i + 1) % per == 0 && step + 1 < C) {
      put(step & 1 ? buf0 : buf1);
      __syncthreads();
      if (step + 2 < C) fetch(step + 2);
    }
  }
}

// The flush of one flavor in the fused loop's clusters (R <= 32), by
// column: G[a0 + l][j] += sum_s Uf[s][l] V[s][j] for the CTA's own rows
// l < own, each thread one column j of all own rows at a time, V[s][j]
// read from the shared memory of j's owner (at Vo + off there, its R
// columns Rp apart); G's rows a0 ... (Gf) in global memory.  The sum runs
// from 0 in s order and is then added to G.
template <typename T, int RMAX>
__device__ __forceinline__ void flush_by_column(
    cg::cluster_group& cluster, T* Gf, const T* Uf, const T* Vo, int off,
    int n, int R, int Rp, int own, int cnt) {
  constexpr int VW = 16 / sizeof(T);
  constexpr int GB = sizeof(T) == 4 ? 32 : 16;  // G loads in flight
  constexpr int KMAX = SITE_KMAX;
  const int tid = threadIdx.x, nthreads = blockDim.x;
  // (one pass: own <= 32; a loop, with which ptxas keeps the column
  // loop free of spills)
#pragma unroll 1
  for (int h = 0; h < min(own, RMAX); h += 32) {
    for (int j = tid; j < n; j += nthreads) {
      const int r = j / R;
      const T* Vr =
          cluster.map_shared_rank(Vo, r) + off + (j - r * R);
      // float32: the column of V in registers first, its loads in
      // flight together (float64 needs those registers for the sums)
      T vv[KMAX];
      if (sizeof(T) == 4) {
#pragma unroll
        for (int s0 = 0; s0 < KMAX; s0 += 8)
          if (s0 < cnt) {
#pragma unroll
            for (int s = s0; s < s0 + 8; ++s)
              vv[s] = Vr[min(s, cnt - 1) * Rp];
          }
      }
      T acc[32];
#pragma unroll
      for (int l = 0; l < 32; ++l) acc[l] = T(0);
      if (cnt == KMAX && Rp == RMAX) {
        // full groups and rows (ns = 32 C): no step to skip
#pragma unroll
        for (int s = 0; s < KMAX; ++s) {
          const T v = sizeof(T) == 4 ? vv[s] : Vr[s * Rp];
#pragma unroll
          for (int l = 0; l < 32; l += VW) {
            const Vec<T> u = *reinterpret_cast<const Vec<T>*>(
                Uf + s * RMAX + h + l);
#pragma unroll
            for (int q = 0; q < VW; ++q)
              acc[l + q] = fma(u.v[q], v, acc[l + q]);
          }
        }
      } else {
#pragma unroll
        for (int s = 0; s < KMAX; ++s) {
          if (s < cnt) {
            const T v = sizeof(T) == 4 ? vv[s] : Vr[s * Rp];
#pragma unroll
            for (int l = 0; l < 32; l += VW) {
              if (h + l < Rp) {
                const Vec<T> u = *reinterpret_cast<const Vec<T>*>(
                    Uf + s * Rp + h + l);
#pragma unroll
                for (int q = 0; q < VW; ++q)
                  acc[l + q] = fma(u.v[q], v, acc[l + q]);
              }
            }
          }
        }
      }
      // G's entries in blocks of GB loads in flight: a store to G
      // between two loads would make each wait for the one before
      // (the compiler cannot tell the rows apart)
#pragma unroll
      for (int l0 = 0; l0 < 32; l0 += GB) {
        T g[GB];
#pragma unroll
        for (int l = 0; l < GB; ++l)
          g[l] = h + l0 + l < own
                     ? __ldcg(Gf + (long long)(h + l0 + l) * n + j)
                     : T(0);
#pragma unroll
        for (int l = 0; l < GB; ++l)
          if (h + l0 + l < own)
            Gf[(long long)(h + l0 + l) * n + j] = g[l] + acc[l0 + l];
      }
    }
  }
}

// One slice on the cluster of walker blockIdx.y (blockIdx.x = the CTA's
// rank c in the cluster).  CTA c owns the indices a0 = c R ... a0 + own - 1:
// their rows of U (U[s][a] = prefac_s col_s[a]) and columns of V
// (V[s][a] = row_s[a] - [a == i_s]), and their rows of G for the flush.
// Per group of cnt <= k visits:
//   1. the group's panels from G (global memory, L2): GC[t][l] = G[a][i_t],
//      GR[t][l] = G[i_t][a] and GD[t] = G[i_t][i_t], and pos[l], the slot
//      at which own index a is visited in this group (or -1);
//   2. cnt visits by the first Rp / 32 warps (rounded up: one to four) of
//      every CTA; the other warps wait at the cluster barrier
//      that ends the visits.  Every visit warp forms G_ii of the visit's
//      site from GD and the future-column buffers FU[t][s] = U[s][i_t],
//      FV[t][s] = V[s][i_t], and takes the same decision on the same bits,
//      so no decision travels; thread l then forms own index a0 + l's
//      effective column and row entries and its U and V slot.  An own index
//      visited later in the group (at slot p > t) sends its new U and V
//      entries to FU[p][t], FV[p][t] of every CTA with st.async, counted on
//      that CTA's mbarrier of slot p; visit p waits for the barrier's phase
//      of this group, which completes when all 2 NFL p entries are in;
//   3. the flush of the CTA's own rows, G[a][j] += sum_s U[s][a] V[s][j]:
//      with RMAX = 32 (the fused loop) by column (a thread's column of the
//      own rows at a time, V[s][j] read from the shared memory of j's
//      owner), with RMAX = 64 (the per-slice engine) by owner
//      (flush_by_owner); then one cluster barrier (G's rows and the V
//      slots are free again).
// The flags are written once, at the end.  Every sum keeps the order, and
// every product and sum the rounding, of the one-CTA loops this replaces
// (written as fma() so that no compiler choice moves it): the visit dots in
// s order on G's entry, r = fma(1 - G_ii, delta, 1), and the flush's sum
// from 0 in s order before it is added to G.  SPLIT_R rounds the product
// first, r = 1 + round((1 - G_ii) delta), as the per-slice engine's
// two-flavor kernel this replaces did (ptxas left it unfused there).
// RMAX (32 or 64) selects the flush.  LEAN (the per-slice engine only,
// per_visit) takes the lean layout (site_smem_bytes): step 1 stages the
// group's order, gb, us and delta instead of G's panels, and each visit
// thread loads its column and row entries of G before it waits for the
// visit's slot; the flush's V buffers are then two k x Rp blocks of their
// own.  The arithmetic is the same.
template <typename T, int NFL, int RMAX, bool SPLIT_R = false,
          bool LEAN = false>
__device__ __forceinline__ void site_loop_body(const SiteLoopArgs<T>& a) {
  constexpr int VW = 16 / sizeof(T);
  constexpr int BS = sizeof(T) == 4 ? 8 : 4;  // a block of the visit dots
  constexpr int KMAX = SITE_KMAX;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  cg::cluster_group cluster = cg::this_cluster();
  const int n = a.n, k = a.k;
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
  // (LEAN: GC and GR are the flush's two buffers, k x Rp each, and the
  // slice arrays hold the group's nsl = k visits, indexed from gv = 0)
  constexpr int NP = LEAN ? 1 : NFL;
  const int nsl = LEAN ? k : n;
  T* Uo = reinterpret_cast<T*>(bars + kp);  // NFL x k x Rp
  T* Vo = Uo + NFL * kR;                   // NFL x k x Rp
  T* GC = Vo + NFL * kR;                   // NFL x k x Rp: G[a][i_t]
  T* GR = GC + NP * kR;                    // NFL x k x Rp: G[i_t][a]
  T* FU = GR + NP * kR;                    // NFL x k x kp: U[s][i_t]
  T* FV = FU + NFL * k * kp;               // NFL x k x kp: V[s][i_t]
  T* GD = FV + NFL * k * kp;               // NFL x k: G[i_t][i_t]
  T* gbs = GD + NFL * k;                   // n, by visit
  T* uss = gbs + nsl;                      // n, by visit
  T* dls = uss + nsl;                      // NFL x n, by visit
  int* ords = reinterpret_cast<int*>(dls + NFL * nsl);
  int* accs = ords + nsl;                  // n, by visit (not LEAN)
  int* pos = accs + (LEAN ? 0 : n);        // Rp

  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int w = blockIdx.y;
  const long long nn = (long long)n * n;
  T* Gw = a.G + w * NFL * nn;
  const int* order = a.order + w * a.s_order;
  const T* gb = a.gb + w * a.s_stream;
  const T* delta = a.delta + w * NFL * a.s_stream;
  const T* us = a.us + w * a.s_stream;
  T* flags = a.flags + w * a.s_flags;
  // the slice's streams into shared memory, each read once; the lean
  // layout reads its group's in step 1
  auto stage = [&](int e, int to) {
    const int at = a.per_visit ? e : ords[to];
    gbs[to] = gb[at];
    uss[to] = us[e];
#pragma unroll
    for (int f = 0; f < NFL; ++f)
      dls[f * nsl + to] = delta[f * a.s_stream + at];
  };
  if constexpr (!LEAN) {
    for (int e = tid; e < n; e += nthreads) ords[e] = order[e];
    __syncthreads();
    for (int e = tid; e < n; e += nthreads) stage(e, e);
  }
  if (tid < kp) mbar_init(smem_addr(bars + tid), 1);
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  T sign = T(1);
  // every CTA of the cluster runs before any writes to another's memory
  cluster.sync();

  for (int g0 = 0; g0 < n; g0 += k) {
    const int group = g0 / k;
    const int cnt = min(k, n - g0);
    const int gv = LEAN ? 0 : g0;  // the group's first visit in the arrays
    // 1. the group's panels of G (LEAN: its streams) and the slots of the
    // own indices
    for (int l = tid; l < Rp; l += nthreads) pos[l] = -1;
    if constexpr (LEAN) {
      for (int t = tid; t < cnt; t += nthreads) {
        ords[t] = order[g0 + t];
        stage(g0 + t, t);
      }
    }
    __syncthreads();
    for (int t = tid; t < cnt; t += nthreads) {
      const int i = ords[gv + t];
      if (i >= a0 && i < a0 + own) pos[i - a0] = t;
    }
    if constexpr (!LEAN) {
      for (int e = tid; e < NFL * kR; e += nthreads) {
        const int l = e % Rp, t = (e / Rp) % k;
        if (l >= own || t >= cnt) continue;
        const int f = e / kR;
        const int i = ords[g0 + t];
        const T* Gf = Gw + f * nn;
        GC[e] = __ldcg(Gf + (long long)(a0 + l) * n + i);
        GR[e] = __ldcg(Gf + (long long)i * n + a0 + l);
      }
    }
    for (int e = tid; e < NFL * k; e += nthreads) {
      if (e % k >= cnt) continue;
      const int i = ords[gv + e % k];
      GD[e] = __ldcg(Gw + (e / k) * nn + (long long)i * n + i);
    }
    __syncthreads();

    // 2. the group's visits; thread l carries own index a0 + l (threads at
    // or past `own` compute on other entries and keep nothing)
    if (tid < (Rp + 31) / 32 * 32) {
      const int l = tid;
      const int lc = min(l, Rp - 1);  // in-bounds reads for idle threads
      const int p = l < own ? pos[l] : -1;
      // this group's phase of each slot's barrier: 2 NFL t entries of T
      if (tid < 32)
        for (int t = 1 + l; t < cnt; t += 32)
          mbar_expect(smem_addr(bars + t), 2 * NFL * t * sizeof(T));
      for (int t = 0; t < cnt; ++t) {
        const int i = ords[gv + t];
        T gii[NFL], col[NFL], row[NFL];
        if constexpr (LEAN) {
          // G[a][i] and G[i][a] from L2, in flight during the wait (idle
          // threads read an own row)
          const int lg = max(min(l, own - 1), 0);
#pragma unroll
          for (int f = 0; f < NFL; ++f) {
            const T* Gf = Gw + f * nn;
            col[f] = __ldcg(Gf + (long long)(a0 + lg) * n + i);
            row[f] = __ldcg(Gf + (long long)i * n + a0 + lg);
          }
        }
        if (t > 0) mbar_wait(smem_addr(bars + t), group & 1);
#pragma unroll
        for (int f = 0; f < NFL; ++f) {
          gii[f] = GD[f * k + t];
          if constexpr (!LEAN) {
            col[f] = GC[(f * k + t) * Rp + lc];
            row[f] = GR[(f * k + t) * Rp + lc];
          }
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
              T x[BS], y[BS], uo[BS], vo[BS];
#pragma unroll
              for (int q = 0; q < BS; q += VW) {
                const Vec<T> xu = *reinterpret_cast<const Vec<T>*>(fu + q);
                const Vec<T> yv = *reinterpret_cast<const Vec<T>*>(fv + q);
#pragma unroll
                for (int e = 0; e < VW; ++e) {
                  x[q + e] = xu.v[e];
                  y[q + e] = yv.v[e];
                }
              }
#pragma unroll
              for (int q = 0; q < BS; ++q) {
                const int at = f * kR + min(s0 + q, k - 1) * Rp + lc;
                uo[q] = Uo[at];
                vo[q] = Vo[at];
              }
#pragma unroll
              for (int q = 0; q < BS; ++q) {
                const bool on = s0 + q < t;
                const T g2 = fma(x[q], y[q], gii[f]);
                const T r2 = fma(x[q], vo[q], row[f]);
                const T c2 = fma(y[q], uo[q], col[f]);
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
          d[f] = dls[f * nsl + gv + t];
          rf[f] = SPLIT_R ? T(1) + mul_rn(T(1) - gii[f], d[f])
                          : fma(T(1) - gii[f], d[f], T(1));
        }
        bool accept;
        if (NFL == 1) {
          // >= 0: gb > 0 times a square
          const T ratio = gbs[gv + t] * rf[0] * rf[0];
          accept = uss[gv + t] < ratio;
        } else {
          const T ratio = gbs[gv + t] * rf[0] * rf[NFL - 1];
          // u < 1 strictly
          accept = uss[gv + t] < (ratio < T(0) ? -ratio : ratio);
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
        if constexpr (LEAN) {
          if (c == 0 && tid == 0) {
            if (a.per_visit)
              flags[g0 + t] = accept ? T(1) : T(0);
            else if (accept)
              flags[i] = T(1);
          }
        } else if (tid == 0) {
          accs[g0 + t] = accept;
        }
      }
    }
    cluster.sync();

    // 3. G[a][j] += sum_s U[s][a] V[s][j] over the own rows a: by owner
    // when RMAX = 64 (GC and GR, free until the next group, hold V's
    // blocks; LEAN: they are its buffers), else by column, each thread
    // one column of all own rows
#pragma unroll
    for (int f = 0; f < NFL; ++f) {
      T* Gf = Gw + f * nn + (long long)a0 * n;
      if constexpr (RMAX > 32)
        flush_by_owner<T>(cluster, Gf, Uo + f * kR, Vo, f * kR, GC, GR, n, R,
                          Rp, own, cnt);
      else
        flush_by_column<T, RMAX>(cluster, Gf, Uo + f * kR, Vo, f * kR, n, R,
                                 Rp, own, cnt);
    }
    // (the barrier's release and acquire at cluster scope order the
    // flush's writes of G before the next group's panel loads)
    cluster.sync();
  }
  if (c == 0) {
    if constexpr (!LEAN) {
      for (int e = tid; e < n; e += nthreads) {
        if (a.per_visit)
          flags[e] = accs[e] ? T(1) : T(0);
        else if (accs[e])
          flags[ords[e]] = T(1);
      }
    }
    if (NFL == 2 && tid == 0) a.sgn[w] *= sign;
  }
}

// What a launcher keeps between launches of one kernel on one device: the
// dynamic shared memory limit it set there, and whether one cluster fits
// at the last shape it asked about.
struct SiteLaunchEntry {
  int dev = -1, smem = -1, n = -1, k = -1, clusters = 0;
};

// One entry per device ordinal (modulo SITE_CACHE_DEVICES; an entry that
// another device took is set again), so that launches alternating between
// devices from one host thread keep their attribute and occupancy answer.
constexpr int SITE_CACHE_DEVICES = 16;

struct SiteLaunchCache {
  SiteLaunchEntry entry[SITE_CACHE_DEVICES];
  SiteLaunchEntry& of(int dev) { return entry[dev % SITE_CACHE_DEVICES]; }
};

// Launch `kernel` (a site_loop_body or submatrix_slice_body instantiation
// taking SiteLoopArgs<T>, R <= rmax, `smem` bytes of dynamic shared memory
// per CTA) for `batch` walkers: one cluster of site_cluster(n, rmax).C
// CTAs each.  Raises
// the kernel's dynamic shared memory limit to what the shape needs and
// returns cudaErrorLaunchOutOfResources, launching nothing, when the
// device cannot hold one such cluster (cudaOccupancyMaxActiveClusters).
// `caches` (one per kernel) keeps the attribute and the answer per
// device, so a repeated launch (and a launch under CUDA graph capture)
// only launches.
template <typename T, typename Kernel>
int launch_site_loop(Kernel kernel, SiteLaunchCache& caches,
                     const SiteLoopArgs<T>& args, size_t smem, int rmax,
                     int batch, void* stream) {
  const SiteCluster cl = site_cluster(args.n, rmax);
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  SiteLaunchEntry& cache = caches.of(dev);
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
  if (dev != cache.dev || (int)smem > cache.smem) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return (int)err;
    cache.dev = dev;
    cache.smem = (int)smem;
    cache.n = -1;
  }
  if (args.n != cache.n || args.k != cache.k) {
    err = cudaOccupancyMaxActiveClusters(&cache.clusters, kernel, &cfg);
    if (err != cudaSuccess) return (int)err;
    cache.n = args.n;
    cache.k = args.k;
  }
  if (cache.clusters < 1) return (int)cudaErrorLaunchOutOfResources;
  err = cudaLaunchKernelEx(&cfg, kernel, args);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace dqmc
