// #3, #4 and #6: the per-slice engine's Metropolis site loops.
//
// Replaces: dqmc_tpu/ops/kernels.py::_batched_update_kernel (#3, the
// walker-batched delayed rank-k loop, reached through
// _metropolis_batched_impl), ::_batched_update_kernel_2f (#4, its
// two-flavor variant for det_power = 1 models, reached through
// _metropolis_batched_2f_impl: opposite couplings per flavor, the ratio
// R = gb r_up r_dn taken once per flavor, Metropolis on |R|, a per-walker
// sign) and ::_update_kernel (#6, one walker's rank-1 Sherman-Morrison loop
// in its own order, metropolis_slice_update).  On the TPU each ran a whole
// slice as one VMEM-resident program, the delayed ones flushing
// G += U^T V every k visits inside it.
//
//   delayed_slice_kernel   #3 and #4: a whole slice -- all n visits and
//                          all ceil(n / k) flushes -- on one thread-block
//                          cluster per walker, in the body the fused
//                          engine's site loop uses (site_loop.cuh).  Its
//                          two-flavor instantiation forms both flavors'
//                          G_ii before the one decision and multiplies the
//                          walker's sign.
//   rank1_sites_kernel     #6: a whole slice on one thread-block cluster
//                          per walker, G's rows split over its CTAs and
//                          kept on chip for the whole slice; an accepted
//                          visit applies its rank-1 update to every CTA's
//                          own rows.
//
// The field-dependent factors gb = gamma ratio * boson ratio and
// delta = exp(g d_eta) - 1 of every visit are computed by the host before
// the slice (ops/kernels.py visit_factors), indexed by visit: each site is
// visited once per slice, so its pre-update field is the slice-start
// field.  The host also turns the accept flags (one per visit) into the new
// fields.  The order has a stride: 0 for one shared order, n for
// per-walker orders.  The last group of a slice may be short (n % k != 0).
//
// What bounds the delayed slice on an H100: its n visits are a chain of
// dependent steps, each waiting for the pending U/V entries at its site,
// and each of the ceil(n / k) flushes is 2 k n^2 FLOPs per walker and
// matrix (8.6 GFLOP per slice at the stretch shape W = 4, n = 1024,
// k = 32: 0.13 ms at the FP32 FMA peak) on G, which lives in global memory
// and L2 (4 MB per walker in f32).  The first design ran each group of k
// visits as one launch on one CTA per walker (W of 132 SMs) with U and V
// in L2 -- 256 KB per walker at the stretch shape, more than a CTA's 227
// KB of shared memory -- re-read by every visit, and each flush as a
// separate tiled launch over the whole card: 2 n / k launches per slice.
//
// What the design does about it: one launch per slice.  A walker is a
// cluster of the fewest CTAs (C = 1 ... 16) that own at most R = 64 sites
// each (C = 1 up to n = 64, 4 at n = 256, 16 at n = 1024, and 16 of up to
// 128 sites past it, n <= 2048; one to four warps of each CTA carry the
// visits), so U and V live in the cluster's
// shared memory, O(k n / C) per CTA; the pending entries a visit needs
// reach every CTA by st.async as their owner makes them, and each flush
// runs on the walker's C SMs over each CTA's own rows, owner by owner
// (each owner's block of V copied into local shared memory, the CTAs
// visiting the owners in staggered order, each thread a 4 x 4 piece of
// G).  (Fewer CTAs than the fused loop's R <= 32: at n = 36 one CTA per
// walker is faster than two; at n = 256 four lose 8% to eight.)  What bounds it now: at n = 1024
// a flush runs on C = 16 SMs per walker, 64 of 132 at W = 4, where the
// FP32 FMA peak of those SMs alone is ~9 us per flush (an H100 takes ~40;
// neither V's remote reads nor G's traffic nor the barriers account for
// the rest); the visits (~0.76 ms per slice in float32) wait for one
// cross-SM handoff each.  In float64 with two flavors past n = 1152 the
// CTA's panels of G would pass its 227 KB: that case takes the lean layout
// (site_loop.cuh), whose visit threads read their entries of G from L2.
// Every sum is an explicit fma() in the order of the first design (visit
// dots in s order on G's entry, r = fma(1 - G_ii, delta, 1) -- rounded
// product first with two flavors, as that kernel's build did -- and the
// flush summed from 0 in s order, then added to G), so G, the flags and
// the sign keep its bits.  A cluster the card cannot place raises;
// nothing falls back.
//
// What bounds #6: its n visits are a chain, each deciding on G_ii after
// the visits before it, and each accepted visit is n^2 FMAs on all of G.
// The first design ran one CTA per walker (W of 132 SMs) on G in global
// memory: every accepted visit streamed G (4 MB per walker at n = 1024 in
// f32) through L2 from one SM, with a 64-bit division per entry and two
// block barriers.  What the design does about it: a walker is a cluster
// of the fewest CTAs (C = 1 ... 16) with at most 64 rows each (C = 1 up to
// n = 64, 4 at 256, 16 at 1024, then 16 of up to 128 rows, n <= 2048),
// each CTA holding its rows in shared memory from the first visit to the
// last (rows past its 227 KB stay in G, in L2: float64 at n = 1024, most
// rows past n = 1024); only row i of each visit travels, pushed by its owner
// into every CTA with st.async once that row has the visit before applied
// (the owner updates it first), and every CTA takes the decision from that
// row's G_ii on the same bits.  One cluster barrier per visit (split into
// arrive and wait, so the decision overlaps it) frees the other buffers.
// Thread t carries a 16-byte column vector of its CTA's rows (32 bytes in
// float64 past n = 1024, where a row has more than 512 16-byte vectors),
// so there is no index division.  The update stays bound by shared-memory traffic, 8
// (f32) or 16 (f64) bytes per entry and accepted visit, and a rejected
// visit by the handoff.
// #6 keeps the first design's forms, col = prefac G[a][i], row = G[i][b] -
// [b = i], r = fma(1 - G_ii, delta, 1) and one fma(col, row, G[a][b]) per
// entry and accepted visit in visit order, so how the entries are split
// over threads and CTAs does not change G, the flags or the acceptance.

#include <cuda_runtime.h>

#include "site_loop.cuh"

namespace {

namespace cg = cooperative_groups;
using dqmc::mbar_expect;
using dqmc::mbar_init;
using dqmc::mbar_wait;
using dqmc::peer_addr;
using dqmc::smem_addr;
using dqmc::Vec;

// The fewest CTAs with R <= 64 sites each (C = 1 up to n = 64, 4 at 256, 16
// at 1024; past it 16 with R <= 128), 128 or 256 threads; the flush by
// owner keeps two pieces of G in registers.  LEAN: the lean layout.
template <typename T, int NFL, bool LEAN>
__global__ void __launch_bounds__(dqmc::SITE_THREADS, 1)
delayed_slice_kernel(const dqmc::SiteLoopArgs<T> args) {
  dqmc::site_loop_body<T, NFL, 64, NFL == 2, LEAN>(args);
}

// #6: one slice of the rank-1 loop on the cluster of walker blockIdx.y
// (see the head of this file).  Walker w's rows are split over the C CTAs
// of its cluster, R = ceil(n / C) each: CTA c owns rows a0 = c R ...
// a0 + own - 1.  Thread t carries the VB-byte column vector j = t % NV
// (VW = VB / sizeof(T) entries, NV = ceil(n / VW)) of the own rows
// l = t / NV, + RG, ... (RG = threads / NV), and only it ever touches those
// entries, so the update needs no barrier of its own.  Its first KR rows live in its registers, the next
// rs rows of the CTA in shared memory (padded to ldn = NV VW columns), the
// rest in place in G (float64 rows past the CTA's 227 KB).  Per visit v
// (site i, the next site nx):
//   1. one __syncthreads: the CTA is done with visit v - 1, so it tells
//      every CTA that its copy of visit v - 1's row slot is free (a remote
//      arrive on their free[] mbarriers) and may read colbuf[v & 1];
//   2. wait for row i of G (after visit v - 1) in slot v % D: its owner
//      pushes it into every CTA with st.async, counted on that slot's
//      full[] mbarrier; every thread takes the decision from G_ii there;
//   3. if accepted, G[a][b] = fma(prefac G[a][i], G[i][b] - [b = i],
//      G[a][b]) on the own entries (G[a][i] from colbuf[v & 1]), the
//      registers first, then row nx, then the rest; the owner threads of
//      row nx push it, updated, into slot (v + 1) % D of every CTA once
//      every CTA has freed that slot's visit v + 1 - D, and the owners of
//      column nx write it into colbuf[(v + 1) & 1].  A rejected visit
//      only pushes row nx and copies column nx.
// So no CTA waits for another's update, only for the rows it needs, and a
// push waits for a slot freed D - 1 visits before.  On one CTA (C = 1) the
// rows and columns go through shared memory under the __syncthreads alone.
template <typename T>
struct Rank1Args {
  T* G;
  T* acc;
  const int* order;
  long long s_order;
  const T* gb;
  const T* delta;
  const T* us;
  int n;
  int rows_smem;  // own rows of the CTA held in shared memory
};

// Threads per CTA at most (16 warps; float64 at n = 1024 needs 512
// vectors of 16 bytes, and past it takes vectors of 32), and own rows per
// thread held in registers: 32 registers of G per thread in either type
// and width (RANK1_KR rows of 16 bytes, half as many of 32).  (256 threads
// of 32 rows each ran 1.3-1.7x slower in float32 on an H100: fewer warps
// to hide shared memory.)
constexpr int RANK1_THREADS = 512;
constexpr int RANK1_KR = 8;
constexpr int RANK1_MAX_N = dqmc::SITE_SLICE_MAX_N;  // 16 CTAs, R <= 128
constexpr int RANK1_BATCH = 4;  // rows in memory loaded together
constexpr int RANK1_SLOTS = 4;  // row slots across a cluster (2 on one CTA)

__device__ __forceinline__ void st_async_vec(unsigned dst, const float (&x)[4],
                                             unsigned bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 [%0], "
      "{%1, %2, %3, %4}, [%5];" ::"r"(dst),
      "r"(__float_as_uint(x[0])), "r"(__float_as_uint(x[1])),
      "r"(__float_as_uint(x[2])), "r"(__float_as_uint(x[3])), "r"(bar)
      : "memory");
}

// (float64: 16 bytes per st.async, each counted on the barrier)
template <int N>
__device__ __forceinline__ void st_async_vec(unsigned dst,
                                             const double (&x)[N],
                                             unsigned bar) {
#pragma unroll
  for (int h = 0; h < N; h += 2)
    asm volatile(
        "st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.b64 "
        "[%0], {%1, %2}, [%3];" ::"r"(dst + 8 * h),
        "l"(__double_as_longlong(x[h])), "l"(__double_as_longlong(x[h + 1])),
        "r"(bar)
        : "memory");
}

// one arrival on an mbarrier of a CTA of the cluster (a shared::cluster
// address), releasing this thread's earlier reads of that CTA's slot
__device__ __forceinline__ void mbar_arrive_remote(unsigned bar) {
  asm volatile(
      "mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];" ::"r"(
          bar)
      : "memory");
}

// The byte layout of one CTA's shared memory: the full[] and free[]
// mbarriers of the D row slots, the slots (D x ldn), colbuf (2 x Rp) and
// the pending visit's factors of the rows in memory (Rp), the
// visit order (n ints), then the own rows kept in shared memory (rs x
// ldn), each piece 16-byte aligned.  KR RG of the own rows live in
// registers; rs of the others fit in smem_max.
struct Rank1Layout {
  int C, R, Rp, NV, ldn, threads, rs;
  size_t row_off, col_off, ord_off, g_off, smem;
};

__host__ __device__ inline size_t align16(size_t b) {
  return (b + 15) / 16 * 16;
}

template <typename T, int VB>
__host__ __device__ inline Rank1Layout rank1_layout(int n, int C,
                                                    size_t smem_max) {
  constexpr int VW = VB / sizeof(T);
  Rank1Layout L;
  const int D = C == 1 ? 2 : RANK1_SLOTS;
  L.C = C;
  L.R = (n + C - 1) / C;
  L.Rp = (L.R + VW - 1) / VW * VW;
  L.NV = (n + VW - 1) / VW;
  L.ldn = L.NV * VW;
  constexpr int KR = RANK1_KR * 16 / VB;
  const int fit = RANK1_THREADS / L.NV;  // >= 1 for NV <= 512
  const int RG = L.R < fit ? L.R : fit;
  L.threads = L.NV * RG;
  const int mem = L.R > KR * RG ? L.R - KR * RG : 0;
  L.row_off = align16(2 * 8 * (size_t)D);
  L.col_off = L.row_off + align16(sizeof(T) * L.ldn * (size_t)D);
  L.ord_off = L.col_off + align16(3 * sizeof(T) * L.Rp);
  L.g_off = L.ord_off + align16(sizeof(int) * (size_t)n);
  const size_t row = sizeof(T) * L.ldn;
  const size_t room = smem_max > L.g_off ? (smem_max - L.g_off) / row : 0;
  L.rs = room < (size_t)mem ? (int)room : mem;
  L.smem = L.g_off + row * L.rs;
  return L;
}

template <typename T, bool ONE, int VB>
__global__ void __launch_bounds__(RANK1_THREADS, 1)
rank1_sites_kernel(const Rank1Args<T> a) {
  constexpr int VW = VB / sizeof(T);
  constexpr int B = RANK1_BATCH, KR = RANK1_KR * 16 / VB;
  using V = Vec<T, VW>;
  constexpr int D = ONE ? 2 : RANK1_SLOTS;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int n = a.n;
  int C = 1, c = 0;
  if constexpr (!ONE) {
    C = (int)cg::this_cluster().num_blocks();
    c = (int)cg::this_cluster().block_rank();
  }
  const Rank1Layout L = rank1_layout<T, VB>(n, C, 0);
  const int R = L.R, NV = L.NV, ldn = L.ldn, Rp = L.Rp;
  const int a0 = c * R;
  const int own = max(0, min(R, n - a0));
  unsigned long long* full = reinterpret_cast<unsigned long long*>(smem_raw);
  unsigned long long* freed = full + D;
  T* slots = reinterpret_cast<T*>(smem_raw + L.row_off);   // D x ldn
  T* colbuf = reinterpret_cast<T*>(smem_raw + L.col_off);  // 2 x Rp
  T* pcl = colbuf + 2 * Rp;  // prefac G[a][i] of the pending visit
  int* ords = reinterpret_cast<int*>(smem_raw + L.ord_off);
  // (g_off does not depend on rows_smem)
  T* Gs = reinterpret_cast<T*>(smem_raw + L.g_off);

  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int j = tid % NV, rg = tid / NV, RG = nthreads / NV;
  const int jb = j * VW;
  const int LR = KR * RG;  // own rows l < LR are in registers
  const int rs = min(max(own - LR, 0), a.rows_smem);
  const int w = blockIdx.y;
  T* Gw = a.G + (long long)w * n * n;
  const int* order = a.order + w * a.s_order;
  const long long ws = (long long)w * n;
  const T* gb = a.gb + ws;
  const T* delta = a.delta + ws;
  const T* us = a.us + ws;
  const bool gvec = n % VW == 0;  // G's rows 16-byte aligned
  const unsigned row_bytes = (unsigned)VB * NV;
  T greg[KR][VW];  // own rows rg + k RG, k < KR
  // Across CTAs the rows in memory lag one accepted visit behind (pend):
  // its update, pcl[l] times this thread's rvp, is applied with the next
  // accepted visit's in one pass, each entry's two fmas in visit order;
  // row nx and column nx are brought up to date where they are read.  (On
  // one CTA, whose default shapes keep every row in registers, pend stays
  // false.)
  bool pend = false;
  T rvp[VW];

  auto gload = [&](int l, T (&x)[VW]) {  // own row l's vector j from G
    const T* g = Gw + (long long)(a0 + l) * n + jb;
    if (gvec) {
      const V v = *reinterpret_cast<const V*>(g);
#pragma unroll
      for (int q = 0; q < VW; ++q) x[q] = v.v[q];
    } else {
#pragma unroll
      for (int q = 0; q < VW; ++q) x[q] = jb + q < n ? g[q] : T(0);
    }
  };
  auto gstore = [&](int l, const T (&x)[VW]) {
    T* g = Gw + (long long)(a0 + l) * n + jb;
    if (gvec) {
      V v;
#pragma unroll
      for (int q = 0; q < VW; ++q) v.v[q] = x[q];
      *reinterpret_cast<V*>(g) = v;
    } else {
#pragma unroll
      for (int q = 0; q < VW; ++q)
        if (jb + q < n) g[q] = x[q];
    }
  };
  // own row l >= LR: shared memory for l - LR < rs, else G
  auto load = [&](int l, T (&x)[VW]) {
    if (l - LR < rs) {
      const V v =
          *reinterpret_cast<const V*>(Gs + (l - LR) * ldn + jb);
#pragma unroll
      for (int q = 0; q < VW; ++q) x[q] = v.v[q];
    } else {
      gload(l, x);
    }
  };
  auto store = [&](int l, const T (&x)[VW]) {
    if (l - LR < rs) {
      V v;
#pragma unroll
      for (int q = 0; q < VW; ++q) v.v[q] = x[q];
      *reinterpret_cast<V*>(Gs + (l - LR) * ldn + jb) = v;
    } else {
      gstore(l, x);
    }
  };
  auto pick = [](const T (&x)[VW], int q) {
    T e = x[0];
#pragma unroll
    for (int p = 1; p < VW; ++p) e = p == q ? x[p] : e;
    return e;
  };
  // visit u's row (this thread's vector of it) into slot u % D of every
  // CTA, once every CTA has freed that slot's visit u - D
  auto push = [&](int u, const T (&x)[VW]) {
    const int sl = u % D;
    if constexpr (ONE) {
      V v;
#pragma unroll
      for (int q = 0; q < VW; ++q) v.v[q] = x[q];
      *reinterpret_cast<V*>(slots + sl * ldn + jb) = v;
    } else {
      if (u >= D) mbar_wait(smem_addr(freed + sl), (u / D - 1) & 1);
      const unsigned dst = smem_addr(slots + sl * ldn + jb);
      const unsigned bar = smem_addr(full + sl);
      for (int r = 0; r < C; ++r)
        st_async_vec(peer_addr(dst, r), x, peer_addr(bar, r));
    }
  };
  // visit u's row nx and column nx from G as it stands, the pending
  // update applied (visit 0, and after a rejected visit): row nx pushed,
  // column nx into colbuf[u & 1]
  auto produce = [&](int u, int nx) {
    const int lnx = nx - a0;
    if (lnx >= 0 && lnx < own && lnx % RG == rg) {
      if (lnx < LR) {
#pragma unroll
        for (int k = 0; k < KR; ++k)
          if (rg + k * RG == lnx) push(u, greg[k]);
      } else {
        T x[VW];
        load(lnx, x);
        if (pend) {
          const T cp = pcl[lnx];
#pragma unroll
          for (int q = 0; q < VW; ++q) x[q] = fma(cp, rvp[q], x[q]);
        }
        push(u, x);
      }
    }
    if (nx / VW == j) {
      T* coln = colbuf + (u & 1) * Rp;
      const int q = nx % VW;
#pragma unroll
      for (int k = 0; k < KR; ++k) {
        const int l = rg + k * RG;
        if (l < own) coln[l] = pick(greg[k], q);
      }
      for (int l = rg + LR; l < own; l += RG) {
        T x[VW];
        load(l, x);
        const T e = pick(x, q);
        coln[l] = pend ? fma(pcl[l], pick(rvp, q), e) : e;
      }
    }
  };

  for (int e = tid; e < n; e += nthreads) ords[e] = order[e];
#pragma unroll
  for (int k = 0; k < KR; ++k) {
    const int l = rg + k * RG;
    if (l < own) gload(l, greg[k]);
  }
  for (int l = rg + LR; l - LR < rs; l += RG) {
    T x[VW];
    gload(l, x);
    store(l, x);
  }
  if constexpr (!ONE) {
    if (tid < 2 * D) mbar_init(smem_addr(full + tid), tid < D ? 1 : C);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    __syncthreads();
    if (tid < D && tid < n) mbar_expect(smem_addr(full + tid), row_bytes);
    // every CTA's barriers are armed before any row reaches them
    cg::this_cluster().sync();
  } else {
    __syncthreads();
  }
  produce(0, ords[0]);

  for (int v = 0; v < n; ++v) {
    const int i = ords[v];
    const int nx = v + 1 < n ? ords[v + 1] : -1;
    const T d = __ldg(delta + v), g = __ldg(gb + v), u = __ldg(us + v);
    __syncthreads();
    if constexpr (!ONE) {
      if (v > 0 && tid < C)
        mbar_arrive_remote(peer_addr(smem_addr(freed + (v - 1) % D), tid));
      mbar_wait(smem_addr(full + v % D), (v / D) & 1);
      if (tid == 0 && v + D < n)
        mbar_expect(smem_addr(full + v % D), row_bytes);
    }
    const T* row = slots + (v % D) * ldn;
    const T gii = row[i];
    const T rf = fma(T(1) - gii, d, T(1));
    const bool accept = u < g * rf * rf;
    // (across CTAs by a thread that makes no remote arrive)
    if (c == 0 && tid == (ONE ? 0 : nthreads - 1))
      a.acc[ws + v] = accept ? T(1) : T(0);
    if (!accept) {
      if (nx >= 0) produce(v + 1, nx);
      continue;
    }
    const T prefac = d / rf;
    T rv[VW];
    {
      const V r = *reinterpret_cast<const V*>(row + jb);
#pragma unroll
      for (int q = 0; q < VW; ++q)
        rv[q] = jb + q == i ? r.v[q] - T(1) : r.v[q];
    }
    const T* col = colbuf + (v & 1) * Rp;
    T* coln = colbuf + ((v + 1) & 1) * Rp;
    const int lnx = nx - a0;
    const bool colnx = nx >= 0 && nx / VW == j;
    const int qn = nx % VW;
    const bool rownx = nx >= 0 && lnx >= 0 && lnx < own && lnx % RG == rg;
    // across CTAs, row nx first: its push is the next visit's wait (on
    // one CTA the rows wait for the next __syncthreads anyway)
    const bool early = !ONE && rownx;
    if (early) {
      T x[VW];
      if (lnx < LR) {
#pragma unroll
        for (int k = 0; k < KR; ++k)
          if (rg + k * RG == lnx) {
#pragma unroll
            for (int q = 0; q < VW; ++q) x[q] = greg[k][q];
          }
      } else {
        load(lnx, x);
        if (pend) {
          const T cp = pcl[lnx];
#pragma unroll
          for (int q = 0; q < VW; ++q) x[q] = fma(cp, rvp[q], x[q]);
        }
      }
      const T cl = prefac * col[lnx];
#pragma unroll
      for (int q = 0; q < VW; ++q) x[q] = fma(cl, rv[q], x[q]);
      push(v + 1, x);
      if (lnx < LR) {
#pragma unroll
        for (int k = 0; k < KR; ++k)
          if (rg + k * RG == lnx) {
#pragma unroll
            for (int q = 0; q < VW; ++q) greg[k][q] = x[q];
          }
      } else if (pend) {
        store(lnx, x);  // (else it keeps lagging with the other rows)
      }
      if (colnx) coln[lnx] = pick(x, qn);
    }
    const int skip = early ? lnx : -1;
#pragma unroll
    for (int k = 0; k < KR; ++k) {
      const int l = rg + k * RG;
      if (l < own && l != skip) {
        const T cl = prefac * col[l];
#pragma unroll
        for (int q = 0; q < VW; ++q) greg[k][q] = fma(cl, rv[q], greg[k][q]);
        if (ONE && rownx && l == lnx) push(v + 1, greg[k]);
        if (colnx) coln[l] = pick(greg[k], qn);
      }
    }
    if (ONE || pend) {
      // this visit's update (on one CTA, or after the pending visit's in
      // the same pass)
      for (int l0 = rg + LR; l0 < own; l0 += B * RG) {
        T x[B][VW], cp[B], cl[B];
#pragma unroll
        for (int b = 0; b < B; ++b) {
          const int l = l0 + b * RG;
          if (l < own) {
            load(l, x[b]);
            cp[b] = pcl[l];
            cl[b] = prefac * col[l];
          }
        }
#pragma unroll
        for (int b = 0; b < B; ++b) {
          const int l = l0 + b * RG;
          if (l < own && l != skip) {
#pragma unroll
            for (int q = 0; q < VW; ++q) {
              if (pend) x[b][q] = fma(cp[b], rvp[q], x[b][q]);
              x[b][q] = fma(cl[b], rv[q], x[b][q]);
            }
            store(l, x[b]);
            if (ONE && rownx && l == lnx) push(v + 1, x[b]);
            if (colnx) coln[l] = pick(x[b], qn);
          }
        }
      }
      pend = false;
    } else {
      // this visit's update of the rows in memory waits for the next
      // accepted one; row nx and column nx are made current here
      for (int l = rg + LR; l < own; l += RG) {
        const T cl = prefac * col[l];
        if (j == 0) pcl[l] = cl;
        const bool nrow = ONE && rownx && l == lnx;
        if (l != skip && (nrow || colnx)) {
          T x[VW];
          load(l, x);
#pragma unroll
          for (int q = 0; q < VW; ++q) x[q] = fma(cl, rv[q], x[q]);
          if (nrow) push(v + 1, x);
          if (colnx) coln[l] = pick(x, qn);
        }
      }
#pragma unroll
      for (int q = 0; q < VW; ++q) rvp[q] = rv[q];
      pend = true;
    }
  }
  // no CTA leaves while another may still arrive on its barriers (and
  // pcl is seen by every thread)
  if constexpr (!ONE)
    cg::this_cluster().sync();
  else
    __syncthreads();
  if (pend) {
    for (int l = rg + LR; l < own; l += RG) {
      T x[VW];
      load(l, x);
      const T cp = pcl[l];
#pragma unroll
      for (int q = 0; q < VW; ++q) x[q] = fma(cp, rvp[q], x[q]);
      store(l, x);
    }
  }
#pragma unroll
  for (int k = 0; k < KR; ++k) {
    const int l = rg + k * RG;
    if (l < own) gstore(l, greg[k]);
  }
  for (int l = rg + LR; l - LR < rs; l += RG) {
    T x[VW];
    load(l, x);
    gstore(l, x);
  }
}

template <typename T, int NFL>
int launch_delayed_slice(T* G, T* acc, const int* order, long long s_order,
                         const T* gb, const T* delta, const T* us, T* sgn,
                         int n, int k, int batch, void* stream) {
  if (n <= 0 || n > dqmc::SITE_SLICE_MAX_N || k <= 0 ||
      k > dqmc::SITE_KMAX || batch <= 0 || batch > 65535 ||
      (s_order != 0 && s_order != n) || (NFL == 2 && sgn == nullptr))
    return (int)cudaErrorInvalidValue;
  const dqmc::SiteLoopArgs<T> args{G,  acc, n,   order, s_order, gb, delta,
                                   us, n,   sgn, n,     k,       true};
  static dqmc::SiteLaunchCache caches[2];  // full and lean layout
  const bool lean = dqmc::site_lean<T>(n, k, NFL, 64);
  const size_t smem = dqmc::site_smem_bytes<T>(n, k, NFL, 64, lean);
  if (!lean)
    return dqmc::launch_site_loop<T>(delayed_slice_kernel<T, NFL, false>,
                                     caches[0], args, smem, 64, batch,
                                     stream);
  // only float64 with two flavors passes the full layout's budget at
  // n <= 2048, so only it has a lean build
  if constexpr (sizeof(T) == 8 && NFL == 2)
    return dqmc::launch_site_loop<T>(delayed_slice_kernel<T, NFL, true>,
                                     caches[1], args, smem, 64, batch,
                                     stream);
  return (int)cudaErrorInvalidValue;
}

// The cluster of #6 for n sites: the fewest CTAs (a power of two, at most
// 16) with R = ceil(n / C) <= RANK1_RMAX rows each, the fastest of C = 1
// ... 16 at n = 36, 256 and 1024 on an H100 (scripts/seed_split.py rank1
// --parts times builds each); past n = 1024, 16 CTAs of up to 128 rows.
constexpr int RANK1_RMAX = 64;

inline int rank1_cluster(int n) {
  int C = 1;
  while (C < dqmc::SITE_CLUSTER_MAX && (n + C - 1) / C > RANK1_RMAX) C *= 2;
  return C;
}

// One launch of rank1_sites_kernel<T, ONE, VB> (ONE: C = 1) in clusters of
// L.C CTAs; each instantiation keeps, per device, its shared-memory
// attribute and whether its cluster fits at the last n.
template <typename T, bool ONE, int VB>
int launch_rank1(const Rank1Args<T>& args, const Rank1Layout& L, int batch,
                 int dev, void* stream) {
  static dqmc::SiteLaunchCache caches;
  dqmc::SiteLaunchEntry& cache = caches.of(dev);
  const auto kernel = rank1_sites_kernel<T, ONE, VB>;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(L.C, batch, 1);
  cfg.blockDim = dim3(L.threads, 1, 1);
  cfg.dynamicSmemBytes = L.smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = L.C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err;
  if (dev != cache.dev || (int)L.smem > cache.smem) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L.smem);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return (int)err;
    cache.dev = dev;
    cache.smem = (int)L.smem;
    cache.n = -1;
  }
  if (args.n != cache.n) {
    err = cudaOccupancyMaxActiveClusters(&cache.clusters, kernel, &cfg);
    if (err != cudaSuccess) return (int)err;
    cache.n = args.n;
  }
  if (cache.clusters < 1) return (int)cudaErrorLaunchOutOfResources;
  err = cudaLaunchKernelEx(&cfg, kernel, args);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <typename T>
int launch_rank1_sites(T* G, T* acc, const int* order, long long s_order,
                       const T* gb, const T* delta, const T* us, int n,
                       int batch, void* stream) {
  if (n <= 0 || n > RANK1_MAX_N || batch <= 0 || batch > 65535 ||
      (s_order != 0 && s_order != n))
    return (int)cudaErrorInvalidValue;
  int dev = 0, smem_max = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&smem_max,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  const int C = rank1_cluster(n);
  // float64 rows of more than RANK1_THREADS 16-byte vectors (n > 1024,
  // on 16 CTAs): 32-byte vectors
  if constexpr (sizeof(T) == 8) {
    if ((n + 1) / 2 > RANK1_THREADS) {
      const Rank1Layout L = rank1_layout<T, 32>(n, C, (size_t)smem_max);
      if (L.g_off > (size_t)smem_max)
        return (int)cudaErrorLaunchOutOfResources;
      const Rank1Args<T> args{G, acc, order, s_order, gb, delta, us, n, L.rs};
      return launch_rank1<T, false, 32>(args, L, batch, dev, stream);
    }
  }
  const Rank1Layout L = rank1_layout<T, 16>(n, C, (size_t)smem_max);
  if (L.g_off > (size_t)smem_max) return (int)cudaErrorLaunchOutOfResources;
  const Rank1Args<T> args{G, acc, order, s_order, gb, delta, us, n, L.rs};
  return L.C == 1 ? launch_rank1<T, true, 16>(args, L, batch, dev, stream)
                  : launch_rank1<T, false, 16>(args, L, batch, dev, stream);
}

}  // namespace

#define DQMC_SITE_API(T, SFX)                                                \
  extern "C" int dqmc_delayed_slice##SFX(                                    \
      T* G, T* acc, const int* order, long long s_order, const T* gb,        \
      const T* delta, const T* us, T* sgn, int n, int k, int batch,          \
      void* stream) {                                                        \
    return launch_delayed_slice<T, 1>(G, acc, order, s_order, gb, delta, us, \
                                      sgn, n, k, batch, stream);             \
  }                                                                          \
  extern "C" int dqmc_delayed_slice_2f##SFX(                                 \
      T* G, T* acc, const int* order, long long s_order, const T* gb,        \
      const T* delta, const T* us, T* sgn, int n, int k, int batch,          \
      void* stream) {                                                        \
    return launch_delayed_slice<T, 2>(G, acc, order, s_order, gb, delta, us, \
                                      sgn, n, k, batch, stream);             \
  }                                                                          \
  extern "C" int dqmc_rank1_sites##SFX(                                      \
      T* G, T* acc, const int* order, long long s_order, const T* gb,        \
      const T* delta, const T* us, int n, int batch, void* stream) {         \
    return launch_rank1_sites<T>(G, acc, order, s_order, gb, delta, us, n,   \
                                 batch, stream);                             \
  }

DQMC_SITE_API(float, _f32)
DQMC_SITE_API(double, _f64)

// The cluster of the site loop for n sites with R <= rmax (32: the fused
// loop, 64: the delayed slice): its CTAs per walker, and the dynamic shared
// memory of one CTA in bytes at rank k, nfl flavors, itemsize 4 or 8, in
// the layout it is launched with (ops/kernels.py delayed_slice_smem
// mirrors the second for the host).
template <typename T>
long long launched_smem_bytes(int n, int k, int nfl, int rmax) {
  return (long long)dqmc::site_smem_bytes<T>(
      n, k, nfl, rmax, dqmc::site_lean<T>(n, k, nfl, rmax));
}

extern "C" int dqmc_site_cluster(int n, int rmax) {
  return dqmc::site_cluster(n, rmax).C;
}

extern "C" long long dqmc_site_smem_bytes(int n, int k, int nfl,
                                          int itemsize, int rmax) {
  return itemsize == 8 ? launched_smem_bytes<double>(n, k, nfl, rmax)
                       : launched_smem_bytes<float>(n, k, nfl, rmax);
}
