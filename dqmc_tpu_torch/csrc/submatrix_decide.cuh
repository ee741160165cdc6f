// The submatrix scheme's shared body: one group's decisions and flush
// operands, used by the per-slice engine's submatrix update (#5,
// submatrix_update.cu: one launch per group on C CTAs per walker, then the
// whole card's rank-k flush) and by the fused block's submatrix site loop
// (#2c, fused_block.cu: a whole slice per launch on one thread-block
// cluster per walker, submatrix_slice_body below).
//
// With I the group's candidate sites and P its accepted subset, candidate
// t's ratio is the bordering Schur complement of M = D_P^{-1} + (I - G)[P, P]
// through W = M^{-1}, kept in a fixed k x k buffer masked to the accepted
// slots:  r = 1 + delta (1 - G_tt) - delta * b W c,  b = -G[t, P],
// c = -G[P, t];  accept on u < gb r^2 (>= 0: one stored flavor, det^2).  An
// accepted candidate borders W; a rejected one leaves its row and column
// exactly zero, so the composite flush G += G[:, I] W (G[I, :] - E_I) has
// the rank of the acceptances.  Per group:
//   1. every thread of the CTA gathers G[I, I] of the group-base G at once
//      (8 loads in flight per thread), not in k dependent rounds;
//   2. warp 0 takes the k decisions on k x k data (W in registers, lane p
//      holding row p and column p; G[I, I] and its transpose in shared
//      memory, 14 KB in f32, 28 KB in f64, with gb, delta and u of the
//      group's visits), while
//      the other warps load the CTA's share of the flush operands: its own
//      rows of Ut = G[:, I]^T and the rows I of G at its own columns;
//   3. M = W (G[I, :] - E_I) at the CTA's own columns.
// Every CTA of a walker decides on the same bits, so no decision travels.
// The arithmetic of the decisions, of M (summed from 0 in q order) and of
// the flush (from 0 in s order, then added to G) is the first design's
// (one warp per walker, then a separate operand kernel), whose bits both
// engines keep.  Plain FP32/FP64 FMA, no tensor cores, no atomics.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "site_loop.cuh"

namespace dqmc {

constexpr int DECIDE_KMAX = 32;
constexpr int DECIDE_LD = DECIDE_KMAX + 4;  // rows 16-byte aligned

// The decisions' shared data (16-byte aligned rows: read as 16-byte loads)
template <typename T>
struct alignas(16) DecideSmem {
  T GII[DECIDE_KMAX][DECIDE_LD];   // G[I, I] of the group-base G
  T GIIT[DECIDE_KMAX][DECIDE_LD];  // its transpose
  T Wm[DECIDE_KMAX][DECIDE_LD];    // W after the decisions
  T sw_s[DECIDE_KMAX], y_s[DECIDE_KMAX];  // an accepted visit's update
};

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Step 1, by threads tid = 0 ... nthreads - 1: G[I, I] (I = the group's
// cnt sites, in shared memory) and its transpose into sm.GII and sm.GIIT.
// G is read past L1 (other SMs write it between groups).
template <typename T>
__device__ __forceinline__ void sub_gather(DecideSmem<T>& sm,
                                           const T* __restrict__ G, int n,
                                           const int* I, int cnt, int tid,
                                           int nthreads) {
  constexpr int PER = 8;
  const int total = cnt * cnt;
  for (int e0 = tid; e0 < total; e0 += PER * nthreads) {
    T v[PER];
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int e = e0 + j * nthreads;
      v[j] = e < total
                 ? __ldcg(G + (long long)I[e / cnt] * n + I[e % cnt])
                 : T(0);
    }
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int e = e0 + j * nthreads;
      if (e < total) {
        sm.GII[e / cnt][e % cnt] = v[j];
        sm.GIIT[e % cnt][e / cnt] = v[j];
      }
    }
  }
}

// Step 2: the cnt sequential decisions, by the 32 lanes of one warp, after
// sub_gather.  gb, delta, u and the accept flags (0 or 1) are the group's,
// indexed by its visits t = 0 ... cnt - 1.  Leaves W in sm.Wm[:cnt][:cnt].
// W lives in registers: lane p holds its row W[p][:] and its column
// W[:][p], so a visit's only shared loads are G's row t and column t (as
// 16-byte broadcasts) and, when accepted, two 32-vectors.  Per visit:
// W c (lane p: row p) and b W (lane q: column q), b = -G[t, :] and
// c = -G[:, t], each summed from 0 in q order: W is exactly zero outside
// the accepted rows and columns, so a term there adds an exact zero and b
// and c need no mask; b W c summed across the warp, the same bits in every
// lane; then, if accepted, every lane updates its row and its column (the
// same products, so both copies keep the same bits): W[p][q] +=
// (inv_s Wc_p) bW_q, row t = -inv_s bW, column t = -inv_s Wc, W[t][t] =
// inv_s.  The loop is bound by its latency and its one warp's issue: at
// k = 32 two 32-long FMA chains, five shuffles and, when accepted, one
// shared round trip and 2 k FMAs.
template <typename T>
__device__ __forceinline__ void sub_decide_warp(DecideSmem<T>& sm, int cnt,
                                                const T* gb, const T* delta,
                                                const T* us, int* acc,
                                                int lane) {
  constexpr int K = DECIDE_KMAX, VW = 16 / sizeof(T);
  const bool act = lane < cnt;
  T wr[K], wc[K];  // W[lane][q], W[q][lane]
#pragma unroll
  for (int q = 0; q < K; ++q) wr[q] = wc[q] = T(0);
  for (int t = 0; t < cnt; ++t) {
    const T d = delta[t], g = gb[t], u = us[t], gtt = sm.GII[t][t];
    const T b_own = act ? -sm.GII[t][lane] : T(0);
    T Wc = T(0), bW = T(0);
#pragma unroll
    for (int q = 0; q < K; q += VW) {
      const Vec<T> cv = *reinterpret_cast<const Vec<T>*>(&sm.GIIT[t][q]);
      const Vec<T> bv = *reinterpret_cast<const Vec<T>*>(&sm.GII[t][q]);
#pragma unroll
      for (int j = 0; j < VW; ++j) {
        if (q + j < cnt) {
          Wc = fma(wr[q + j], -cv.v[j], Wc);
          bW = fma(-bv.v[j], wc[q + j], bW);
        }
      }
    }
    const T bWc = warp_sum(b_own * Wc);  // the same bits in every lane
    const T rf = T(1) + d * (T(1) - gtt) - d * bWc;
    const bool accept = u < g * rf * rf;  // >= 0
    if (accept) {
      // the border as part of one rank-1 update: W += inv_s x y^T with
      // x = W c and y = b W except x_t = y_t = -1 (row and column t of W
      // are zero before, so row t becomes -inv_s bW, column t -inv_s Wc
      // and W[t][t] inv_s, each rounded once as the first design did)
      const T inv_s = d / rf;
      const T x = lane == t ? T(-1) : Wc;
      const T y = lane == t ? T(-1) : bW;
      const T sw = inv_s * x;
      sm.sw_s[lane] = sw;
      sm.y_s[lane] = y;
      __syncwarp();
#pragma unroll
      for (int q = 0; q < K; q += VW) {
        const Vec<T> sq = *reinterpret_cast<const Vec<T>*>(&sm.sw_s[q]);
        const Vec<T> yq = *reinterpret_cast<const Vec<T>*>(&sm.y_s[q]);
#pragma unroll
        for (int j = 0; j < VW; ++j) {
          // W[lane][q + j] and W[q + j][lane]: the same products as the
          // lanes that own them; past cnt both stay exactly zero
          wr[q + j] = fma(sw, yq.v[j], wr[q + j]);
          wc[q + j] = fma(sq.v[j], y, wc[q + j]);
        }
      }
      // the vectors read before the next visit writes them
      __syncwarp();
    }
    if (lane == 0) acc[t] = accept;
  }
  if (act) {
#pragma unroll
    for (int q = 0; q < K; ++q) sm.Wm[lane][q] = wr[q];
  }
  __syncwarp();
}

// Step 2's other half, by threads tid = 0 ... nthreads - 1 (the warps that
// do not decide): for the own indices a = a0 + l, l < own, the flush's
// left operand Ut[s][a] = G[a][I_s] (into Ut at Ut + s ut_stride + l) and
// GR[q][l] = G[I_q][a] - [I_q == a] (Rp apart), the input of M.
template <typename T>
__device__ __forceinline__ void sub_panels(const T* __restrict__ G, int n,
                                           const int* I, int cnt, int a0,
                                           int own, T* Ut,
                                           long long ut_stride, T* GR,
                                           int Rp, int tid, int nthreads) {
  constexpr int PER = 8;
  const int total = cnt * own;
  for (int e0 = tid; e0 < total; e0 += PER * nthreads) {
    T u[PER], r[PER];
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int e = e0 + j * nthreads;
      const int s = e / max(own, 1), l = e % max(own, 1);
      const bool in = e < total;
      u[j] = in ? __ldcg(G + (long long)(a0 + l) * n + I[s]) : T(0);
      r[j] = in ? __ldcg(G + (long long)I[s] * n + a0 + l) -
                      (I[s] == a0 + l ? T(1) : T(0))
                : T(0);
    }
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int e = e0 + j * nthreads;
      if (e < total) {
        const int s = e / own, l = e % own;
        Ut[s * ut_stride + l] = u[j];
        GR[s * Rp + l] = r[j];
      }
    }
  }
}

// Step 3, after the decisions: M[p][l] = sum_q W[p][q] GR[q][l] for the own
// columns l < own and p < cnt (into M at M + p m_stride + l), summed from
// 0 in q order.  Four threads share a column, each every fourth p.
template <typename T>
__device__ __forceinline__ void sub_m(const DecideSmem<T>& sm, const T* GR,
                                      int Rp, T* M, long long m_stride,
                                      int cnt, int own, int tid,
                                      int nthreads) {
  const int cw = max(nthreads / 4, 1);
  for (int l = tid % cw; l < own; l += cw) {
    for (int p = tid / cw; p < cnt; p += max(nthreads / cw, 1)) {
      T m = T(0);
#pragma unroll
      for (int q = 0; q < DECIDE_KMAX; ++q) {
        const T w = sm.Wm[p][q], g = GR[min(q, cnt - 1) * Rp + l];
        if (q < cnt) m = fma(w, g, m);
      }
      M[p * m_stride + l] = m;
    }
  }
}

// The rows of G per CTA of submatrix_slice_body's cluster: R <= 32, as the
// fused delayed loop (site_cluster(n, SUB_RMAX)).
constexpr int SUB_RMAX = 32;

// Dynamic shared memory of one CTA of submatrix_slice_body, in bytes: the
// decision data, the own rows of Ut, the own columns of M and of G[I, :]
// (k x Rp each), the slice's gb, u and delta by visit (n each) and, as
// ints, the visit order and the accept flags (2 n).  ops/kernels.py
// submatrix_slice_smem mirrors it for the host; fused_block.cu exports it
// (dqmc_sub_smem_bytes).
template <typename T>
size_t sub_smem_bytes(int n, int k) {
  const size_t Rp = site_cluster(n, SUB_RMAX).Rp;
  return sizeof(DecideSmem<T>) +
         sizeof(T) * (3 * (size_t)k * Rp + 3 * (size_t)n) +
         sizeof(int) * 2 * (size_t)n;
}

// One slice of the submatrix scheme on the cluster of walker blockIdx.y
// (blockIdx.x = the CTA's rank c): CTA c owns the indices a0 = c R ...
// a0 + own - 1 (site_cluster(n, SUB_RMAX): R <= 32), their rows of G and
// their columns of M.  Per group of cnt <= k visits: steps 1 to 3 above
// (the own rows of Ut and the own columns of M kept in shared memory); a
// cluster barrier, after which no CTA reads the group-base G any more and
// every M is complete; the flush of the own rows, G[a][j] += sum_s
// Ut[s][a] M[s][j], with M[s][j] read from the shared memory of j's owner
// (site_loop.cuh's flush by column); a cluster barrier (G written, M
// free).  gb and delta are indexed by visit (per_visit) or by site; the
// flags are written once, at the end, by CTA 0.
template <typename T>
__device__ __forceinline__ void submatrix_slice_body(
    const SiteLoopArgs<T>& a) {
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
  DecideSmem<T>& sm = *reinterpret_cast<DecideSmem<T>*>(smem_raw);
  T* Uo = reinterpret_cast<T*>(smem_raw + sizeof(DecideSmem<T>));  // Ut
  T* Vo = Uo + kR;  // M at the own columns
  T* GR = Vo + kR;  // G[I, own] - E
  T* gbs = GR + kR;  // n, by visit
  T* uss = gbs + n;  // n, by visit
  T* dls = uss + n;  // n, by visit
  int* ords = reinterpret_cast<int*>(dls + n);
  int* accs = ords + n;  // n, by visit

  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int w = blockIdx.y;
  T* Gw = a.G + (long long)w * n * n;
  const int* order = a.order + w * a.s_order;
  const T* gb = a.gb + w * a.s_stream;
  const T* delta = a.delta + w * a.s_stream;
  const T* us = a.us + w * a.s_stream;
  for (int e = tid; e < n; e += nthreads) ords[e] = order[e];
  __syncthreads();
  for (int e = tid; e < n; e += nthreads) {
    const int at = a.per_visit ? e : ords[e];
    gbs[e] = gb[at];
    dls[e] = delta[at];
    uss[e] = us[e];
  }

  for (int g0 = 0; g0 < n; g0 += k) {
    const int cnt = min(k, n - g0);
    const int* I = ords + g0;
    __syncthreads();
    sub_gather(sm, Gw, n, I, cnt, tid, nthreads);
    __syncthreads();
    if (tid < 32) {
      sub_decide_warp(sm, cnt, gbs + g0, dls + g0, uss + g0, accs + g0, tid);
      if (nthreads == 32)
        sub_panels(Gw, n, I, cnt, a0, own, Uo, Rp, GR, Rp, tid, 32);
    } else {
      sub_panels(Gw, n, I, cnt, a0, own, Uo, Rp, GR, Rp, tid - 32,
                 nthreads - 32);
    }
    __syncthreads();
    sub_m(sm, GR, Rp, Vo, Rp, cnt, own, tid, nthreads);
    // every CTA's M complete, and no CTA reads the group-base G any more
    cluster.sync();
    flush_by_column<T, SUB_RMAX>(cluster, Gw + (long long)a0 * n, Uo, Vo, 0,
                                 n, R, Rp, own, cnt);
    // G's writes before the next group's loads; M free again
    cluster.sync();
  }
  if (c == 0) {
    T* flags = a.flags + w * a.s_flags;
    for (int e = tid; e < n; e += nthreads) {
      if (a.per_visit)
        flags[e] = accs[e] ? T(1) : T(0);
      else if (accs[e])
        flags[ords[e]] = T(1);
    }
  }
}

}  // namespace dqmc
