// The k sequential decisions of one submatrix block, run by one warp.
//
// Shared by the per-slice submatrix update (#5, submatrix_update.cu: one
// warp per walker per launch) and the fused block's submatrix site loop
// (#2c, fused_block.cu: warp 0 of the walker's CTA, between the flushes).
//
// With I the block's candidate sites and P its accepted subset, candidate
// t's ratio is the bordering Schur complement of M = D_P^{-1} + (I - G)[P, P]
// through W = M^{-1}, kept in a fixed k x k buffer masked to the accepted
// slots:  r = 1 + delta (1 - G_tt) - delta * b W c,  b = -G[t, P],
// c = -G[P, t];  accept on u < gb r^2 (>= 0: one stored flavor, det^2).  An
// accepted candidate borders W; a rejected one leaves its row and column
// exactly zero, so the composite flush G += G[:, I] W (G[I, :] - E_I) has
// the rank of the acceptances.
//
// Everything lives in one DecideSmem (about 9 KB in f32, 18 KB in f64);
// lane p owns row p of W.

#pragma once

#include <cuda_runtime.h>

namespace dqmc {

constexpr int DECIDE_KMAX = 32;

template <typename T>
struct DecideSmem {
  T GII[DECIDE_KMAX][DECIDE_KMAX + 1];  // G[I, I] of the block-base G
  T Wm[DECIDE_KMAX][DECIDE_KMAX + 1];   // W, zero outside accepted slots
  T bs[DECIDE_KMAX], cs[DECIDE_KMAX], Wc_s[DECIDE_KMAX], bW_s[DECIDE_KMAX];
  T msk[DECIDE_KMAX];                   // 1 on accepted slots
  int I[DECIDE_KMAX];                   // the block's sites
};

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Called by all 32 lanes of one warp.  G is the walker's (n, n) matrix and
// order its visit order; the block is visits v0..v0+cnt-1.  us is indexed
// by visit; gb and delta by visit, or by site when by_site (the fused
// block's site-major factors); out (the accept flag, 0 or 1) likewise.
// Leaves sm.I and sm.Wm[:cnt][:cnt] for the caller's flush.
template <typename T>
__device__ void submatrix_decide_warp(DecideSmem<T>& sm,
                                      const T* __restrict__ G, int n,
                                      const int* __restrict__ order, int v0,
                                      int cnt, const T* __restrict__ gb,
                                      const T* __restrict__ delta,
                                      const T* __restrict__ us,
                                      T* __restrict__ out, bool by_site,
                                      int lane) {
  if (lane < cnt) sm.I[lane] = order[v0 + lane];
  sm.msk[lane] = T(0);
  for (int e = lane; e < DECIDE_KMAX * DECIDE_KMAX; e += 32)
    sm.Wm[e / DECIDE_KMAX][e % DECIDE_KMAX] = T(0);
  __syncwarp();
  for (int e = lane; e < cnt * cnt; e += 32) {
    const int p = e / cnt, q = e % cnt;
    sm.GII[p][q] = G[(long long)sm.I[p] * n + sm.I[q]];
  }
  __syncwarp();

  const bool act = lane < cnt;
  for (int t = 0; t < cnt; ++t) {
    const int at = by_site ? sm.I[t] : v0 + t;
    // b = -G[t, P], c = -G[P, t] (masked to the accepted slots)
    sm.bs[lane] = act ? -sm.GII[t][lane] * sm.msk[lane] : T(0);
    sm.cs[lane] = act ? -sm.GII[lane][t] * sm.msk[lane] : T(0);
    __syncwarp();
    T Wc = T(0), bW = T(0);
    if (act) {
      for (int q = 0; q < cnt; ++q) Wc += sm.Wm[lane][q] * sm.cs[q];
      for (int p = 0; p < cnt; ++p) bW += sm.bs[p] * sm.Wm[p][lane];
    }
    const T bWc = warp_sum(sm.bs[lane] * Wc);  // the same bits in every lane
    const T d = delta[at];
    const T rf = T(1) + d * (T(1) - sm.GII[t][t]) - d * bWc;
    const bool accept = us[v0 + t] < gb[at] * rf * rf;  // >= 0
    if (accept) {
      const T inv_s = d / rf;
      sm.Wc_s[lane] = Wc;
      sm.bW_s[lane] = bW;
      __syncwarp();
      if (act)
        for (int q = 0; q < cnt; ++q)
          sm.Wm[lane][q] += inv_s * Wc * sm.bW_s[q];
      __syncwarp();
      if (act) {
        sm.Wm[t][lane] = -inv_s * bW;
        sm.Wm[lane][t] = -inv_s * Wc;
      }
      __syncwarp();
      if (lane == 0) {
        sm.Wm[t][t] = inv_s;
        sm.msk[t] = T(1);
      }
    }
    if (lane == 0) out[at] = accept ? T(1) : T(0);
    __syncwarp();
  }
}

}  // namespace dqmc
