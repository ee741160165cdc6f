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
//   rank1_sites_kernel     #6: a whole slice, one CTA per walker; an
//                          accepted visit applies its rank-1 update to G
//                          inside the CTA.
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
// each (C = 1 up to n = 64, 4 at n = 256, 16 at n = 1024; one or two
// warps of each CTA carry the visits), so U and V live in the cluster's
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
// cross-SM handoff each.
// Every sum is an explicit fma() in the order of the first design (visit
// dots in s order on G's entry, r = fma(1 - G_ii, delta, 1) -- rounded
// product first with two flavors, as that kernel's build did -- and the
// flush summed from 0 in s order, then added to G), so G, the flags and
// the sign keep its bits.  A cluster the card cannot place raises;
// nothing falls back.

#include <cuda_runtime.h>

#include "site_loop.cuh"

namespace {

// The fewest CTAs with R <= 64 sites each (C = 1 up to n = 64, 4 at 256, 16
// at 1024), 128 or 256 threads; the flush by owner keeps two pieces of G
// in registers.
template <typename T, int NFL>
__global__ void __launch_bounds__(dqmc::SITE_THREADS, 1)
delayed_slice_kernel(const dqmc::SiteLoopArgs<T> args) {
  dqmc::site_loop_body<T, NFL, 64, NFL == 2>(args);
}

// #6: one walker's slice, rank-1 update per accepted visit.
template <typename T>
__global__ void rank1_sites_kernel(T* G, T* __restrict__ acc,
                                   const int* __restrict__ order,
                                   long long s_order,
                                   const T* __restrict__ gb,
                                   const T* __restrict__ delta,
                                   const T* __restrict__ us, int n) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* col = reinterpret_cast<T*>(smem_raw);  // prefac * G[:, i]
  T* row = col + n;                         // G[i, :] - e_i
  const int w = blockIdx.x, tid = threadIdx.x, nthr = blockDim.x;
  G += (long long)w * n * n;
  order += w * s_order;
  const long long ws = (long long)w * n;
  gb += ws;
  delta += ws;
  us += ws;
  acc += ws;

  for (int idx = 0; idx < n; ++idx) {
    const int i = order[idx];
    const T gii = G[(long long)i * n + i];
    const T d = delta[idx];
    const T rf = T(1) + (T(1) - gii) * d;
    const bool accept = us[idx] < gb[idx] * rf * rf;
    if (tid == 0) acc[idx] = accept ? T(1) : T(0);
    if (!accept) continue;  // the same branch in every thread
    const T prefac = d / rf;
    for (int j = tid; j < n; j += nthr) {
      col[j] = prefac * G[(long long)j * n + i];
      row[j] = G[(long long)i * n + j] - (j == i ? T(1) : T(0));
    }
    __syncthreads();
    for (long long e = tid; e < (long long)n * n; e += nthr) {
      const int a = (int)(e / n), b = (int)(e - (long long)a * n);
      G[e] += col[a] * row[b];
    }
    __syncthreads();
  }
}

template <typename T, int NFL>
int launch_delayed_slice(T* G, T* acc, const int* order, long long s_order,
                         const T* gb, const T* delta, const T* us, T* sgn,
                         int n, int k, int batch, void* stream) {
  if (n <= 0 || n > 1024 || k <= 0 || k > dqmc::SITE_KMAX || batch <= 0 ||
      batch > 65535 || (s_order != 0 && s_order != n) ||
      (NFL == 2 && sgn == nullptr))
    return (int)cudaErrorInvalidValue;
  const dqmc::SiteLoopArgs<T> args{G,  acc, n,   order, s_order, gb, delta,
                                   us, n,   sgn, n,     k,       true};
  static dqmc::SiteLaunchCache cache;
  return dqmc::launch_site_loop<T>(
      delayed_slice_kernel<T, NFL>, cache, args,
      dqmc::site_smem_bytes<T>(n, k, NFL, 64), 64, batch, stream);
}

template <typename T>
int launch_rank1_sites(T* G, T* acc, const int* order, long long s_order,
                       const T* gb, const T* delta, const T* us, int n,
                       int batch, void* stream) {
  // 2 n elements of shared memory: 16 KB in f64 at n = 1024
  if (n <= 0 || n > 1024 || batch <= 0) return (int)cudaErrorInvalidValue;
  const int threads = (n + 31) / 32 * 32;
  const size_t smem = 2 * sizeof(T) * (size_t)n;
  rank1_sites_kernel<T><<<batch, threads, smem, (cudaStream_t)stream>>>(
      G, acc, order, s_order, gb, delta, us, n);
  return (int)cudaGetLastError();
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
// memory of one CTA in bytes at rank k, nfl flavors, itemsize 4 or 8
// (ops/kernels.py delayed_slice_smem mirrors the second for the host).
extern "C" int dqmc_site_cluster(int n, int rmax) {
  return dqmc::site_cluster(n, rmax).C;
}

extern "C" long long dqmc_site_smem_bytes(int n, int k, int nfl,
                                          int itemsize, int rmax) {
  return itemsize == 8 ? dqmc::site_smem_bytes<double>(n, k, nfl, rmax)
                       : dqmc::site_smem_bytes<float>(n, k, nfl, rmax);
}
