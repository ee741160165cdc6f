// #7 / #8: the in-panel column loop of the multiword CGS2 QR.
//
// Replaces: dqmc_tpu/ops/df_qr_kernel.py::_panel_kernel (#7, double-float32:
// two words, 7 digit planes) and dqmc_tpu/ops/tf_qr_kernel.py::_panel_kernel
// (#8, triple-float32: three words, 10 digit planes), the Pallas TPU kernels
// behind df_qr_hybrid / tf_qr_hybrid, which every multiword LDR fold of the
// df32 sampling engine and of the df32/tf32 measurement tier runs.
//
// What it computes, per panel P (32 rows = columns of A, n lanes, W words;
// the panel is already orthogonalized against the earlier panels): two-pass
// classical Gram-Schmidt of its 32 columns in multiword arithmetic.  Every
// dot product is exact: a multiword row vector is scaled by a power of two
// taken from the exponent bits of its max-abs hi word and split into NP
// signed 7-bit digit planes (digit = floor(x w + 0.5), the residual carried
// in multiword arithmetic); digit products are summed in int32 (exact for
// any n here) and the class sums recombine with power-of-two weights in
// multiword arithmetic, in the TPU kernel's order: E over the y planes first,
// then c over the q planes, each from high weight to low; the update's class
// sums only for weights w < NP.  R comes from the process coefficients of
// both passes and the norm, emitted compact (32 x 32, row t = column t's
// coefficients).  The TPU kernel's lane-expanded rows, roll trees and
// 8/16-row bf16 alignment were Mosaic layout devices and are gone.  With the
// same order the kernel matches its plain twin
// (ops/df_qr_kernel.py::panel_plain) bit for bit.
//
// Contraction: every error-free transformation is written with __fadd_rn /
// __fmul_rn / __fdiv_rn / __fsqrt_rn, and the source is compiled with
// --fmad=false (dqmc_tpu_torch/_cuda.py), so no multiply-add is fused.
//
// What bounds it on an H100: the column loop is a chain of dependent
// block-wide steps (digit extraction, exact dots, a multiword recombination
// on a few threads, the update), about a dozen __syncthreads per column, so a
// panel is latency-bound; the int8 digit products (__dp4a) and the float32
// EFT chains are far below any throughput limit.  One CTA per panel keeps the
// finished columns' digit planes in shared memory as int8 (32 (NP + 1) n
// bytes: the first digit of a vector scaled into [-1, 1) reaches 128, so it
// is stored saturated with a carry plane beside it; 64 KB at n = 256 for
// df32, 88 KB for tf32, up to 176 KB at n = 512), the current column in
// shared memory, P and Q in global memory.  A batch of B panels occupies B
// of the 132 SMs.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int PANEL = 32;
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_N = 512;

__device__ __forceinline__ float fadd(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float fsub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float fmul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float fdiv(float a, float b) { return __fdiv_rn(a, b); }

struct F2 { float hi, lo; };
struct F3 { float hi, mi, lo; };

// ---------------------------------------------------------------------------
// error-free transformations (ops/df32.py)
// ---------------------------------------------------------------------------

__device__ __forceinline__ F2 two_sum(float a, float b) {
  const float s = fadd(a, b);
  const float bb = fsub(s, a);
  return {s, fadd(fsub(a, fsub(s, bb)), fsub(b, bb))};
}

__device__ __forceinline__ F2 quick_two_sum(float a, float b) {
  const float s = fadd(a, b);
  return {s, fsub(b, fsub(s, a))};
}

__device__ __forceinline__ F2 split(float a) {
  const float t = fmul(4097.0f, a);
  const float hi = fsub(t, fsub(t, a));
  return {hi, fsub(a, hi)};
}

__device__ __forceinline__ F2 two_prod(float a, float b) {
  const float p = fmul(a, b);
  const F2 sa = split(a), sb = split(b);
  const float e = fadd(fadd(fadd(fsub(fmul(sa.hi, sb.hi), p),
                                 fmul(sa.hi, sb.lo)),
                            fmul(sa.lo, sb.hi)),
                       fmul(sa.lo, sb.lo));
  return {p, e};
}

// ---------------------------------------------------------------------------
// double-float32 (ops/df32.py)
// ---------------------------------------------------------------------------

__device__ __forceinline__ F2 add(F2 x, F2 y) {
  const F2 se = two_sum(x.hi, y.hi);
  const F2 tf = two_sum(x.lo, y.lo);
  const F2 s2 = quick_two_sum(se.hi, fadd(se.lo, tf.hi));
  return quick_two_sum(s2.hi, fadd(s2.lo, tf.lo));
}

__device__ __forceinline__ F2 neg(F2 x) { return {-x.hi, -x.lo}; }
__device__ __forceinline__ F2 sub(F2 x, F2 y) { return add(x, neg(y)); }

__device__ __forceinline__ F2 mul(F2 x, F2 y) {
  const F2 pe = two_prod(x.hi, y.hi);
  return quick_two_sum(
      pe.hi, fadd(pe.lo, fadd(fmul(x.hi, y.lo), fmul(x.lo, y.hi))));
}

__device__ __forceinline__ F2 mul_f32(F2 x, float c) {
  const F2 pe = two_prod(x.hi, c);
  return quick_two_sum(pe.hi, fadd(pe.lo, fmul(x.lo, c)));
}

__device__ __forceinline__ F2 add_f32(F2 x, float c) {
  const F2 se = two_sum(x.hi, c);
  return quick_two_sum(se.hi, fadd(se.lo, x.lo));
}

__device__ F2 div(F2 x, F2 y) {
  const float q1 = fdiv(x.hi, y.hi);
  F2 r = sub(x, mul_f32(y, q1));
  const float q2 = fdiv(r.hi, y.hi);
  r = sub(r, mul_f32(y, q2));
  const float q3 = fdiv(r.hi, y.hi);
  return add_f32(quick_two_sum(q1, q2), q3);
}

__device__ F2 sqrt_mw(F2 x) {
  const float q1 = __fsqrt_rn(x.hi);
  const F2 r = sub(x, two_prod(q1, q1));
  const float safe = q1 == 0.0f ? 1.0f : q1;
  const float q2 = fdiv(r.hi, fmul(2.0f, safe));
  const F2 out = quick_two_sum(q1, q2);
  return q1 == 0.0f ? F2{0.0f, 0.0f} : out;
}

// ---------------------------------------------------------------------------
// triple-float32 (ops/tf32.py)
// ---------------------------------------------------------------------------

__device__ __forceinline__ F3 renorm(float t0, float t1, float t2) {
  const F2 s1 = two_sum(t0, t1);
  const F2 e12 = two_sum(s1.lo, t2);
  const F2 sc = two_sum(s1.hi, e12.hi);
  const F2 ce = two_sum(sc.lo, e12.lo);
  return {sc.hi, ce.hi, ce.lo};
}

__device__ __forceinline__ F3 add(F3 x, F3 y) {
  const F2 s0 = two_sum(x.hi, y.hi);
  const F2 s1 = two_sum(x.mi, y.mi);
  const F2 t1 = two_sum(s0.lo, s1.hi);
  const float t2 = fadd(fadd(s1.lo, t1.lo), fadd(x.lo, y.lo));
  return renorm(s0.hi, t1.hi, t2);
}

__device__ __forceinline__ F3 neg(F3 x) { return {-x.hi, -x.mi, -x.lo}; }
__device__ __forceinline__ F3 sub(F3 x, F3 y) { return add(x, neg(y)); }

__device__ F3 mul(F3 x, F3 y) {
  const F2 pe0 = two_prod(x.hi, y.hi);
  const F2 pe1 = two_prod(x.hi, y.mi);
  const F2 pe2 = two_prod(x.mi, y.hi);
  const float p3 = fadd(fadd(fmul(x.mi, y.mi), fadd(pe1.lo, pe2.lo)),
                        fadd(fmul(x.hi, y.lo), fmul(x.lo, y.hi)));
  const F2 t1 = two_sum(pe1.hi, pe2.hi);
  const F2 t2 = two_sum(pe0.lo, t1.hi);
  return renorm(pe0.hi, t2.hi, fadd(fadd(p3, t1.lo), t2.lo));
}

__device__ __forceinline__ F3 mul_f32(F3 x, float c) {
  const F2 pe0 = two_prod(x.hi, c);
  const F2 pe1 = two_prod(x.mi, c);
  const F2 t1 = two_sum(pe0.lo, pe1.hi);
  return renorm(pe0.hi, t1.hi, fadd(fadd(pe1.lo, t1.lo), fmul(x.lo, c)));
}

__device__ F3 div(F3 x, F3 y) {
  const float q0 = fdiv(x.hi, y.hi);
  F3 r = sub(x, mul_f32(y, q0));
  const float q1 = fdiv(r.hi, y.hi);
  r = sub(r, mul_f32(y, q1));
  const float q2 = fdiv(r.hi, y.hi);
  r = sub(r, mul_f32(y, q2));
  const float q3 = fdiv(r.hi, y.hi);
  return renorm(q0, q1, fadd(q2, q3));
}

__device__ F3 sqrt_mw(F3 x) {
  const float q0 = __fsqrt_rn(x.hi);
  const float safe = q0 == 0.0f ? 1.0f : q0;
  const F2 pe = two_prod(q0, q0);
  F3 r = sub(x, F3{pe.hi, pe.lo, 0.0f});
  const float q1 = fdiv(r.hi, fmul(2.0f, safe));
  const F3 y = renorm(q0, q1, 0.0f);
  r = sub(x, mul(y, y));
  const float q2 = fdiv(r.hi, fmul(2.0f, safe));
  const F3 out = renorm(q0, q1, q2);
  return q0 == 0.0f ? F3{0.0f, 0.0f, 0.0f} : out;
}

// ---------------------------------------------------------------------------
// word-generic helpers
// ---------------------------------------------------------------------------

template <int W> struct MW;
template <> struct MW<2> { using T = F2; };
template <> struct MW<3> { using T = F3; };

__device__ __forceinline__ float hi_of(F2 x) { return x.hi; }
__device__ __forceinline__ float hi_of(F3 x) { return x.hi; }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ F2 from_f32<F2>(float v) {
  return {v, 0.0f};
}
template <> __device__ __forceinline__ F3 from_f32<F3>(float v) {
  return {v, 0.0f, 0.0f};
}

__device__ __forceinline__ F2 scale(F2 x, float c) {
  return {fmul(x.hi, c), fmul(x.lo, c)};
}
__device__ __forceinline__ F3 scale(F3 x, float c) {
  return {fmul(x.hi, c), fmul(x.mi, c), fmul(x.lo, c)};
}

// word w of element i lives at base[w * stride + i]
__device__ __forceinline__ F2 load(const float* base, size_t stride, size_t i,
                                   F2*) {
  return {base[i], base[stride + i]};
}
__device__ __forceinline__ F3 load(const float* base, size_t stride, size_t i,
                                   F3*) {
  return {base[i], base[stride + i], base[2 * stride + i]};
}
__device__ __forceinline__ void store(float* base, size_t stride, size_t i,
                                      F2 v) {
  base[i] = v.hi;
  base[stride + i] = v.lo;
}
__device__ __forceinline__ void store(float* base, size_t stride, size_t i,
                                      F3 v) {
  base[i] = v.hi;
  base[stride + i] = v.mi;
  base[2 * stride + i] = v.lo;
}

template <typename T>
__device__ __forceinline__ T ld(const float* base, size_t stride, size_t i) {
  return load(base, stride, i, static_cast<T*>(nullptr));
}

// 2^e exactly, e in [-126, 127]
__device__ __forceinline__ float pow2f(int e) {
  return __int_as_float((e + 127) << 23);
}

// (s, 1/s): s = 2^(e+1) for m = f 2^e, f in [1, 2), from the exponent bits;
// m = 0 or subnormal maps to (1, 1)
__device__ __forceinline__ void pow2_scales(float m, float& s, float& inv_s) {
  const int e = (__float_as_int(m) >> 23) & 0xFF;
  s = e > 0 ? __int_as_float((e + 1) << 23) : 1.0f;
  inv_s = e > 0 ? __int_as_float((253 - e) << 23) : 1.0f;
}

// the NP digits of x / s: d[0] in [-128, 128] (|x / s| < 1), the others
// in [-64, 64]
template <int NP, typename T>
__device__ __forceinline__ void digits(T x, float inv_s, int* d) {
  T r = scale(x, inv_s);
#pragma unroll
  for (int i = 0; i < NP; ++i) {
    const float q =
        floorf(fadd(fmul(hi_of(r), pow2f(7 * (i + 1))), 0.5f));
    d[i] = __float2int_rn(q);
    r = sub(r, from_f32<T>(fmul(q, pow2f(-7 * (i + 1)))));
  }
}

// NP digits as NP + 1 int8 planes out[0], out[stride], ...: the first digit
// saturated at 127 in plane 0, and in plane NP the carry that restores it
// (1 where it is 128); every dot product adds the carry plane to plane 0
template <int NP>
__device__ __forceinline__ void store_planes(const int* d, int8_t* out,
                                             int stride) {
  out[0] = (int8_t)min(d[0], 127);
#pragma unroll
  for (int i = 1; i < NP; ++i) out[i * stride] = (int8_t)d[i];
  out[NP * stride] = (int8_t)(d[0] == 128);
}

// sum_k terms[k] 2^(w0 - 7k) in multiword arithmetic, high weight first
template <int NP, typename T>
__device__ __forceinline__ T wsum(const int* terms, int w0) {
  T acc = from_f32<T>(fmul(__int2float_rn(terms[0]), pow2f(w0)));
#pragma unroll
  for (int k = 1; k < NP; ++k)
    acc = add(acc, from_f32<T>(fmul(__int2float_rn(terms[k]),
                                    pow2f(w0 - 7 * k))));
  return acc;
}

// max over the block; every thread returns the same value
__device__ float block_max(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float m = red[0];
#pragma unroll
  for (int i = 1; i < WARPS; ++i) m = fmaxf(m, red[i]);
  __syncthreads();
  return m;
}

// pairs (i, j), i <= j, i + j < NP: the distinct products of the norm
template <int NP>
__host__ __device__ constexpr int n_pairs() {
  int c = 0;
  for (int i = 0; i < NP; ++i)
    for (int j = i; i + j < NP; ++j) ++c;
  return c;
}

// shared-memory layout (bytes), shared with the host launcher
template <int W, int NP>
struct Layout {
  size_t qp, yp, y, ew, row, ev, sq, eh, redf, redi, scal, total;
  __host__ __device__ explicit Layout(int n) {
    size_t o = 0;
    qp = o; o += (size_t)PANEL * (NP + 1) * n;   // int8 finished-q planes
    yp = o; o += (size_t)(NP + 1) * n;           // int8 current planes
    o = (o + 15) / 16 * 16;
    y = o; o += sizeof(float) * W * n;           // current column
    ew = o; o += sizeof(float) * W * PANEL * NP;  // E[u][j]
    row = o; o += sizeof(float) * W * PANEL;     // R row accumulator
    ev = o; o += sizeof(float) * W * PANEL;      // e_u = c_u s_q^2
    sq = o; o += sizeof(float) * PANEL;          // scales of the q planes
    redf = o; o += sizeof(float) * WARPS;
    scal = o; o += sizeof(float) * 8;            // nrm, inv, flags
    redi = o; o += sizeof(int) * WARPS * n_pairs<NP>();
    eh = o; o += sizeof(int) * NP * PANEL;       // digits of e
    total = (o + 15) / 16 * 16;
  }
};

template <int W, int NP>
__global__ void __launch_bounds__(THREADS)
    mw_qr_panel_kernel(const float* __restrict__ P, float* __restrict__ Qo,
                       float* __restrict__ Ro, int batch, int n) {
  using T = typename MW<W>::T;
  constexpr int NPAIR = n_pairs<NP>();
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout<W, NP> L(n);
  int8_t* qp = reinterpret_cast<int8_t*>(smem + L.qp);
  int8_t* yp = reinterpret_cast<int8_t*>(smem + L.yp);
  float* y = reinterpret_cast<float*>(smem + L.y);
  float* ew = reinterpret_cast<float*>(smem + L.ew);
  float* row = reinterpret_cast<float*>(smem + L.row);
  float* ev = reinterpret_cast<float*>(smem + L.ev);
  float* sq = reinterpret_cast<float*>(smem + L.sq);
  float* redf = reinterpret_cast<float*>(smem + L.redf);
  float* scal = reinterpret_cast<float*>(smem + L.scal);
  int* redi = reinterpret_cast<int*>(smem + L.redi);
  int* eh = reinterpret_cast<int*>(smem + L.eh);

  const int b = blockIdx.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int n4 = n / 4;
  const size_t pw = (size_t)batch * PANEL * n;       // word stride of P, Q
  const size_t rw = (size_t)batch * PANEL * PANEL;   // word stride of R
  const size_t ew_w = (size_t)PANEL * NP, v_w = PANEL;
  const size_t qstride = (size_t)(NP + 1) * n;       // planes of one q
  const int* yc4 = reinterpret_cast<const int*>(yp + NP * n);

  for (int i = tid; i < PANEL * (NP + 1) * n4; i += THREADS)
    reinterpret_cast<int*>(qp)[i] = 0;
  if (tid < PANEL) sq[tid] = 1.0f;

  for (int t = 0; t < PANEL; ++t) {
    const size_t prow = ((size_t)b * PANEL + t) * n;
    for (int k = tid; k < n; k += THREADS)
      store(y, n, k, ld<T>(P, pw, prow + k));
    if (tid < PANEL) store(row, v_w, tid, from_f32<T>(0.0f));
    __syncthreads();

    for (int pass = 0; pass < 2; ++pass) {
      // digit planes of y
      float m = 0.0f;
      for (int k = tid; k < n; k += THREADS) m = fmaxf(m, fabsf(y[k]));
      float s_y, inv_sy;
      pow2_scales(block_max(m, redf), s_y, inv_sy);
      for (int k = tid; k < n; k += THREADS) {
        int d[NP];
        digits<NP>(ld<T>(y, n, k), inv_sy, d);
        store_planes<NP>(d, yp + k, n);
      }
      __syncthreads();

      // E[u][j] = sum_i 2^-7(i+1) <y plane i, q_u plane j>, u < t; one
      // (u, j) per thread, the k loop rotated to spread shared-memory banks
      for (int pj = tid; pj < t * NP; pj += THREADS) {
        const int u = pj / NP, j = pj % NP;
        const int8_t* qu = qp + u * qstride;
        const int* q4 = reinterpret_cast<const int*>(qu + j * n);
        const int* qc4 = reinterpret_cast<const int*>(qu + NP * n);
        int acc[NP];
#pragma unroll
        for (int i = 0; i < NP; ++i) acc[i] = 0;
        int k4 = pj % n4;
        for (int s = 0; s < n4; ++s) {
          const int qv = q4[k4], yc = yc4[k4];
#pragma unroll
          for (int i = 0; i < NP; ++i)
            acc[i] = __dp4a(reinterpret_cast<const int*>(yp + i * n)[k4], qv,
                            acc[i]);
          acc[0] = __dp4a(yc, qv, acc[0]);
          if (j == 0) {             // the carry of q_u's plane 0
            const int qc = qc4[k4];
#pragma unroll
            for (int i = 0; i < NP; ++i)
              acc[i] = __dp4a(reinterpret_cast<const int*>(yp + i * n)[k4],
                              qc, acc[i]);
            acc[0] = __dp4a(yc, qc, acc[0]);
          }
          k4 = k4 + 1 == n4 ? 0 : k4 + 1;
        }
        store(ew, ew_w, pj, wsum<NP, T>(acc, -7));
      }
      __syncthreads();

      // c_u = sum_j 2^-7(j+1) E[u][j]; the R row takes c s_y s_q, the
      // update e_u = c s_q^2
      if (tid < t) {
        T c = scale(ld<T>(ew, ew_w, tid * NP), pow2f(-7));
#pragma unroll
        for (int j = 1; j < NP; ++j)
          c = add(c, scale(ld<T>(ew, ew_w, tid * NP + j), pow2f(-7 * (j + 1))));
        const float sqv = sq[tid];
        store(row, v_w, tid,
              add(ld<T>(row, v_w, tid), scale(c, fmul(s_y, sqv))));
        store(ev, v_w, tid, scale(c, fmul(sqv, sqv)));
      }
      __syncthreads();

      // digit planes of e (one scale over the u < t; 1 when t = 0)
      if (warp == 0) {
        float v = lane < t ? fabsf(ev[lane]) : 0.0f;
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
          v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
        if (lane == 0) scal[0] = v;
      }
      __syncthreads();
      float s_e, inv_se;
      pow2_scales(scal[0], s_e, inv_se);
      if (tid < t) {
        int d[NP];
        digits<NP>(ld<T>(ev, v_w, tid), inv_se, d);
#pragma unroll
        for (int i = 0; i < NP; ++i) eh[i * PANEL + tid] = d[i];
      }
      __syncthreads();

      // y -= s_e s_y sum_w 2^-14-7w cls[w],
      // cls[w][k] = sum_{i+j=w} sum_{u<t} ehat_i[u] qhat_u plane j[k]
      const float se_sy = fmul(s_e, s_y);
      for (int k = tid; k < n; k += THREADS) {
        int cls[NP];
#pragma unroll
        for (int w = 0; w < NP; ++w) cls[w] = 0;
        for (int u = 0; u < t; ++u) {
          const int8_t* qrow = qp + u * qstride + k;
          int e_[NP];
#pragma unroll
          for (int i = 0; i < NP; ++i) e_[i] = eh[i * PANEL + u];
#pragma unroll
          for (int j = 0; j < NP; ++j) {
            const int qv = qrow[j * n] + (j == 0 ? qrow[NP * n] : 0);
#pragma unroll
            for (int i = 0; i + j < NP; ++i) cls[i + j] += e_[i] * qv;
          }
        }
        const T delta = wsum<NP, T>(cls, -14);
        store(y, n, k, sub(ld<T>(y, n, k), scale(delta, se_sy)));
      }
      __syncthreads();
    }

    // norm^2 from y's digit planes: exact class products
    {
      float m = 0.0f;
      for (int k = tid; k < n; k += THREADS) m = fmaxf(m, fabsf(y[k]));
      float s_y, inv_sy;
      pow2_scales(block_max(m, redf), s_y, inv_sy);
      for (int k = tid; k < n; k += THREADS) {
        int d[NP];
        digits<NP>(ld<T>(y, n, k), inv_sy, d);
        store_planes<NP>(d, yp + k, n);
      }
      __syncthreads();
      int acc[NPAIR];
#pragma unroll
      for (int p = 0; p < NPAIR; ++p) acc[p] = 0;
      for (int k4 = tid; k4 < n4; k4 += THREADS) {
        int v[NP];
#pragma unroll
        for (int i = 0; i < NP; ++i)
          v[i] = reinterpret_cast<const int*>(yp + i * n)[k4];
        const int vc = yc4[k4];
        int p = 0;
#pragma unroll
        for (int i = 0; i < NP; ++i)
#pragma unroll
          for (int j = i; i + j < NP; ++j, ++p) {
            acc[p] = __dp4a(v[i], v[j], acc[p]);
            if (i == 0) {           // plane 0 is v[0] + its carry vc
              acc[p] = __dp4a(vc, v[j], acc[p]);
              if (j == 0) {
                acc[p] = __dp4a(v[0], vc, acc[p]);
                acc[p] = __dp4a(vc, vc, acc[p]);
              }
            }
          }
      }
#pragma unroll
      for (int p = 0; p < NPAIR; ++p) {
        int v = acc[p];
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
        if (lane == 0) redi[warp * NPAIR + p] = v;
      }
      __syncthreads();
      if (tid == 0) {
        int dn[NPAIR];
#pragma unroll
        for (int p = 0; p < NPAIR; ++p) {
          dn[p] = 0;
          for (int w = 0; w < WARPS; ++w) dn[p] += redi[w * NPAIR + p];
        }
        // ordered pairs: the off-diagonal products count twice
        int cls[NP];
#pragma unroll
        for (int w = 0; w < NP; ++w) cls[w] = 0;
        int p = 0;
#pragma unroll
        for (int i = 0; i < NP; ++i)
#pragma unroll
          for (int j = i; i + j < NP; ++j, ++p)
            cls[i + j] += (i == j ? 1 : 2) * dn[p];
        const T nrm2 = wsum<NP, T>(cls, -14);
        const T nrm = sqrt_mw(scale(nrm2, fmul(s_y, s_y)));
        const bool zero = hi_of(nrm) == 0.0f;
        const T inv =
            div(from_f32<T>(1.0f), zero ? from_f32<T>(1.0f) : nrm);
        store(scal, 1, 1, nrm);          // scal[1..W]
        store(scal + W, 1, 1, inv);      // scal[W+1..2W]
        scal[7] = zero ? 1.0f : 0.0f;
      }
      __syncthreads();
    }

    // q = y / |y|: Q row t, its digit planes and scale, R row t
    const T inv = ld<T>(scal + W + 1, 1, 0);
    const bool zero = scal[7] != 0.0f;
    float m = 0.0f;
    for (int k = tid; k < n; k += THREADS) {
      T q = mul(ld<T>(y, n, k), inv);
      if (zero) q = from_f32<T>(0.0f);
      store(y, n, k, q);
      store(Qo, pw, prow + k, q);
      m = fmaxf(m, fabsf(hi_of(q)));
    }
    float s_q, inv_sq;
    pow2_scales(block_max(m, redf), s_q, inv_sq);
    for (int k = tid; k < n; k += THREADS) {
      int d[NP];
      digits<NP>(ld<T>(y, n, k), inv_sq, d);
      store_planes<NP>(d, qp + t * qstride + k, n);
    }
    if (tid < PANEL) {
      const T nrm = ld<T>(scal + 1, 1, 0);
      const T v = tid < t ? ld<T>(row, v_w, tid)
                          : (tid == t ? nrm : from_f32<T>(0.0f));
      store(Ro, rw, ((size_t)b * PANEL + t) * PANEL + tid, v);
    }
    if (tid == 0) sq[t] = s_q;
    __syncthreads();
  }
}

template <int W, int NP>
int launch_panel(const float* P, float* Q, float* R, int batch, int n,
                 void* stream) {
  if (n <= 0 || n % PANEL != 0 || n > MAX_N || batch <= 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem = Layout<W, NP>(n).total;
  cudaError_t err = cudaFuncSetAttribute(
      mw_qr_panel_kernel<W, NP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  mw_qr_panel_kernel<W, NP><<<batch, THREADS, smem, (cudaStream_t)stream>>>(
      P, Q, R, batch, n);
  return (int)cudaGetLastError();
}

}  // namespace

// P, Q: (W, batch, 32, n) float32, words outermost; R: (W, batch, 32, 32)
extern "C" int dqmc_df_qr_panel(const float* P, float* Q, float* R,
                                int batch, int n, void* stream) {
  return launch_panel<2, 7>(P, Q, R, batch, n, stream);
}

extern "C" int dqmc_tf_qr_panel(const float* P, float* Q, float* R,
                                int batch, int n, void* stream) {
  return launch_panel<3, 10>(P, Q, R, batch, n, stream);
}
