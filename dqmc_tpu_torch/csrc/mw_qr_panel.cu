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
// in multiword arithmetic); digit products are summed in int32 (exact in
// any order for n <= 512: plane 0 x plane 0 is at most 2^23) and the class
// sums recombine with power-of-two weights in multiword arithmetic, in the
// TPU kernel's order: E over the y planes first, then c over the q planes,
// each from high weight to low; the update's class sums only for weights
// w < NP.  R comes from the process coefficients of both passes and the
// norm, emitted compact (32 x 32, row t = column t's coefficients).  The
// TPU kernel's lane-expanded rows, roll trees and 8/16-row bf16 alignment
// were Mosaic layout devices and are gone.  With the same order the kernel
// matches its plain twin (ops/df_qr_kernel.py::panel_plain) bit for bit.
//
// Contraction: every error-free transformation is written with __fadd_rn /
// __fmul_rn / __fdiv_rn / __fsqrt_rn, and the source is compiled with
// --fmad=false (dqmc_tpu_torch/_cuda.py), so no multiply-add is fused.
//
// What bounds it on an H100: the column loop is a chain of dependent
// block-wide steps, so a panel is latency-bound; one CTA of 256 threads per
// panel (a batch of B panels occupies B of the 132 SMs).  The design keeps
// each step short:
// - the two integer contractions per pass run on the int8 tensor cores
//   (mma.sync m16n8k32 s8 -> s32, exact): the E dots [y planes + y's carry
//   row] x [the finished q planes + their carry plane] over the n lanes,
//   one plane of q per warp (tf32's three extra planes on warps 0-2); and
//   the update as one product whose A operand is the Toeplitz arrangement
//   of e's planes (row w, K-step j: plane w - j), so the tensor cores
//   return the class sums sum_{i+j=w} directly;
// - the finished q planes live in shared memory once, u innermost
//   (32 bytes per plane and lane): the update's B fragments are single
//   8-byte loads, the E dots' are 4 x 4 byte transposes (prmt) of four
//   conflict-free word loads; both contractions permute K consistently in
//   A and B (a sum in any order), so y's planes are stored permuted to
//   match; no branch inside either product (unfinished columns' planes are
//   zero, a tile past n repeats one that exists and is not kept);
// - the first digit of a vector scaled into [-1, 1) reaches 128: y's and
//   q's planes store it saturated at 127 beside a 0/1 carry row (y) or
//   carry plane (q), and the carries fold in afterwards in int32; e's
//   saturated digit is completed by a sparse int32 pass over the lanes u
//   whose digit is 128 (a warp ballot, usually empty);
// - y stays in registers (at most two lanes per thread) and the next
//   column's P row is loaded a column ahead; the lanes of the update's mma
//   tiles are the threads that own them, so the class sums pass from the
//   tensor cores to the recombination within the warp;
// - c, e and e's digits run on one warp's lanes (one u each), repeated in
//   every warp, which saves the block barrier in front of the update;
// - the norm's digit products are per-lane integer products; warp maxima
//   and sums are one redux instruction each, and the block max takes one
//   barrier (double-buffered).
// 11 block barriers per column (the parent kernel had 25).  No multiword
// chain is shortened: they keep the parent's order, which is the bit
// contract (scripts/seed_split.py panels --parts bits); they are most of
// what is left (scripts/seed_split.py panels --parts probe: ~16k cycles
// per column for df32 at n = 256, ~28k for tf32).  Shared memory:
// 32 (NP + 1) n bytes of q planes (180 KB for tf32 at n = 512) plus
// ~36 KB of y planes, integer products and multiword E.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int PANEL = 32;
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_N = 512;
// lanes of y per thread: lane k lives in n-tile T = k / 8 of warp T % 8
constexpr int MAX_E = MAX_N / THREADS;

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


// ---------------------------------------------------------------------------
// int8 tensor-core pieces
// ---------------------------------------------------------------------------

// d += a b: A 16 x 32 (row), B 32 x 8 (col), int8 -> int32, exact.  Lane
// (g, q) = (lane / 4, lane % 4) holds a0 = A[g][4q..4q+3], a1 = A[g+8][..],
// a2 = A[g][16+4q..], a3 = A[g+8][16+4q..]; b0 = B[4q..4q+3][g],
// b1 = B[16+4q..][g]; d = D[g][2q], D[g][2q+1], D[g+8][2q], D[g+8][2q+1].
__device__ __forceinline__ void mma_s8(int (&d)[4], uint32_t a0, uint32_t a1,
                                       uint32_t a2, uint32_t a3, uint32_t b0,
                                       uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// 4 x 4 byte transpose: byte r of o[s] = byte s of w[r]
__device__ __forceinline__ void transpose4(const uint32_t (&w)[4],
                                           uint32_t (&o)[4]) {
  const uint32_t t0 = __byte_perm(w[0], w[1], 0x5140);
  const uint32_t t1 = __byte_perm(w[2], w[3], 0x5140);
  const uint32_t t2 = __byte_perm(w[0], w[1], 0x7362);
  const uint32_t t3 = __byte_perm(w[2], w[3], 0x7362);
  o[0] = __byte_perm(t0, t1, 0x5410);
  o[1] = __byte_perm(t0, t1, 0x7632);
  o[2] = __byte_perm(t2, t3, 0x5410);
  o[3] = __byte_perm(t2, t3, 0x7632);
}

// byte of column u in a 32-byte row of q (or e) planes: word g holds the
// columns g, g + 8, g + 16, g + 24, so an 8-column tile of u sits in one
// byte of every word
__device__ __forceinline__ int u_byte(int u) { return 4 * (u & 7) + (u >> 3); }

// byte of lane k in a row of y planes: a 4 x 4 transpose inside each 16
// lanes, so that byte 4q + r of a 16-lane block is lane q + 4r (the E dots'
// order of K)
__device__ __forceinline__ int k_byte(int k) {
  return (k & ~15) | ((k & 3) << 2) | ((k >> 2) & 3);
}

// NP digits d as NP + 1 int8 planes out[0], out[stride], ...: the first
// digit saturated at 127 in plane 0, and in plane NP the carry that
// restores it (1 where it is 128)
template <int NP>
__device__ __forceinline__ void store_planes(const int* d, int8_t* out,
                                             size_t stride) {
  out[0] = (int8_t)min(d[0], 127);
#pragma unroll
  for (int i = 1; i < NP; ++i) out[i * stride] = (int8_t)d[i];
  out[NP * stride] = (int8_t)(d[0] == 128);
}

// max over the warp of v >= 0 (whose bits order as unsigned integers)
__device__ __forceinline__ float warp_max(float v) {
  return __uint_as_float(__reduce_max_sync(0xffffffffu, __float_as_uint(v)));
}

// max over the block of v >= 0, one barrier: red holds two buffers of
// WARPS, used in turn (two calls apart a barrier separates the reads from
// the writes)
__device__ __forceinline__ float block_max(float v, float* red, int& buf) {
  static_assert(WARPS == 8, "two float4 reads of the warps' maxima");
  v = warp_max(v);
  float* r = red + buf * WARPS;
  if ((threadIdx.x & 31) == 0) r[threadIdx.x >> 5] = v;
  __syncthreads();
  const float4 a = reinterpret_cast<const float4*>(r)[0];
  const float4 c = reinterpret_cast<const float4*>(r)[1];
  buf ^= 1;
  return fmaxf(fmaxf(fmaxf(a.x, a.y), fmaxf(a.z, a.w)),
               fmaxf(fmaxf(c.x, c.y), fmaxf(c.z, c.w)));
}

// shared-memory layout (bytes), shared with the host launcher
template <int W, int NP>
struct Layout {
  size_t qt, yp, ei, eh, ew, red, ncls, total;
  __host__ __device__ explicit Layout(int n) {
    constexpr int NQ = NP + 1;
    const size_t ei_dots = sizeof(int) * NQ * NQ * PANEL;
    const size_t ei_cls = sizeof(int) * WARPS * 4 * NP * 8;
    size_t o = 0;
    qt = o; o += (size_t)NQ * n * PANEL;        // int8 q planes [j][k][u]
    yp = o; o += (size_t)16 * (n + 16);         // int8 y planes [i][k]
    ei = o; o += ei_dots > ei_cls ? ei_dots : ei_cls;  // E dots | classes
    eh = o; o += (size_t)WARPS * 32 * PANEL;    // e planes, one per warp
    ew = o; o += sizeof(float) * W * PANEL * NP;  // E[u][j]
    red = o; o += sizeof(float) * 2 * WARPS;
    ncls = o; o += sizeof(int) * WARPS * NP;    // the norm's classes
    total = (o + 15) / 16 * 16;
  }
};

template <int W, int NP>
__global__ void __launch_bounds__(THREADS)
    mw_qr_panel_kernel(const float* __restrict__ P, float* __restrict__ Qo,
                       float* __restrict__ Ro, int batch, int n) {
  using T = typename MW<W>::T;
  constexpr int NQ = NP + 1;  // digit planes and the carry plane
  constexpr int JPW = (NQ + WARPS - 1) / WARPS;  // q planes per warp
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout<W, NP> L(n);
  int8_t* qt = reinterpret_cast<int8_t*>(smem + L.qt);
  int8_t* yp = reinterpret_cast<int8_t*>(smem + L.yp);
  int* ei = reinterpret_cast<int*>(smem + L.ei);
  float* ew = reinterpret_cast<float*>(smem + L.ew);
  float* red = reinterpret_cast<float*>(smem + L.red);
  int* ncls = reinterpret_cast<int*>(smem + L.ncls);

  const int b = blockIdx.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, q4 = lane & 3;
  int8_t* eh = reinterpret_cast<int8_t*>(smem + L.eh) + warp * 32 * PANEL;
  int* cls_slab = ei + warp * 4 * NP * 8;
  const int ys = n + 16;                         // row stride of yp
  const int n_tiles = n / 8;
  const size_t pw = (size_t)batch * PANEL * n;  // word stride of P, Q
  const size_t rw = (size_t)batch * PANEL * PANEL;  // word stride of R
  const size_t ew_w = (size_t)PANEL * NP;

  // unfinished columns keep zero planes and contribute exactly zero; rows
  // NQ.. of yp and rows 0..15 of every e table (planes < 0) stay zero
  for (size_t i = tid; i < (L.ew - L.qt) / 16; i += THREADS)
    reinterpret_cast<int4*>(smem + L.qt)[i] = make_int4(0, 0, 0, 0);
  __syncthreads();

  // the lanes k this thread owns: slot e, n-tile T = warp + 8 (4 e + m),
  // m = lane / 8, k = 8 T + lane % 8
  int kown[MAX_E];
  bool own[MAX_E];
#pragma unroll
  for (int e = 0; e < MAX_E; ++e) {
    kown[e] = 8 * (warp + 8 * (4 * e + (lane >> 3))) + (lane & 7);
    own[e] = kown[e] < n;
  }

  float sq_u = 1.0f;  // lane u: the scale of q_u's planes
  int buf = 0;
  T y[MAX_E], y_next[MAX_E];  // column t, and column t + 1 in flight
#pragma unroll
  for (int e = 0; e < MAX_E; ++e)
    y_next[e] = own[e] ? ld<T>(P, pw, (size_t)b * PANEL * n + kown[e])
                       : from_f32<T>(0.0f);
  for (int t = 0; t < PANEL; ++t) {
    const size_t prow = ((size_t)b * PANEL + t) * n;
#pragma unroll
    for (int e = 0; e < MAX_E; ++e) {
      y[e] = y_next[e];
      if (own[e] && t + 1 < PANEL) y_next[e] = ld<T>(P, pw, prow + n + kown[e]);
    }
    T row = from_f32<T>(0.0f);  // lane u: R[t][u], in every warp

    for (int pass = 0; pass < 2; ++pass) {
      // digit planes of y, stored for the E dots (rows i, carry row NP)
      float m = 0.0f;
#pragma unroll
      for (int e = 0; e < MAX_E; ++e)
        if (own[e]) m = fmaxf(m, fabsf(hi_of(y[e])));
      float s_y, inv_sy;
      pow2_scales(block_max(m, red, buf), s_y, inv_sy);
#pragma unroll
      for (int e = 0; e < MAX_E; ++e)
        if (own[e]) {
          int d[NP];
          digits<NP>(y[e], inv_sy, d);
          store_planes<NP>(d, yp + k_byte(kown[e]), ys);
        }
      __syncthreads();

      // dots[j][i][u] = <y plane i, q_u plane j>: warp w takes the q
      // planes j = w and w + 8 (NQ >= 8, so every warp has one; where there
      // is no second plane, the warp repeats its first and keeps nothing)
      // in one pass over K = the n lanes in steps of 32, N = the four 8-u
      // tiles (an unfinished column's planes are zero); no branch inside
      const int u_tiles = (t + 7) / 8;
      if (t > 0) {
        int acc[JPW][4][4] = {};
        const int8_t* qj[JPW];
#pragma unroll
        for (int jj = 0; jj < JPW; ++jj)
          qj[jj] = qt + (size_t)min(warp + WARPS * jj, NQ - 1) * n * PANEL +
                   q4 * PANEL + 4 * g;
#pragma unroll 2
        for (int kb = 0; kb < n; kb += 32) {
          const int8_t* ya = yp + g * ys + kb + 4 * q4;
          const uint32_t a0 = *reinterpret_cast<const uint32_t*>(ya);
          const uint32_t a1 = *reinterpret_cast<const uint32_t*>(ya + 8 * ys);
          const uint32_t a2 = *reinterpret_cast<const uint32_t*>(ya + 16);
          const uint32_t a3 =
              *reinterpret_cast<const uint32_t*>(ya + 8 * ys + 16);
#pragma unroll
          for (int jj = 0; jj < JPW; ++jj) {
            const int8_t* qk = qj[jj] + (size_t)kb * PANEL;
            uint32_t w0[4], w1[4], b0[4], b1[4];
#pragma unroll
            for (int r = 0; r < 4; ++r) {
              w0[r] = *reinterpret_cast<const uint32_t*>(qk + 4 * r * PANEL);
              w1[r] = *reinterpret_cast<const uint32_t*>(
                  qk + (16 + 4 * r) * PANEL);
            }
            transpose4(w0, b0);
            transpose4(w1, b1);
#pragma unroll
            for (int s = 0; s < 4; ++s)
              mma_s8(acc[jj][s], a0, a1, a2, a3, b0[s], b1[s]);
          }
        }
#pragma unroll
        for (int jj = 0; jj < JPW; ++jj) {
          const int j = warp + WARPS * jj;
          if (j >= NQ) break;
#pragma unroll
          for (int s = 0; s < 4; ++s)
            if (s < u_tiles) {
              int* out = ei + j * NQ * PANEL + 8 * s + 2 * q4;
              if (g < NQ) {
                out[g * PANEL] = acc[jj][s][0];
                out[g * PANEL + 1] = acc[jj][s][1];
              }
              if (g + 8 < NQ) {
                out[(g + 8) * PANEL] = acc[jj][s][2];
                out[(g + 8) * PANEL + 1] = acc[jj][s][3];
              }
            }
        }
      }
      __syncthreads();

      // E[u][j] = sum_i 2^-7(i+1) <y plane i, q_u plane j>, the carries
      // folded in: plane 0 of y is row 0 + row NP, of q plane 0 + plane NP
      for (int pj = tid; pj < t * NP; pj += THREADS) {
        const int j = pj / t, u = pj % t;
        int acc[NP];
#pragma unroll
        for (int i = 0; i < NP; ++i) {
          int v = ei[(j * NQ + i) * PANEL + u];
          if (i == 0) v += ei[(j * NQ + NP) * PANEL + u];
          if (j == 0) {
            v += ei[(NP * NQ + i) * PANEL + u];
            if (i == 0) v += ei[(NP * NQ + NP) * PANEL + u];
          }
          acc[i] = v;
        }
        store(ew, ew_w, j * PANEL + u, wsum<NP, T>(acc, -7));
      }
      __syncthreads();

      // every warp, lane u < t: c_u = sum_j 2^-7(j+1) E[u][j]; the R row
      // takes c s_y s_q, the update e_u = c s_q^2, its digit planes (one
      // scale over the u < t; 1 when t = 0) into the warp's e table
      T ev = from_f32<T>(0.0f);
      if (lane < t) {
        T c = scale(ld<T>(ew, ew_w, lane), pow2f(-7));
#pragma unroll
        for (int j = 1; j < NP; ++j)
          c = add(c, scale(ld<T>(ew, ew_w, j * PANEL + lane),
                           pow2f(-7 * (j + 1))));
        row = add(row, scale(c, fmul(s_y, sq_u)));
        ev = scale(c, fmul(sq_u, sq_u));
      }
      float s_e, inv_se;
      pow2_scales(warp_max(lane < t ? fabsf(hi_of(ev)) : 0.0f), s_e, inv_se);
      int de[NP];
#pragma unroll
      for (int i = 0; i < NP; ++i) de[i] = 0;
      if (lane < t) digits<NP>(ev, inv_se, de);
      {
        int8_t* col = eh + 16 * PANEL + u_byte(lane);
        col[0] = (int8_t)min(de[0], 127);
#pragma unroll
        for (int i = 1; i < NP; ++i) col[i * PANEL] = (int8_t)de[i];
      }
      // the u whose first e digit is 128 (stored as 127)
      const unsigned e_carry = __ballot_sync(0xffffffffu, de[0] == 128);
      __syncwarp();

      // y -= s_e s_y sum_w 2^-14-7w cls[w],
      // cls[w][k] = sum_{i+j=w} sum_{u<t} ehat_i[u] qhat_u plane j[k]:
      // per 8-lane tile one product over K = (plane j, u), A row w of
      // K-step j = e plane w - j (K-step NP: q's carry plane, e plane w)
      const float se_sy = fmul(s_e, s_y);
#pragma unroll
      for (int e = 0; e < MAX_E; ++e) {
        // round e: the warp's tiles warp + 8 (4 e + mt), mt < 4
        if (warp + 32 * e >= n_tiles) break;
        // (a tile past n repeats one that exists; nobody reads it back)
        const int8_t* qb[4];
#pragma unroll
        for (int mt = 0; mt < 4; ++mt)
          qb[mt] = qt +
                   (size_t)(8 * min(warp + 8 * (4 * e + mt), n_tiles - 1) + g) *
                       PANEL +
                   8 * q4;
        int acc[4][4] = {};
#pragma unroll
        for (int j = 0; j < NQ; ++j) {
          const int8_t* ea = eh + (16 + g - (j < NP ? j : 0)) * PANEL + 8 * q4;
          const uint2 lo = *reinterpret_cast<const uint2*>(ea);
          const uint2 hi = *reinterpret_cast<const uint2*>(ea + 8 * PANEL);
#pragma unroll
          for (int mt = 0; mt < 4; ++mt) {
            const uint2 bq = *reinterpret_cast<const uint2*>(
                qb[mt] + (size_t)j * n * PANEL);
            mma_s8(acc[mt], lo.x, hi.x, lo.y, hi.y, bq.x, bq.y);
          }
        }
#pragma unroll
        for (int mt = 0; mt < 4; ++mt) {
          int* sl = cls_slab + mt * NP * 8 + 2 * q4;
          if (g < NP) {
            sl[g * 8] = acc[mt][0];
            sl[g * 8 + 1] = acc[mt][1];
          }
          if (g + 8 < NP) {
            sl[(g + 8) * 8] = acc[mt][2];
            sl[(g + 8) * 8 + 1] = acc[mt][3];
          }
        }
        __syncwarp();
        if (own[e]) {
          const int k = kown[e];
          int cls[NP];
#pragma unroll
          for (int w = 0; w < NP; ++w)
            cls[w] = cls_slab[((lane >> 3) * NP + w) * 8 + (lane & 7)];
          // e's saturated digit: add q_u's digits once more for each u
          // whose first e digit is 128
          for (unsigned mask = e_carry; mask; mask &= mask - 1) {
            const int8_t* qu = qt + (size_t)k * PANEL + u_byte(__ffs(mask) - 1);
#pragma unroll
            for (int w = 0; w < NP; ++w)
              cls[w] += qu[(size_t)w * n * PANEL];
            cls[0] += qu[(size_t)NP * n * PANEL];
          }
          const T delta = wsum<NP, T>(cls, -14);
          y[e] = sub(y[e], scale(delta, se_sy));
        }
        __syncwarp();
      }
    }

    // norm^2 from y's digits: exact class products, per lane in int32,
    // summed over the block
    float m = 0.0f;
#pragma unroll
    for (int e = 0; e < MAX_E; ++e)
      if (own[e]) m = fmaxf(m, fabsf(hi_of(y[e])));
    float s_y, inv_sy;
    pow2_scales(block_max(m, red, buf), s_y, inv_sy);
    int cls[NP];
#pragma unroll
    for (int w = 0; w < NP; ++w) cls[w] = 0;
#pragma unroll
    for (int e = 0; e < MAX_E; ++e)
      if (own[e]) {
        int d[NP];
        digits<NP>(y[e], inv_sy, d);
#pragma unroll
        for (int i = 0; i < NP; ++i)
#pragma unroll
          for (int j = 0; i + j < NP; ++j) cls[i + j] += d[i] * d[j];
      }
#pragma unroll
    for (int w = 0; w < NP; ++w) {
      const int v = __reduce_add_sync(0xffffffffu, cls[w]);
      if (lane == 0) ncls[warp * NP + w] = v;
    }
    __syncthreads();
#pragma unroll
    for (int w = 0; w < NP; ++w) {
      int v = 0;
#pragma unroll
      for (int i = 0; i < WARPS; ++i) v += ncls[i * NP + w];
      cls[w] = v;
    }
    const T nrm2 = wsum<NP, T>(cls, -14);
    const T nrm = sqrt_mw(scale(nrm2, fmul(s_y, s_y)));
    const bool zero = hi_of(nrm) == 0.0f;
    const T inv = div(from_f32<T>(1.0f), zero ? from_f32<T>(1.0f) : nrm);

    // q = y / |y|: Q row t, its digit planes and scale, R row t
    m = 0.0f;
#pragma unroll
    for (int e = 0; e < MAX_E; ++e)
      if (own[e]) {
        T qv = mul(y[e], inv);
        if (zero) qv = from_f32<T>(0.0f);
        y[e] = qv;
        store(Qo, pw, prow + kown[e], qv);
        m = fmaxf(m, fabsf(hi_of(qv)));
      }
    float s_q, inv_sq;
    pow2_scales(block_max(m, red, buf), s_q, inv_sq);
#pragma unroll
    for (int e = 0; e < MAX_E; ++e)
      if (own[e]) {
        int d[NP];
        digits<NP>(y[e], inv_sq, d);
        store_planes<NP>(d, qt + (size_t)kown[e] * PANEL + u_byte(t),
                         (size_t)n * PANEL);
      }
    if (warp == 0)
      store(Ro, rw, ((size_t)b * PANEL + t) * PANEL + lane,
            lane < t ? row : (lane == t ? nrm : from_f32<T>(0.0f)));
    if (lane == t) sq_u = s_q;
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
