// Triple-float32 arithmetic and the exact f64 bit assembly, one device
// function for each torch function of ozimmu_tpu_torch/ops/tf32x3.py and
// ozimmu_tpu_torch/ops/pack.py, so that a kernel built on them gives the
// plain PyTorch version's bits: step for step, or (the last section) by
// fewer instructions that give the same bits on the inputs they admit.
//
// What keeps the bits equal:
//   * every f32 step is a round-to-nearest intrinsic (__fadd_rn, __fsub_rn,
//     __fmul_rn), and the library is built with --fmad=false: a fused
//     multiply-add would break TwoSum and TwoProd, and torch's eager
//     kernels never contract;
//   * f32 subnormals are kept (no -ftz): torch does not flush them;
//   * torch's floor division `e // 2` is an arithmetic shift right;
//   * torch's int64 `<<` wraps on negative values, so every left shift of
//     a signed value goes through uint64_t; `>>` is arithmetic on int64_t,
//     as torch's, and _rne_shift's logical shift masks off the sign fill,
//     as the torch version does;
//   * every clamp of a shift count is the torch version's;
//   * a fused multiply-add appears only as the explicit __fmaf_rn of
//     two_prod_fma, where it is exact.
//
// A triple is (s0, s1, s2) with |s0| >= |s1| >= |s2| after renorm; its
// value, with an int32 exponent E, is (s0 + s1 + s2) * 2^E.

#pragma once

#include <cstdint>

namespace oz {

struct Triple {
  float s0, s1, s2;
};

// ---- ops/tf32x3.py --------------------------------------------------------

// two_sum: s + e == a + b exactly
__device__ __forceinline__ void two_sum(float a, float b, float& s, float& e) {
  s = __fadd_rn(a, b);
  const float bb = __fsub_rn(s, a);
  e = __fadd_rn(__fsub_rn(a, __fsub_rn(s, bb)), __fsub_rn(b, bb));
}

// quick_two_sum: |a| >= |b|
__device__ __forceinline__ void quick_two_sum(float a, float b, float& s, float& e) {
  s = __fadd_rn(a, b);
  e = __fsub_rn(b, __fsub_rn(s, a));
}

// f32_split: Dekker's split by 4097 = 2^12 + 1
__device__ __forceinline__ void f32_split(float a, float& hi, float& lo) {
  const float c = __fmul_rn(4097.0f, a);
  hi = __fsub_rn(c, __fsub_rn(c, a));
  lo = __fsub_rn(a, hi);
}

// two_prod: p + e == a * b exactly, without an FMA
__device__ __forceinline__ void two_prod(float a, float b, float& p, float& e) {
  p = __fmul_rn(a, b);
  float ah, al, bh, bl;
  f32_split(a, ah, al);
  f32_split(b, bh, bl);
  e = __fadd_rn(__fadd_rn(__fadd_rn(__fsub_rn(__fmul_rn(ah, bh), p), __fmul_rn(ah, bl)),
                          __fmul_rn(al, bh)),
                __fmul_rn(al, bl));
}

__device__ __forceinline__ Triple renorm(Triple t) {
  float s, e2, s0, e1, s1, s2;
  quick_two_sum(t.s1, t.s2, s, e2);
  quick_two_sum(t.s0, s, s0, e1);
  quick_two_sum(e1, e2, s1, s2);
  quick_two_sum(s0, s1, s0, s1);
  return {s0, s1, s2};
}

__device__ __forceinline__ Triple add_term(Triple acc, float x) {
  float s0, e0, s1, e1;
  two_sum(acc.s0, x, s0, e0);
  two_sum(acc.s1, e0, s1, e1);
  return {s0, s1, __fadd_rn(acc.s2, e1)};
}

// add: triple + triple
__device__ __forceinline__ Triple add(Triple x, Triple y) {
  Triple a = add_term(x, y.s0);
  a = add_term(a, y.s1);
  a = add_term(a, y.s2);
  return renorm(a);
}

// two_prod_fma: the same (p, e) with an explicit fused multiply-add (which
// --fmad=false leaves alone: it forbids only contraction); e is the
// rounded product error, equal to Dekker's wherever both are exact
// (mul_fma_exact)
__device__ __forceinline__ void two_prod_fma(float a, float b, float& p, float& e) {
  p = __fmul_rn(a, b);
  e = __fmaf_rn(a, b, -p);
}

// mul: triple * triple, the O(eps^2) cross terms kept; FMA picks the
// TwoProd route
template <bool FMA>
__device__ __forceinline__ Triple mul_t(Triple x, Triple y) {
  float p00, e00, p01, e01, p10, e10;
  if (FMA) {
    two_prod_fma(x.s0, y.s0, p00, e00);
    two_prod_fma(x.s0, y.s1, p01, e01);
    two_prod_fma(x.s1, y.s0, p10, e10);
  } else {
    two_prod(x.s0, y.s0, p00, e00);
    two_prod(x.s0, y.s1, p01, e01);
    two_prod(x.s1, y.s0, p10, e10);
  }
  // x1*y1 + (x0*y2 + x2*y0) + (e01 + e10)
  const float t2 = __fadd_rn(
      __fadd_rn(__fmul_rn(x.s1, y.s1), __fadd_rn(__fmul_rn(x.s0, y.s2), __fmul_rn(x.s2, y.s0))),
      __fadd_rn(e01, e10));
  Triple acc = {p00, e00, 0.0f};
  acc = add_term(acc, p01);
  acc = add_term(acc, p10);
  acc = add_term(acc, t2);
  return renorm(acc);
}

__device__ __forceinline__ Triple mul(Triple x, Triple y) { return mul_t<false>(x, y); }

// pow2_f32: 2^e from its exponent bits, e in [-126, 127]
__device__ __forceinline__ float pow2_f32(int32_t e) { return __int_as_float((e + 127) << 23); }

// scale_pow2: (x * 2^h1) * 2^h2, h1 = floor(e / 2); what still over- or
// underflows saturates, which aligned_add relies on
__device__ __forceinline__ Triple scale_pow2(Triple x, int32_t e) {
  const int32_t h1 = min(max(e >> 1, -126), 127);
  const int32_t h2 = min(max(e - h1, -126), 127);
  const float s1 = pow2_f32(h1), s2 = pow2_f32(h2);
  return {__fmul_rn(__fmul_rn(x.s0, s1), s2), __fmul_rn(__fmul_rn(x.s1, s1), s2),
          __fmul_rn(__fmul_rn(x.s2, s1), s2)};
}

// ---- ops/pack.py ----------------------------------------------------------

// _f32_fields: sign (+1 / -1), exponent field, significand with the
// implicit bit where the field is above 0
__device__ __forceinline__ void f32_fields(float x, int32_t& sgn, int32_t& ef, int32_t& m) {
  const int32_t bits = __float_as_int(x);
  sgn = bits < 0 ? -1 : 1;
  ef = (bits >> 23) & 0xFF;
  m = (bits & 0x7FFFFF) | (ef > 0 ? (1 << 23) : 0);
}

__device__ __forceinline__ int64_t shl(int64_t v, int64_t s) {
  return (int64_t)((uint64_t)v << s);
}

// _rto_shift: arithmetic shift right by s in [0, 62], round to odd
__device__ __forceinline__ int64_t rto_shift(int64_t v, int64_t s) {
  const int64_t c = v >> s;
  return shl(c, s) != v ? (c | 1) : c;
}

// _rne_shift: round(q / 2^s), ties to even, s in [2, 62]
__device__ __forceinline__ int64_t rne_shift(int64_t q, int64_t s) {
  const int64_t rem = q & (shl(1, s) - 1);
  const int64_t half = shl(1, s - 1);
  const int64_t base = (q >> s) & (shl(1, 64 - s) - 1);  // logical shift
  const bool up = rem > half || (rem == half && (base & 1) == 1);
  return base + (up ? 1 : 0);
}

__device__ __forceinline__ int32_t clamp32(int32_t v, int32_t lo, int32_t hi) {
  return min(max(v, lo), hi);
}

// pack_renormed: ops/pack.py::pack_f64 after its renorm, in int64 (round
// to odd, then one round to nearest even)
__device__ __forceinline__ int64_t pack_renormed(Triple t, int32_t E) {
  int32_t s0, ef0, m0, s1, ef1, m1, s2, ef2, m2;
  f32_fields(t.s0, s0, ef0, m0);
  f32_fields(t.s1, s1, ef1, m1);
  f32_fields(t.s2, s2, ef2, m2);
  const bool is_zero = ef0 == 0;
  const bool neg = s0 < 0;
  // a tail's significand, signed relative to the head
  const int64_t r1 = (s1 * s0) < 0 ? -shl(m1, 32) : shl(m1, 32);
  const int64_t r2 = (s2 * s0) < 0 ? -shl(m2, 32) : shl(m2, 32);
  const int32_t e1 = max(ef1, 1), e2 = max(ef2, 1);
  const bool swap = e2 > e1;
  const int32_t ef_a = swap ? e2 : e1, ef_b = swap ? e1 : e2;
  const int64_t sc_a = swap ? r2 : r1, sc_b = swap ? r1 : r2;
  const int64_t d = clamp32(ef_a - ef_b, 0, 62);
  const int64_t gap = clamp32(ef0 - ef_a, 0, 62);
  const int64_t s12 = sc_a + rto_shift(sc_b, d);
  const int64_t q = shl(m0, 32) + rto_shift(s12, gap);
  const int32_t need_down = q < (1LL << 55) ? 1 : 0;
  const int32_t e0 = (ef0 - 127) - need_down;
  const int32_t Ef = e0 + E + 1023;
  const bool is_inf = Ef >= 2047;
  const int32_t Ef_c = clamp32(Ef, -1, 2046);
  const int64_t r = clamp32(1 - Ef, 0, 62);
  const int64_t s_eff = 3 - need_down;
  const int64_t st = min(max(s_eff + r, (int64_t)2), (int64_t)62);
  const int64_t q_final = rne_shift(q, st);
  const bool is_sub = Ef <= 0;
  const int64_t bits_normal = shl(Ef_c, 52) + (q_final - (1LL << 52));
  int64_t bits = is_sub ? q_final : bits_normal;
  if (is_inf) bits = 2047LL << 52;
  if (is_zero) bits = 0;
  if (neg) bits = (int64_t)((uint64_t)bits | (1ULL << 63));
  return bits;
}


// aligned_add: (x * 2^xE) + (y * 2^yE) as (triple, exponent), both scaled
// to the larger exponent
__device__ __forceinline__ Triple aligned_add(Triple x, int32_t xE, Triple y, int32_t yE,
                                              int32_t& E) {
  E = max(xE, yE);
  const int32_t dx = clamp32(xE - E, -300, 0);
  const int32_t dy = clamp32(yE - E, -300, 0);
  return add(scale_pow2(x, dx), scale_pow2(y, dy));
}

// ---- the epilogue's instruction-saving routes ------------------------------
//
// Each gives the bits of the torch function it mirrors.  Those with a guard
// take the plain route above for what the guard does not admit, kept out
// of line so that it costs the common case nothing but a branch.  tests/
// test_torch_epilogue_design.py models each in numpy and holds it against
// ops/tf32x3.py and ops/pack.py over the admitted domain and at its edges.

// mul_fma_exact: whether mul(x, y) may take two_prod_fma.  Dekker's TwoProd
// and the FMA's are both exact, hence equal, where the two factors are
// normal f32 whose exponents sum to at least -103 (the product's error has
// an f32 quantum) and nothing overflows; a zero factor gives +0 either way.
// floor0 and floor1 are the least |x0| and |x1| that keep each product of
// mul 3 binades above that edge for the scalar y it multiplies by
// (ops/epilogue_cuda.py::fma_floors); |x| < 2^100 keeps Dekker's split
// 4097 * x finite.  S of recombine is zero or at least 2^-62 (its lowest
// group weight) and c's unpacked components are integers, so the integer
// scalars (-1, 2, the fold's +-1) admit every such input; a scalar with
// a tail (y1 != 0, |y1| >= 2^-52) sends a head below 2^-48 to Dekker.
__device__ __forceinline__ bool mul_fma_exact(const Triple& x, float floor0, float floor1) {
  const float a0 = fabsf(x.s0), a1 = fabsf(x.s1);
  return (a0 == 0.0f || (a0 >= floor0 && a0 < 0x1p100f)) &&
         (a1 == 0.0f || (a1 >= floor1 && a1 < 0x1p100f));
}

__device__ __noinline__ Triple mul_dekker(Triple x, Triple y) { return mul(x, y); }

// mul_scalar: mul(x, y) for a scalar triple y of tf32x3.from_f64_host
__device__ __forceinline__ Triple mul_scalar(Triple x, Triple y, float floor0, float floor1) {
  return mul_fma_exact(x, floor0, floor1) ? mul_t<true>(x, y) : mul_dekker(x, y);
}

// f32_scaled_int: the f32 value m * 2^s of an integer m < 2^23 without a
// conversion instruction: (2^(s+23) + m * 2^s) - 2^(s+23), both steps
// exact; +0 for m == 0
template <int S>
__device__ __forceinline__ float f32_scaled_int(uint32_t m) {
  constexpr uint32_t magic = (uint32_t)(127 + 23 + S) << 23;
  return __fsub_rn(__uint_as_float(magic | m), __uint_as_float(magic));
}

// unpack_f64: value(c) == (t0 + t1 + t2) * 2^E, every component exact
// (ops/pack.py::unpack_f64), from the two 32-bit halves of c, the
// components built from their bits without a conversion instruction (t *
// sgn of the torch version is the sign bit or'ed in, -0.0 included)
__device__ __forceinline__ Triple unpack_f64(double c, int32_t& E) {
  const uint32_t hi = (uint32_t)__double2hiint(c), lo = (uint32_t)__double2loint(c);
  const int32_t field = (int32_t)((hi >> 20) & 0x7FF);
  const uint32_t m_hi = (hi & 0xFFFFF) | (field > 0 ? 0x100000u : 0u);
  const uint32_t sign = hi & 0x80000000u;
  E = (field > 0 ? field : 1) - 1075;
  return {__uint_as_float(__float_as_uint(f32_scaled_int<32>(m_hi)) | sign),
          __uint_as_float(__float_as_uint(f32_scaled_int<16>(lo >> 16)) | sign),
          __uint_as_float(__float_as_uint(f32_scaled_int<0>(lo & 0xFFFF)) | sign)};
}

__device__ __noinline__ int64_t pack_renormed_int(Triple t, int32_t E) {
  return pack_renormed(t, E);
}

// pack_f64: round (t0 + t1 + t2) * 2^E to the nearest f64, ties to even,
// and return its bits (ops/pack.py::pack_f64); through the card's FP64
// units where the result is a normal f64 or an overflow.  After renorm,
// h + l == t0 + t1 exactly (Fast2Sum, |t0| >= |t1|); l + t2 rounded to odd
// (TwoSum's error says whether it was exact, __dadd_rz and a set lowest bit
// if not) keeps a sticky bit far below h's last place, so one
// round-to-nearest-even add gives the correctly rounded sum s
// (Boldo-Melquiond).  Both steps need tails well below the head, which
// renorm gives any ordered triple: |t1|, |t2| <= 2^-20 |t0|.  The scaling
// s * 2^E keeps that rounding only where the product is normal, which is
// decided before it: |s| >= 2^(-1022 - E).  (An exact sum just below that
// power of two that s rounds up to it lies within 2^-1076 of 2^-1022 once
// scaled, so 2^-1022 is its rounding on the subnormal grid too.)  Below
// it the result is an f64 subnormal, which rounds at another place than s
// did (rounding twice): the integer route takes it.
// A head that is zero or an f32 subnormal packs to a signed zero, as in
// pack_renormed; a head of inf or NaN, tails that are not small and E
// outside [-1022, 1023] take the integer route too.
__device__ __forceinline__ int64_t pack_f64(Triple t, int32_t E) {
  t = renorm(t);
  const uint32_t b0 = __float_as_uint(t.s0);
  const uint32_t ef0 = (b0 >> 23) & 0xFF;
  if (ef0 == 0) return (int64_t)((uint64_t)(b0 & 0x80000000u) << 32);
  const float tail = __fmul_rn(0x1p-20f, fabsf(t.s0));
  if (ef0 != 0xFF && fabsf(t.s1) <= tail && fabsf(t.s2) <= tail && E >= -1022 && E <= 1023) {
    const double d0 = t.s0, d1 = t.s1, d2 = t.s2;
    const double h = __dadd_rn(d0, d1);
    const double l = __dsub_rn(d1, __dsub_rn(h, d0));
    const double m = __dadd_rn(l, d2);
    const double z = __dsub_rn(m, l);
    const double err = __dadd_rn(__dsub_rn(l, __dsub_rn(m, z)), __dsub_rn(d2, z));
    const double odd =
        err == 0.0 ? m : __longlong_as_double(__double_as_longlong(__dadd_rz(l, d2)) | 1);
    const double sum = __dadd_rn(h, odd);
    // 2^(-1022 - E), or 2^-1022 for E > 0 (which any normal f32 head passes)
    const double least = __longlong_as_double((int64_t)max(1 - E, 1) << 52);
    if (fabs(sum) >= least)
      return __double_as_longlong(__dmul_rn(sum, __longlong_as_double((int64_t)(E + 1023) << 52)));
  }
  return pack_renormed_int(t, E);
}

}  // namespace oz
