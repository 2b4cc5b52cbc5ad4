// Triple-float32 arithmetic and the exact f64 bit assembly, one device
// function for each torch function of ozimmu_tpu_torch/ops/tf32x3.py and
// ozimmu_tpu_torch/ops/pack.py, step for step, so that a kernel built on
// them gives the plain PyTorch version's bits.
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
//   * every clamp of a shift count is the torch version's.
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

// mul: triple * triple, the O(eps^2) cross terms kept
__device__ __forceinline__ Triple mul(Triple x, Triple y) {
  float p00, e00, p01, e01, p10, e10;
  two_prod(x.s0, y.s0, p00, e00);
  two_prod(x.s0, y.s1, p01, e01);
  two_prod(x.s1, y.s0, p10, e10);
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

// unpack_f64: value(c) == (t0 + t1 + t2) * 2^E, every component exact
__device__ __forceinline__ Triple unpack_f64(double c, int32_t& E) {
  const int64_t bits = __double_as_longlong(c);
  const int32_t field = (int32_t)((bits >> 52) & 0x7FF);
  int64_t m53 = bits & ((1LL << 52) - 1);
  if (field > 0) m53 |= 1LL << 52;
  const int64_t m_hi = m53 >> 32;
  const int64_t m_lo = m53 & 0xFFFFFFFFLL;
  const float sgn = bits < 0 ? -1.0f : 1.0f;
  E = (field > 0 ? field : 1) - 1075;
  const float t0 = __fmul_rn((float)m_hi, 4294967296.0f);
  const float t1 = __fmul_rn((float)(m_lo >> 16), 65536.0f);
  const float t2 = (float)(m_lo & 0xFFFF);
  return {__fmul_rn(t0, sgn), __fmul_rn(t1, sgn), __fmul_rn(t2, sgn)};
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

// pack_f64: round (t0 + t1 + t2) * 2^E to the nearest f64, ties to even;
// returns its bits
__device__ __forceinline__ int64_t pack_f64(Triple t, int32_t E) {
  t = renorm(t);
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

}  // namespace oz
