// The engine's exact epilogue and its complex fold, one fused pass over the
// output each.
//
// Replaces plain XLA in the JAX package, where jax.jit fuses the eager
// steps into a few loops over the output (there is no Pallas kernel):
//   * epilogue_kernel: ozimmu_tpu/core/gemm.py:40 _epilogue_SE,
//     alpha * (S * 2^E) + beta * c rounded to f64 once (the reference's
//     axby, src/gemm.cu:124-158);
//   * zfold_kernel: ozimmu_tpu/core/gemm.py:175 _zfold_passes, the four
//     pass results of the 4-pass complex engine and beta * c folded into
//     the real and imaginary planes (the reference's init_c_complex and
//     its fold, src/gemm.cu:199-239, 479-518).
// Each computes, bit for bit, what its plain PyTorch version computes:
// ozimmu_tpu_torch/core/gemm.py::_epilogue_block and ::_zfold_block, some
// 40 (real) to 500 (complex) eager passes over the output.  The arithmetic
// is csrc/tf32x3.cuh, one device function per torch function.
//
// The complex fold runs a plan built on the host
// (ozimmu_tpu_torch/ops/epilogue_cuda.py::zfold_plan): the aligned adds in
// the order _zfold_block makes them, each step naming its source (pass 0-3,
// or the real or imaginary part of c), its target (re or im) and the
// scalar triple and exponent it multiplies by.  The order of the adds sets
// the bits, so the kernel runs the steps exactly in that order.
//
// What bounds them on an H100: the real epilogue reads S (12 B), E (4 B)
// and c (8 B) and writes 8 B per element, a few hundred f32 and int
// operations on them: device memory, about.  The fold reads 4 x 16 B of
// passes and 16 B of c and writes 16 B per element, but runs some 2000
// f32 and int operations on them: instruction issue, about.  The design is
// the simple one: one thread per element in a grid-stride loop over the
// output (64-bit indices, 32-bit divisions where the output allows), S and
// E contiguous [m, n], c read through its row and column strides (the
// solvers pass a window of their matrix), the output written through its
// row stride (a column panel of the output writes in place).

#include <cstdint>
#include <cuda_runtime.h>

#include "tf32x3.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int kMaxSteps = 12;  // 4 beta steps + 2 per pass
constexpr int32_t kEmptyExp = -(1 << 20);  // core/gemm.py::_EMPTY_EXP

struct Scalar {
  float t0, t1, t2;
  int32_t e;
};

// the row and column of flat element i of an [m, n] output
__device__ __forceinline__ void row_col(int64_t i, int64_t n, bool small, int64_t& r,
                                        int64_t& c) {
  if (small) {
    const uint32_t ii = (uint32_t)i, nn = (uint32_t)n;
    r = ii / nn;
    c = ii - (uint32_t)r * nn;
  } else {
    r = i / n;
    c = i - r * n;
  }
}

template <bool ALPHA, bool BETA, bool BETA_SCALE>
__global__ void __launch_bounds__(THREADS)
epilogue_kernel(const float* __restrict__ s0, const float* __restrict__ s1,
                const float* __restrict__ s2, const int32_t* __restrict__ E, int64_t m, int64_t n,
                Scalar alpha, Scalar beta, const double* __restrict__ c, int64_t c_rs,
                int64_t c_cs, double* __restrict__ out, int64_t out_rs) {
  const int64_t total = m * n;
  const bool small = total <= 0xFFFFFFFFLL;
  const int64_t stride = (int64_t)gridDim.x * THREADS;
  for (int64_t i = (int64_t)blockIdx.x * THREADS + threadIdx.x; i < total; i += stride) {
    int64_t r, col;
    row_col(i, n, small, r, col);
    oz::Triple S = {s0[i], s1[i], s2[i]};
    int32_t e = E[i];
    if (ALPHA) {
      S = oz::mul(S, {alpha.t0, alpha.t1, alpha.t2});
      e += alpha.e;
    }
    if (BETA) {
      int32_t cE;
      oz::Triple ct = oz::unpack_f64(c[r * c_rs + col * c_cs], cE);
      if (BETA_SCALE) {
        ct = oz::mul(ct, {beta.t0, beta.t1, beta.t2});
        cE += beta.e;
      }
      S = oz::aligned_add(S, e, ct, cE, e);
    }
    out[r * out_rs + col] = __longlong_as_double(oz::pack_f64(S, e));
  }
}

struct ZfoldArgs {
  const float* s[4][3];  // the passes' triples, [m, n] each
  const int32_t* e[4];   // the passes' exponents
  const double* c[2];    // c's real and imaginary parts, or null
  int64_t c_rs[2], c_cs[2];
  double* out[2];
  int64_t out_rs[2];
  int32_t steps;
  int32_t init_from_c;  // the accumulators start as c (beta == 1), else empty
  int32_t src[kMaxSteps];  // 0-3: a pass; 4, 5: c's real or imaginary part
  int32_t dst[kMaxSteps];  // 0: re, 1: im
  Scalar scale[kMaxSteps];
};

// a source's value at element (i; r, col): a pass's (S, E), c's part
// unpacked, or the empty accumulator where c is absent
__device__ __forceinline__ oz::Triple zsource(const ZfoldArgs& a, int src, int64_t i, int64_t r,
                                              int64_t col, int32_t& E) {
  if (src < 4) {
    E = a.e[src][i];
    return {a.s[src][0][i], a.s[src][1][i], a.s[src][2][i]};
  }
  const int part = src - 4;
  if (a.c[part] == nullptr) {
    E = kEmptyExp;
    return {0.0f, 0.0f, 0.0f};
  }
  return oz::unpack_f64(a.c[part][r * a.c_rs[part] + col * a.c_cs[part]], E);
}

__global__ void __launch_bounds__(THREADS)
zfold_kernel(const __grid_constant__ ZfoldArgs a, int64_t m, int64_t n) {
  const int64_t total = m * n;
  const bool small = total <= 0xFFFFFFFFLL;
  const int64_t stride = (int64_t)gridDim.x * THREADS;
  for (int64_t i = (int64_t)blockIdx.x * THREADS + threadIdx.x; i < total; i += stride) {
    int64_t r, col;
    row_col(i, n, small, r, col);
    oz::Triple re = {0.0f, 0.0f, 0.0f}, im = {0.0f, 0.0f, 0.0f};
    int32_t re_e = kEmptyExp, im_e = kEmptyExp;
    if (a.init_from_c) {
      re = zsource(a, 4, i, r, col, re_e);
      im = zsource(a, 5, i, r, col, im_e);
    }
    int cur = -1;
    oz::Triple v = {0.0f, 0.0f, 0.0f};
    int32_t v_e = 0;
    for (int k = 0; k < a.steps; ++k) {
      if (a.src[k] != cur) {
        cur = a.src[k];
        v = zsource(a, cur, i, r, col, v_e);
      }
      const Scalar f = a.scale[k];
      const oz::Triple p = oz::mul(v, {f.t0, f.t1, f.t2});
      const bool to_im = a.dst[k] != 0;
      int32_t e;
      const oz::Triple sum =
          oz::aligned_add(to_im ? im : re, to_im ? im_e : re_e, p, v_e + f.e, e);
      if (to_im) {
        im = sum;
        im_e = e;
      } else {
        re = sum;
        re_e = e;
      }
    }
    a.out[0][r * a.out_rs[0] + col] = __longlong_as_double(oz::pack_f64(re, re_e));
    a.out[1][r * a.out_rs[1] + col] = __longlong_as_double(oz::pack_f64(im, im_e));
  }
}

template <bool ALPHA, bool BETA, bool BETA_SCALE>
void launch_epilogue(int64_t grid, cudaStream_t s, const float* s0, const float* s1,
                     const float* s2, const int32_t* e, int64_t m, int64_t n, Scalar alpha,
                     Scalar beta, const double* c, int64_t c_rs, int64_t c_cs, double* out,
                     int64_t out_rs) {
  epilogue_kernel<ALPHA, BETA, BETA_SCALE><<<(unsigned)grid, THREADS, 0, s>>>(
      s0, s1, s2, e, m, n, alpha, beta, c, c_rs, c_cs, out, out_rs);
}

}  // namespace

// S: three float32 [m, n] planes and E: int32 [m, n], all contiguous; the
// scalars' triples and exponents (core/gemm.py: scalar_triple); flags: bit
// 0 alpha != 1, bit 1 beta != 0, bit 2 beta != 1; c: float64 at (c_rs,
// c_cs), read only where beta != 0; out: float64 [m, n] at row stride
// out_rs.  Returns the launch's CUDA error code.
extern "C" int oz_epilogue(const void* s0, const void* s1, const void* s2, const void* e,
                           int64_t m, int64_t n, float a0, float a1, float a2, int ae, float b0,
                           float b1, float b2, int be, int flags, const void* c, int64_t c_rs,
                           int64_t c_cs, void* out, int64_t out_rs, int64_t grid, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const Scalar alpha = {a0, a1, a2, ae}, beta = {b0, b1, b2, be};
  const auto f0 = (const float*)s0, f1 = (const float*)s1, f2 = (const float*)s2;
  const auto ep = (const int32_t*)e;
  const auto cp = (const double*)c;
  const auto op = (double*)out;
#define OZ_EPILOGUE(A, B, BS) \
  launch_epilogue<A, B, BS>(grid, s, f0, f1, f2, ep, m, n, alpha, beta, cp, c_rs, c_cs, op, out_rs)
  switch (flags & 7) {
    case 0: case 4: OZ_EPILOGUE(false, false, false); break;
    case 1: case 5: OZ_EPILOGUE(true, false, false); break;
    case 2: OZ_EPILOGUE(false, true, false); break;
    case 3: OZ_EPILOGUE(true, true, false); break;
    case 6: OZ_EPILOGUE(false, true, true); break;
    default: OZ_EPILOGUE(true, true, true); break;
  }
#undef OZ_EPILOGUE
  return (int)cudaGetLastError();
}

// s_planes: 12 pointers, pass p's triple planes at 3p .. 3p + 2; e_planes:
// 4; c_re / c_im nullable, at (c_strides[0], [1]) and ([2], [3]); the
// outputs at row strides re_rs and im_rs; the plan's steps (src, dst,
// triples t[3 * k .. 3 * k + 2], exponents te).
extern "C" int oz_zfold(const void* const* s_planes, const void* const* e_planes, int64_t m,
                        int64_t n, const void* c_re, const void* c_im, const int64_t* c_strides,
                        void* out_re, void* out_im, int64_t re_rs, int64_t im_rs, int steps,
                        int init_from_c, const int* src, const int* dst, const float* t,
                        const int* te, int64_t grid, void* stream) {
  if (steps < 0 || steps > kMaxSteps) return (int)cudaErrorInvalidValue;
  ZfoldArgs a = {};
  for (int p = 0; p < 4; ++p) {
    for (int j = 0; j < 3; ++j) a.s[p][j] = (const float*)s_planes[3 * p + j];
    a.e[p] = (const int32_t*)e_planes[p];
  }
  a.c[0] = (const double*)c_re;
  a.c[1] = (const double*)c_im;
  a.c_rs[0] = c_strides[0];
  a.c_cs[0] = c_strides[1];
  a.c_rs[1] = c_strides[2];
  a.c_cs[1] = c_strides[3];
  a.out[0] = (double*)out_re;
  a.out[1] = (double*)out_im;
  a.out_rs[0] = re_rs;
  a.out_rs[1] = im_rs;
  a.steps = steps;
  a.init_from_c = init_from_c;
  for (int k = 0; k < steps; ++k) {
    a.src[k] = src[k];
    a.dst[k] = dst[k];
    a.scale[k] = {t[3 * k], t[3 * k + 1], t[3 * k + 2], te[k]};
  }
  zfold_kernel<<<(unsigned)grid, THREADS, 0, (cudaStream_t)stream>>>(a, m, n);
  return (int)cudaGetLastError();
}
