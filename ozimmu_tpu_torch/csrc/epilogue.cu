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
// ozimmu_tpu_torch/core/gemm.py::_epilogue_block and ::_zfold_block.  The
// arithmetic is csrc/tf32x3.cuh, one device function per torch function,
// and three routes there that give the same bits with fewer instructions
// (TwoProd by FMA, unpack from the halves' bits, pack through FP64), each
// behind a guard that sends what it does not admit to the plain route.
//
// What bounds them on an H100: the real epilogue reads S (12 B) and c
// (8 B) and writes 8 B per element; the fold reads four passes' S (48 B)
// and c (16 B) and writes 16 B.  A few hundred instructions per element of
// the epilogue, over a thousand per element of the fold, make instruction
// issue the rival bound.  The design answers both:
//   * no exponent plane: the exponent of element (r, col) is formed here,
//     pa[r] + pb[col] - shift in int32, as core/gemm.py::_exponent_plane
//     forms it (the E-plane route remains, a template argument, for the
//     sgemm demotion's unpacked result, which has no row and column parts);
//   * a 2-D grid of row bands and column spans, no division per element
//     (ops/epilogue_cuda.py::launch_plan): a thread takes VEC consecutive
//     columns of a row with 16-byte loads of each S plane and of pb, and
//     16-byte stores of two doubles where the output's rows are aligned; c
//     is read through its strides, two doubles a load where its rows are
//     contiguous and aligned.  Columns [0, n_body) go in vectors; the rest
//     of a row, and every row whose planes are not 16-byte aligned (odd n,
//     misaligned pointers), go one column at a time through the same code;
//   * the fold runs its twelve step slots in the order of
//     core/gemm.py::_zfold_block (beta * c, then each pass, the real target
//     before the imaginary one), each slot's presence a uniform bit, all
//     sources loaded before the first step.  It takes one column a thread
//     (a warp still reads 128 contiguous bytes of each plane a load): four
//     columns a thread hold 4 x 20 sources and unroll over a thousand
//     instructions four times, and ran slower for it (128 registers with
//     spills, some 200 KB of code; PERF.md).
// A block's band of rows lies in one matrix of a batch (pa [batch * m], pb
// [batch, n]), so finding the matrix is one division a block.

#include <cstdint>
#include <cuda_runtime.h>

#include "tf32x3.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int VEC = 4;  // columns per thread in a row's vector body (the epilogue)
constexpr int ZFOLD_BLOCKS_PER_SM = 4;  // the fold's occupancy (64 registers a thread)
constexpr int kSlots = 12;  // the fold's steps: 4 of beta * c, 2 per pass
constexpr int32_t kEmptyExp = -(1 << 20);  // core/gemm.py::_EMPTY_EXP

struct Scalar {
  float t0, t1, t2;
  int32_t e;
  float floor0, floor1;  // mul_fma_exact's bounds for this scalar
};

// Where a launch's rows and columns lie (ops/epilogue_cuda.py::launch_plan)
struct Tiles {
  int64_t m;       // rows of one matrix
  int64_t n;       // columns
  int32_t band;    // rows of a matrix per block
  int32_t bands;   // blocks per matrix along the rows
  int32_t blocks;  // row blocks of the launch, batch * bands
};

// The block's matrix b and rows [r0, r1); false for a block past the end
__device__ __forceinline__ bool row_band(const Tiles& t, int64_t& b, int64_t& r0, int64_t& r1) {
  const int32_t id = (int32_t)(blockIdx.z * gridDim.y + blockIdx.y);
  if (id >= t.blocks) return false;
  b = id / t.bands;
  r0 = (int64_t)(id - (int32_t)b * t.bands) * t.band;
  r1 = r0 + t.band < t.m ? r0 + t.band : t.m;
  return true;
}

// ---- vector and scalar accesses ------------------------------------------

// read-once data streams past the caches (__ldcs); pb is reused by every
// row of a block and goes through them
__device__ __forceinline__ void load(const float* p, float (&x)[4]) {
  const float4 v = __ldcs(reinterpret_cast<const float4*>(p));
  x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
}
__device__ __forceinline__ void load(const float* p, float (&x)[1]) { x[0] = __ldcs(p); }

template <bool STREAM>
__device__ __forceinline__ void load(const int32_t* p, int32_t (&x)[4]) {
  const int4 v = STREAM ? __ldcs(reinterpret_cast<const int4*>(p))
                        : __ldg(reinterpret_cast<const int4*>(p));
  x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
}
template <bool STREAM>
__device__ __forceinline__ void load(const int32_t* p, int32_t (&x)[1]) {
  x[0] = STREAM ? __ldcs(p) : __ldg(p);
}

// c's columns col .. col + V - 1 of a row: two doubles a load where wide
__device__ __forceinline__ void load_c(const double* row, int64_t col, int64_t cs, bool wide,
                                       double (&x)[4]) {
  if (wide) {
    const double2 u = __ldcs(reinterpret_cast<const double2*>(row + col));
    const double2 v = __ldcs(reinterpret_cast<const double2*>(row + col + 2));
    x[0] = u.x; x[1] = u.y; x[2] = v.x; x[3] = v.y;
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) x[j] = __ldcs(row + (col + j) * cs);
  }
}
__device__ __forceinline__ void load_c(const double* row, int64_t col, int64_t cs, bool,
                                       double (&x)[1]) {
  x[0] = __ldcs(row + col * cs);
}

__device__ __forceinline__ void store(double* row, int64_t col, bool wide, const double (&x)[4]) {
  if (wide) {
    __stcs(reinterpret_cast<double2*>(row + col), make_double2(x[0], x[1]));
    __stcs(reinterpret_cast<double2*>(row + col + 2), make_double2(x[2], x[3]));
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) __stcs(row + col + j, x[j]);
  }
}
__device__ __forceinline__ void store(double* row, int64_t col, bool, const double (&x)[1]) {
  __stcs(row + col, x[0]);
}

__device__ __forceinline__ oz::Triple mul_by(oz::Triple x, const Scalar& f) {
  return oz::mul_scalar(x, {f.t0, f.t1, f.t2}, f.floor0, f.floor1);
}

__device__ __forceinline__ double packed(oz::Triple t, int32_t e) {
  return __longlong_as_double(oz::pack_f64(t, e));
}

// ---- the epilogue ----------------------------------------------------------

struct EpilogueArgs {
  const float* s[3];    // S, [batch * m, n] each, contiguous
  const int32_t* e;     // the E-plane route: E [batch * m, n]
  const int32_t* pa;    // else pa [batch * m] and pb [batch, n]
  const int32_t* pb;
  int32_t shift;
  Tiles t;
  int64_t n_body;       // columns [0, n_body) in vectors of VEC, the rest one at a time
  Scalar alpha, beta;
  const double* c;      // at (c_rs, c_cs), read where beta != 0
  int64_t c_rs, c_cs;
  double* out;          // at row stride out_rs
  int64_t out_rs;
  int32_t c_wide, out_wide;
};

// one element: alpha * (S * 2^e) + beta * c rounded once
template <bool ALPHA, bool BETA, bool BETA_SCALE>
__device__ __forceinline__ double epilogue_one(oz::Triple S, int32_t e, double c,
                                               const EpilogueArgs& a) {
  if (ALPHA) {
    S = mul_by(S, a.alpha);
    e += a.alpha.e;
  }
  if (BETA) {
    int32_t cE;
    oz::Triple ct = oz::unpack_f64(c, cE);
    if (BETA_SCALE) {
      ct = mul_by(ct, a.beta);
      cE += a.beta.e;
    }
    S = oz::aligned_add(S, e, ct, cE, e);
  }
  return packed(S, e);
}

// V consecutive columns from col of one row (offset off into the planes)
template <int V, bool EPLANE, bool ALPHA, bool BETA, bool BETA_SCALE>
__device__ __forceinline__ void epilogue_cols(const EpilogueArgs& a, int64_t off, int64_t col,
                                              const int32_t* erow, int32_t ebase,
                                              const double* crow, double* orow) {
  float s0[V], s1[V], s2[V];
  int32_t e[V];
  double c[V], o[V];
  load(a.s[0] + off + col, s0);
  load(a.s[1] + off + col, s1);
  load(a.s[2] + off + col, s2);
  load<EPLANE>(erow + col, e);
  if (BETA) load_c(crow, col, a.c_cs, a.c_wide, c);
#pragma unroll
  for (int j = 0; j < V; ++j)
    o[j] = epilogue_one<ALPHA, BETA, BETA_SCALE>({s0[j], s1[j], s2[j]}, ebase + e[j],
                                                 BETA ? c[j] : 0.0, a);
  store(orow, col, a.out_wide, o);
}

template <bool EPLANE, bool ALPHA, bool BETA, bool BETA_SCALE>
__global__ void __launch_bounds__(THREADS) epilogue_kernel(const __grid_constant__ EpilogueArgs a) {
  int64_t b, r0, r1;
  if (!row_band(a.t, b, r0, r1)) return;
  const int64_t x = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t xs = (int64_t)gridDim.x * blockDim.x;
  for (int64_t r = r0 + threadIdx.y; r < r1; r += blockDim.y) {
    const int64_t row = b * a.t.m + r;
    const int64_t off = row * a.t.n;
    const int32_t* erow = EPLANE ? a.e + off : a.pb + b * a.t.n;
    const int32_t ebase = EPLANE ? 0 : __ldg(a.pa + row) - a.shift;
    const double* crow = BETA ? a.c + row * a.c_rs : nullptr;
    double* orow = a.out + row * a.out_rs;
    for (int64_t col = x * VEC; col < a.n_body; col += xs * VEC)
      epilogue_cols<VEC, EPLANE, ALPHA, BETA, BETA_SCALE>(a, off, col, erow, ebase, crow, orow);
    for (int64_t col = a.n_body + x; col < a.t.n; col += xs)
      epilogue_cols<1, EPLANE, ALPHA, BETA, BETA_SCALE>(a, off, col, erow, ebase, crow, orow);
  }
}

// ---- the complex fold ------------------------------------------------------

struct ZfoldArgs {
  const float* s[4][3];  // the passes' S, [batch * m, n] each, contiguous
  const int32_t* pa[4];  // the passes' exponents: pa [batch * m], pb [batch, n]
  const int32_t* pb[4];
  int32_t shift;
  Tiles t;
  const double* c[2];    // c's real and imaginary parts, or null (reads as empty)
  int64_t c_rs[2], c_cs[2];
  double* out[2];
  int64_t out_rs[2];
  int32_t init_from_c;   // the accumulators start as c (beta == 1), else empty
  int32_t present;       // bit k: slot k adds a step
  Scalar scale[kSlots];  // slot k's factor
};

// slot k adds v * 2^ve times its factor to acc (if the plan has it)
__device__ __forceinline__ void fold_step(const ZfoldArgs& a, int k, const oz::Triple& v,
                                          int32_t ve, oz::Triple& acc, int32_t& acc_e) {
  if (a.present & (1 << k)) {
    const Scalar& f = a.scale[k];
    acc = oz::aligned_add(acc, acc_e, mul_by(v, f), ve + f.e, acc_e);
  }
}

// one element: the sources, the twelve slots (0-3: c_re -> re, c_re -> im,
// c_im -> re, c_im -> im; 4 + 2p, 5 + 2p: pass p -> re, -> im), the packs
__device__ __forceinline__ void zfold_one(const ZfoldArgs& a, const oz::Triple (&S)[4],
                                          const int32_t (&e)[4], const double (&c)[2],
                                          double& re_out, double& im_out) {
  oz::Triple ct[2];
  int32_t ce[2];
#pragma unroll
  for (int p = 0; p < 2; ++p) {
    if (a.c[p] != nullptr) {
      ct[p] = oz::unpack_f64(c[p], ce[p]);
    } else {
      ct[p] = {0.0f, 0.0f, 0.0f};
      ce[p] = kEmptyExp;
    }
  }
  oz::Triple re = {0.0f, 0.0f, 0.0f}, im = {0.0f, 0.0f, 0.0f};
  int32_t re_e = kEmptyExp, im_e = kEmptyExp;
  if (a.init_from_c) {
    re = ct[0];
    re_e = ce[0];
    im = ct[1];
    im_e = ce[1];
  }
  fold_step(a, 0, ct[0], ce[0], re, re_e);
  fold_step(a, 1, ct[0], ce[0], im, im_e);
  fold_step(a, 2, ct[1], ce[1], re, re_e);
  fold_step(a, 3, ct[1], ce[1], im, im_e);
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    fold_step(a, 4 + 2 * p, S[p], e[p], re, re_e);
    fold_step(a, 5 + 2 * p, S[p], e[p], im, im_e);
  }
  re_out = packed(re, re_e);
  im_out = packed(im, im_e);
}

__global__ void __launch_bounds__(THREADS, ZFOLD_BLOCKS_PER_SM)
zfold_kernel(const __grid_constant__ ZfoldArgs a) {
  int64_t b, r0, r1;
  if (!row_band(a.t, b, r0, r1)) return;
  const int64_t x = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t xs = (int64_t)gridDim.x * blockDim.x;
  const int64_t pb_off = b * a.t.n;
  for (int64_t r = r0 + threadIdx.y; r < r1; r += blockDim.y) {
    const int64_t row = b * a.t.m + r;
    const int64_t off = row * a.t.n;
    int32_t ebase[4];
#pragma unroll
    for (int p = 0; p < 4; ++p) ebase[p] = __ldg(a.pa[p] + row) - a.shift;
    const double* const crow[2] = {a.c[0] + row * a.c_rs[0], a.c[1] + row * a.c_rs[1]};
    for (int64_t col = x; col < a.t.n; col += xs) {
      oz::Triple S[4];
      int32_t e[4];
      double c[2] = {0.0, 0.0};
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        S[p] = {__ldcs(a.s[p][0] + off + col), __ldcs(a.s[p][1] + off + col),
                __ldcs(a.s[p][2] + off + col)};
        e[p] = ebase[p] + __ldg(a.pb[p] + pb_off + col);
      }
#pragma unroll
      for (int p = 0; p < 2; ++p)
        if (a.c[p] != nullptr) c[p] = __ldcs(crow[p] + col * a.c_cs[p]);
      double re, im;
      zfold_one(a, S, e, c, re, im);
      __stcs(a.out[0] + row * a.out_rs[0] + col, re);
      __stcs(a.out[1] + row * a.out_rs[1] + col, im);
    }
  }
}

// ---- the C interface --------------------------------------------------------

Tiles tiles(int64_t m, int64_t n, const int32_t* plan) {
  // plan: band, bands, blocks, tx, ty, gx, gy, gz (launch_plan's order)
  return {m, n, plan[0], plan[1], plan[2]};
}

Scalar scalar(const float* f, int32_t e) { return {f[0], f[1], f[2], e, f[3], f[4]}; }

template <bool EPLANE, bool ALPHA, bool BETA, bool BETA_SCALE>
void launch_branch(const EpilogueArgs& a, dim3 grid, dim3 block, cudaStream_t s) {
  epilogue_kernel<EPLANE, ALPHA, BETA, BETA_SCALE><<<grid, block, 0, s>>>(a);
}

template <bool EPLANE>
void launch_epilogue(int flags, const EpilogueArgs& a, dim3 grid, dim3 block, cudaStream_t s) {
  switch (flags & 7) {
    case 0: case 4: launch_branch<EPLANE, false, false, false>(a, grid, block, s); break;
    case 1: case 5: launch_branch<EPLANE, true, false, false>(a, grid, block, s); break;
    case 2: launch_branch<EPLANE, false, true, false>(a, grid, block, s); break;
    case 3: launch_branch<EPLANE, true, true, false>(a, grid, block, s); break;
    case 6: launch_branch<EPLANE, false, true, true>(a, grid, block, s); break;
    default: launch_branch<EPLANE, true, true, true>(a, grid, block, s); break;
  }
}

}  // namespace

// s: S's three float32 planes [batch * m, n]; e: E int32 [batch * m, n]
// (flags bit 3), else pa int32 [batch * m] and pb int32 [batch, n] with
// shift; plan: the eight ints of launch_plan; alpha, beta: five floats each
// (the triple, then mul_fma_exact's two floors) and the exponents; flags:
// bit 0 alpha != 1, bit 1 beta != 0, bit 2 beta != 1, bit 3 the E-plane
// route, bit 4 c's rows read two doubles a load, bit 5 out's rows written
// so; c: float64 at (c_rs, c_cs), read only where beta != 0; out: float64
// at row stride out_rs.  Returns the launch's CUDA error code.
extern "C" int oz_epilogue(const void* const* s, const void* e, const void* pa, const void* pb,
                           int shift, int64_t m, int64_t n, int64_t n_body, const int* plan,
                           const float* alpha, int ae, const float* beta, int be, int flags,
                           const void* c, int64_t c_rs, int64_t c_cs, void* out, int64_t out_rs,
                           void* stream) {
  EpilogueArgs a = {};
  for (int q = 0; q < 3; ++q) a.s[q] = (const float*)s[q];
  a.e = (const int32_t*)e;
  a.pa = (const int32_t*)pa;
  a.pb = (const int32_t*)pb;
  a.shift = shift;
  a.t = tiles(m, n, plan);
  a.n_body = n_body;
  a.alpha = scalar(alpha, ae);
  a.beta = scalar(beta, be);
  a.c = (const double*)c;
  a.c_rs = c_rs;
  a.c_cs = c_cs;
  a.out = (double*)out;
  a.out_rs = out_rs;
  a.c_wide = (flags >> 4) & 1;
  a.out_wide = (flags >> 5) & 1;
  const dim3 block(plan[3], plan[4]), grid(plan[5], plan[6], plan[7]);
  const cudaStream_t st = (cudaStream_t)stream;
  if (flags & 8)
    launch_epilogue<true>(flags, a, grid, block, st);
  else
    launch_epilogue<false>(flags, a, grid, block, st);
  return (int)cudaGetLastError();
}

// s: 12 pointers, pass p's planes at 3p .. 3p + 2; pa, pb: 4 each, pass p's
// exponents; c_re / c_im nullable, at (c_strides[0], [1]) and ([2], [3]);
// the outputs at row strides re_rs and im_rs; flags: bit 0 the
// accumulators start as c; present: bit k, slot k adds a step, with
// the five floats t[5k .. 5k + 4] and the exponent te[k].
extern "C" int oz_zfold(const void* const* s, const void* const* pa, const void* const* pb,
                        int shift, int64_t m, int64_t n, const int* plan,
                        const void* c_re, const void* c_im, const int64_t* c_strides,
                        void* out_re, void* out_im, int64_t re_rs, int64_t im_rs, int flags,
                        int present, const float* t, const int* te, void* stream) {
  ZfoldArgs a = {};
  for (int p = 0; p < 4; ++p) {
    for (int q = 0; q < 3; ++q) a.s[p][q] = (const float*)s[3 * p + q];
    a.pa[p] = (const int32_t*)pa[p];
    a.pb[p] = (const int32_t*)pb[p];
  }
  a.shift = shift;
  a.t = tiles(m, n, plan);
  a.c[0] = (const double*)c_re;
  a.c[1] = (const double*)c_im;
  for (int p = 0; p < 2; ++p) {
    a.c_rs[p] = c_strides[2 * p];
    a.c_cs[p] = c_strides[2 * p + 1];
  }
  a.out[0] = (double*)out_re;
  a.out[1] = (double*)out_im;
  a.out_rs[0] = re_rs;
  a.out_rs[1] = im_rs;
  a.init_from_c = flags & 1;
  a.present = present & ((1 << kSlots) - 1);
  for (int k = 0; k < kSlots; ++k) a.scale[k] = scalar(t + 5 * k, te[k]);
  const dim3 block(plan[3], plan[4]), grid(plan[5], plan[6], plan[7]);
  zfold_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
