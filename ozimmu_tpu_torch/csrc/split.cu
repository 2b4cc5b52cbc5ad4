// split_digits: exact float64 -> ns sign-magnitude int8 digit planes.
//
// Replaces the TPU kernel ozimmu_tpu/ops/split_pallas.py:134
// (split_digits_pallas, body _extract_digits / _shr128) and computes the
// same planes, bit for bit, as the plain PyTorch version
// ozimmu_tpu_torch/ops/split.py::split_with_row_exp.
//
// Per element: m53 = the 53-bit significand (implicit bit where the
// exponent field is above 0), top-aligned in 128 bits and shifted right by
// u = E_row + 1 - E (u = 159 where the row's max exponent field is 0, which
// flushes every digit to zero).  Digit i (1-indexed) is then the FIXED
// b-bit window at bit 128 - i*b, times the sign.
//
// What bounds it on an H100: device memory, 8 bytes in and ns bytes out per
// element, with the integer work close behind (ns windows of a 128-bit
// value per element).  The design follows from both:
//   * b is a template argument and the plane loop is unrolled, so every
//     window position is a constant: a digit is a shift and a mask, not a
//     variable 128-bit shift.  Four digits of one plane are packed into a
//     32-bit word and their signs applied together (no borrow between the
//     bytes: a digit is at most 127).
//   * 16-byte loads where the rows are 16-byte aligned, and one 16-byte
//     store per plane (16 consecutive elements of a row per thread) where
//     the output row length is a multiple of 16; 1-byte stores otherwise.
//   * All ns planes are written in one pass: the operand is read once.
//
// Two layouts of the planes:
//   * rows (split_rows_kernel): [ns, batch, rows, out_cols], each output row
//     the input row, zero from `cols` to `out_cols`.  out_cols = cols is the
//     natural layout ([ns, R, C], the TPU kernel's); for the A operand
//     (axis = 1) out_cols = k_pad gives the k-major form recombine reads.
//   * tiles (split_tiles_kernel): the B operand (axis = 0, x [k, n]) written
//     k-major, [ns, batch, n, k_pad], the form recombine's 8-bit wgmma
//     needs, with no transposed copy: a block reads a 64 (k) x 64 (n) tile
//     with 16-byte loads along n, writes each plane's digits transposed into
//     shared memory (one 32-bit word = 4 k of one column; rows of 17 words,
//     so that a warp's stores meet at most 2 to a bank), then stores each
//     plane's 64 columns x 64 k as 16-byte chunks.
//
// The input is read through its batch and row strides (its elements along
// a row contiguous), so a column panel b[:, j0:j1] is split where it lies.
// Rows' exponents (axis = 1, the A operand) are int32 [batch * rows];
// columns' exponents (axis = 0, the B operand) int32 [batch, cols].  Every
// flattened index is 64-bit.  The launch geometry (layout, elements per
// thread, 16-byte loads, grid, shared memory) is chosen on the host
// (ozimmu_tpu_torch/ops/split_cuda.py::split_plan).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int TILE = 64;                  // tiles kernel: 64 k rows x 64 columns
constexpr int TILE_WORDS = TILE / 4 + 1;  // a column's 64 k bytes, + 1 word of padding

// the most planes for a digit width B (ns * b <= 126, ns <= 18)
template <int B>
__host__ __device__ constexpr int max_planes() { return 126 / B < 18 ? 126 / B : 18; }

// (hi, lo) = (m53 << 75) >> u, the 128-bit value whose fixed windows are
// the digits; u in [0, 159], zero from 128 on
__device__ __forceinline__ void shifted(uint64_t bits, int er, uint64_t& hi, uint64_t& lo) {
  const int e = (int)((bits >> 52) & 0x7FFull);
  uint64_t m53 = bits & ((1ull << 52) - 1ull);
  if (e > 0) m53 |= 1ull << 52;
  int u = er > 0 ? er + 1 - e : 159;
  // u < 0 only for an e_max below the element's own exponent; the TPU
  // kernel's unsigned shift flushes that to zero digits, and so does this
  if (u < 0 || u > 159) u = 159;
  const uint64_t top = m53 << 11;
  if (u >= 128) {
    hi = 0;
    lo = 0;
  } else if (u >= 64) {
    hi = 0;
    lo = top >> (u - 64);
  } else if (u > 0) {
    hi = top >> u;
    lo = top << (64 - u);
  } else {
    hi = top;
    lo = 0;
  }
}

// the B-bit window at bit q of (hi, lo); q in [2, 121] is a constant once
// the plane loop is unrolled
template <int B>
__device__ __forceinline__ uint32_t window(uint64_t hi, uint64_t lo, int q) {
  uint64_t w;
  if (q >= 64) {
    w = hi >> (q - 64);
  } else if (q + B <= 64) {
    w = lo >> q;
  } else {
    w = (lo >> q) | (hi << (64 - q));
  }
  return (uint32_t)w & ((1u << B) - 1u);
}

// four unsigned digits (bytes of d, each <= 127) negated where the byte of
// sgn is 0xFF: 0x80 - d cannot borrow, and (0x80 - d) ^ 0x80 = -d mod 256
__device__ __forceinline__ uint32_t signed_bytes(uint32_t d, uint32_t sgn) {
  const uint32_t neg = (0x80808080u - d) ^ 0x80808080u;
  return (neg & sgn) | (d & ~sgn);
}

__device__ __forceinline__ uint32_t sign_byte(uint64_t bits, int j) {
  return (uint32_t)(bits >> 63) * (0xFFu << (8 * (j & 3)));
}

template <int V>
__device__ __forceinline__ void store_plane(int8_t* o, const uint32_t* w) {
  if constexpr (V == 16) {
    *reinterpret_cast<uint4*>(o) = make_uint4(w[0], w[1], w[2], w[3]);
  } else {
    *o = (int8_t)(w[0] & 0xFFu);
  }
}

// Each thread: V consecutive elements of one row, all planes.
template <int V, bool LOAD16, int B>
__global__ void __launch_bounds__(THREADS)
split_rows_kernel(const uint64_t* __restrict__ x, const int32_t* __restrict__ e_max,
                  int8_t* __restrict__ out, int64_t batch, int64_t rows, int64_t cols,
                  int64_t sb, int64_t sr, int64_t out_cols, int num_split, int axis) {
  constexpr int NW = (V + 3) / 4;
  const int64_t chunks = out_cols / V;
  const int64_t total = batch * rows * chunks;
  const int64_t plane = batch * rows * out_cols;
  for (int64_t idx = (int64_t)blockIdx.x * THREADS + threadIdx.x; idx < total;
       idx += (int64_t)gridDim.x * THREADS) {
    const int64_t g = idx / chunks;  // the row over the whole batch
    const int64_t c0 = (idx - g * chunks) * V;
    const int64_t bi = g / rows;
    const uint64_t* xr = x + bi * sb + (g - bi * rows) * sr;
    uint64_t bits[V];
    if constexpr (LOAD16) {
#pragma unroll
      for (int j = 0; j < V; j += 2) {
        const int64_t c = c0 + j;
        if (c + 1 < cols) {
          const ulonglong2 v = *reinterpret_cast<const ulonglong2*>(xr + c);
          bits[j] = v.x;
          bits[j + 1] = v.y;
        } else {
          bits[j] = c < cols ? xr[c] : 0ull;
          bits[j + 1] = 0ull;
        }
      }
    } else {
#pragma unroll
      for (int j = 0; j < V; ++j) bits[j] = c0 + j < cols ? xr[c0 + j] : 0ull;
    }
    const int e_row = axis == 1 ? e_max[g] : 0;
    uint64_t hi[V], lo[V];
    uint32_t sgn[NW];
#pragma unroll
    for (int i = 0; i < NW; ++i) sgn[i] = 0;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const int64_t c = c0 + j;
      const int er = axis == 1 ? e_row : (c < cols ? e_max[bi * cols + c] : 0);
      shifted(bits[j], er, hi[j], lo[j]);
      sgn[j / 4] |= sign_byte(bits[j], j);
    }
    int8_t* o = out + g * out_cols + c0;
#pragma unroll
    for (int p = 0; p < max_planes<B>(); ++p) {
      if (p < num_split) {
        const int q = 128 - (p + 1) * B;  // the window's lowest bit
        uint32_t w[NW];
#pragma unroll
        for (int i = 0; i < NW; ++i) w[i] = 0;
#pragma unroll
        for (int j = 0; j < V; ++j) w[j / 4] |= window<B>(hi[j], lo[j], q) << (8 * (j & 3));
#pragma unroll
        for (int i = 0; i < NW; ++i) w[i] = signed_bytes(w[i], sgn[i]);
        store_plane<V>(o + p * plane, w);
      }
    }
  }
}

// One block: a 64 (k) x 64 (column) tile of the B operand x [batch, k, n]
// into out [ns, batch, n, out_cols] (k-major, zero from k to out_cols).
template <bool LOAD16, int B>
__global__ void __launch_bounds__(THREADS)
split_tiles_kernel(const uint64_t* __restrict__ x, const int32_t* __restrict__ e_max,
                   int8_t* __restrict__ out, int64_t batch, int64_t rows, int64_t cols,
                   int64_t sb, int64_t sr, int64_t out_cols, int num_split) {
  extern __shared__ uint32_t sm[];  // [ns][TILE columns][TILE_WORDS]
  constexpr int PLANE_WORDS = TILE * TILE_WORDS;
  const int64_t ctiles = (cols + TILE - 1) / TILE;
  const int64_t ktiles = (out_cols + TILE - 1) / TILE;
  int64_t t = blockIdx.x;
  const int64_t ct = t % ctiles;
  t /= ctiles;
  const int64_t kt = t % ktiles;
  const int64_t bi = t / ktiles;
  const int64_t c_base = ct * TILE, k_base = kt * TILE;

  // phase 1: thread (cp, kg) reads columns c, c + 1 at k rows
  // k_base + 32h + 4kg + i (h < 2, i < 4): 16-byte loads, a warp's 32 of
  // them one row's 512 contiguous bytes
  const int cp = threadIdx.x & 31, kg = threadIdx.x >> 5;
  const int64_t c = c_base + 2 * cp;
  const uint64_t* xb = x + bi * sb;
  uint64_t bits[2][8];
#pragma unroll
  for (int s = 0; s < 8; ++s) {
    const int64_t r = k_base + 32 * (s / 4) + 4 * kg + (s % 4);
    bits[0][s] = bits[1][s] = 0ull;
    if (r < rows && c < cols) {
      const uint64_t* xr = xb + r * sr + c;
      if (LOAD16 && c + 1 < cols) {
        const ulonglong2 v = *reinterpret_cast<const ulonglong2*>(xr);
        bits[0][s] = v.x;
        bits[1][s] = v.y;
      } else {
        bits[0][s] = xr[0];
        if (c + 1 < cols) bits[1][s] = xr[1];
      }
    }
  }
  const int er[2] = {c < cols ? e_max[bi * cols + c] : 0,
                     c + 1 < cols ? e_max[bi * cols + c + 1] : 0};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int col = 0; col < 2; ++col) {
      uint64_t hi[4], lo[4];
      uint32_t sgn = 0;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        shifted(bits[col][4 * h + i], er[col], hi[i], lo[i]);
        sgn |= sign_byte(bits[col][4 * h + i], i);
      }
      // word 8h + kg of this column: k bytes 32h + 4kg .. + 3 of the tile
      uint32_t* dst = sm + (2 * cp + col) * TILE_WORDS + 8 * h + kg;
#pragma unroll
      for (int p = 0; p < max_planes<B>(); ++p) {
        if (p < num_split) {
          const int q = 128 - (p + 1) * B;
          uint32_t w = 0;
#pragma unroll
          for (int i = 0; i < 4; ++i) w |= window<B>(hi[i], lo[i], q) << (8 * i);
          dst[p * PLANE_WORDS] = signed_bytes(w, sgn);
        }
      }
    }
  }
  __syncthreads();

  // phase 2: per plane, column col's k bytes 16ch .. 16ch + 15 as one
  // 16-byte store (a warp writes 8 columns' 64 contiguous bytes each)
  const int col = threadIdx.x >> 2, ch = threadIdx.x & 3;
  const int64_t oc = c_base + col, ok = k_base + 16 * ch;
  if (oc < cols && ok < out_cols) {
    const int64_t plane = batch * cols * out_cols;
    int8_t* o = out + (bi * cols + oc) * out_cols + ok;
    const uint32_t* src = sm + col * TILE_WORDS + 4 * ch;
    for (int p = 0; p < num_split; ++p) {
      const uint32_t* s = src + p * PLANE_WORDS;
      *reinterpret_cast<uint4*>(o + p * plane) = make_uint4(s[0], s[1], s[2], s[3]);
    }
  }
}

struct Args {
  const uint64_t* x;
  const int32_t* e_max;
  int8_t* out;
  int64_t batch, rows, cols, sb, sr, out_cols;
  int num_split, axis;
};

template <int B>
int launch(const Args& a, int layout, int vec, int load16, unsigned grid, int smem,
           cudaStream_t s) {
  if (layout == 1) {
    auto kernel = load16 ? split_tiles_kernel<true, B> : split_tiles_kernel<false, B>;
    if (smem > 48 * 1024) {
      const cudaError_t err =
          cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (err != cudaSuccess) return (int)err;
    }
    kernel<<<grid, THREADS, smem, s>>>(a.x, a.e_max, a.out, a.batch, a.rows, a.cols, a.sb, a.sr,
                                       a.out_cols, a.num_split);
  } else if (vec == 16) {
    auto kernel = load16 ? split_rows_kernel<16, true, B> : split_rows_kernel<16, false, B>;
    kernel<<<grid, THREADS, 0, s>>>(a.x, a.e_max, a.out, a.batch, a.rows, a.cols, a.sb, a.sr,
                                    a.out_cols, a.num_split, a.axis);
  } else if (vec == 1) {
    split_rows_kernel<1, false, B><<<grid, THREADS, 0, s>>>(
        a.x, a.e_max, a.out, a.batch, a.rows, a.cols, a.sb, a.sr, a.out_cols, a.num_split,
        a.axis);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// x: float64 [batch, rows, cols] at strides (batch_stride, row_stride, 1);
// e_max: int32 [batch * rows] (axis = 1) or [batch, cols] (axis = 0);
// out: int8 [ns, batch, rows, out_cols] (layout 0) or, for axis = 0,
// [ns, batch, cols, out_cols] (layout 1, k-major).
extern "C" int oz_split_digits(const void* x, const void* e_max, void* out, int64_t batch,
                               int64_t rows, int64_t cols, int64_t batch_stride,
                               int64_t row_stride, int64_t out_cols, int num_split, int b,
                               int axis, int layout, int vec, int load16, int64_t grid,
                               int smem_bytes, void* stream) {
  const Args a{(const uint64_t*)x, (const int32_t*)e_max, (int8_t*)out, batch, rows, cols,
               batch_stride, row_stride, out_cols, num_split, axis};
  const cudaStream_t s = (cudaStream_t)stream;
  const unsigned g = (unsigned)grid;
  switch (b) {
    case 1: return launch<1>(a, layout, vec, load16, g, smem_bytes, s);
    case 2: return launch<2>(a, layout, vec, load16, g, smem_bytes, s);
    case 3: return launch<3>(a, layout, vec, load16, g, smem_bytes, s);
    case 4: return launch<4>(a, layout, vec, load16, g, smem_bytes, s);
    case 5: return launch<5>(a, layout, vec, load16, g, smem_bytes, s);
    case 6: return launch<6>(a, layout, vec, load16, g, smem_bytes, s);
    case 7: return launch<7>(a, layout, vec, load16, g, smem_bytes, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* oz_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
