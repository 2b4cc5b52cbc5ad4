// mantissa_loss: AUTO's estimator, the 16 mantissa-loss totals of a
// float64 operand for ns = 3..18 digit planes of b bits, added into one
// int64 [16] buffer on the card.
//
// Replaces no TPU kernel: the JAX package's estimator is plain XLA
// (ozimmu_tpu/ops/mantissa_loss.py::loss_totals_with_group_exp), and the
// plain PyTorch version beside this kernel
// (ozimmu_tpu_torch/ops/mantissa_loss.py::loss_totals_plain) histograms the
// bits each element needs with torch.bincount: some 30 launches an operand,
// and host reads of the histogram's size.  A re-derivation of the reference
// estimator (ozIMMU src/split.cu, get_mantissa_loss_total): per element,
//   required = (group_max_field + 1 - field) + 53,
// 0 for a value that is exactly zero or a group whose max field is 0, and
// clamped at 0; its loss for ns slices is max(0, required - ns*b).  Since
// required >= 0 and ns*b >= 0, max(0, r - s) = r - min(r, s), so each thread
// sums r once and min(r, ns*b) for the 16 candidates (b is a template
// argument: the 16 thresholds are constants), all in integers.  Integer sums
// are exact in any order, so the totals equal the plain version's and the
// JAX package's bit for bit however the atomics land.
//
// What bounds it on an H100: device memory, 8 bytes read per element, with
// the integer work (about 30 operations an element) close behind.  The
// group maximum must be known before any total, so each block owns whole
// groups and keeps what it read:
//   * rows (mantissa_loss_rows_kernel, the A operand, axis = 1): a row, or a
//     few rows, per block at a time, each lane reading two elements with one
//     16-byte load; each element's exponent field (or a zero mark) is kept
//     as 16 bits in shared memory, two a word, a column of words per thread;
//     the row maximum by a warp max and one __syncthreads; then the totals
//     from shared memory.  The operand is read once.
//   * columns (mantissa_loss_cols_kernel, the B operand, axis = 0): a strip
//     of 4 columns (32 bytes, one sector, a row) over all k rows per block,
//     the same keeping of fields, the column maxima by warp shuffles and
//     shared memory, then the totals.  Read once as well.
// Where a thread's share of a group exceeds the shared memory it is given,
// the rest is read again from device memory in the second pass.  With an
// external group maximum (the distributed estimator's) there is no first
// pass: one read.  Each thread's sums are 32-bit for the 16 minima (at most
// 126 an element) and 64-bit for r; at the end a block reduces them and adds
// its 16 totals into the buffer with 64-bit integer atomics.  The launch
// geometry is chosen on the host
// (ozimmu_tpu_torch/ops/mantissa_loss_cuda.py::loss_plan).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int CANDIDATES = 16;       // ns = 3..18
constexpr int MIN_SPLIT = 3;
constexpr uint32_t ZERO = 0xFFFFu;   // the kept code of a value that is exactly zero
constexpr int STRIP = 4;             // columns of a strip (cols kernel)

struct Pair {
  uint64_t x, y;
};

__device__ __forceinline__ uint32_t field(uint64_t bits) {
  return (uint32_t)(bits >> 52) & 0x7FFu;
}

// the exponent field of a value, or ZERO where it is +-0.0
__device__ __forceinline__ uint32_t code(uint64_t bits) {
  return (bits << 1) != 0 ? field(bits) : ZERO;
}

__device__ __forceinline__ uint32_t pack(Pair v) { return code(v.x) | (code(v.y) << 16); }

// elements i and i + 1 of a row (the second 0, which reads as zero, past n)
__device__ __forceinline__ Pair load_pair(const uint64_t* p, int64_t i, int64_t n, bool load16) {
  if (load16 && i + 1 < n) {
    const ulonglong2 v = *reinterpret_cast<const ulonglong2*>(p + i);
    return {v.x, v.y};
  }
  return {p[i], i + 1 < n ? p[i + 1] : 0};
}

// a group's maximum field as the base of its elements' required bits:
// r = base - field, with base 0 (every r <= 0) where the maximum is 0
__device__ __forceinline__ int32_t base_of(int32_t e_group) {
  return e_group > 0 ? (int32_t)((uint32_t)e_group + 54u) : 0;
}

__device__ __forceinline__ uint32_t required(int32_t base, uint32_t c) {
  const int32_t r = (int32_t)((uint32_t)base - c);
  return (c != ZERO && r > 0) ? (uint32_t)r : 0u;
}

// one thread's sums: r over its elements, and min(r, ns*b) per candidate
template <int B>
struct Sums {
  uint64_t r = 0;
  uint32_t m[CANDIDATES] = {};

  __device__ __forceinline__ void add(uint32_t r0, uint32_t r1) {
    r += (uint64_t)r0 + r1;
    if constexpr (B > 0) {
#pragma unroll
      for (int j = 0; j < CANDIDATES; ++j) {
        const uint32_t s = (MIN_SPLIT + j) * B;
        m[j] += min(r0, s) + min(r1, s);
      }
    }
  }

  // the block's totals, sum(r) - sum(min(r, ns*b)), added into totals
  __device__ void flush(unsigned long long* totals, unsigned long long (*part)[CANDIDATES + 1]) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    unsigned long long v = r;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xFFFFFFFFu, v, o);
    if (lane == 0) part[warp][0] = v;
#pragma unroll
    for (int j = 0; j < CANDIDATES; ++j) {
      unsigned long long w = m[j];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) w += __shfl_down_sync(0xFFFFFFFFu, w, o);
      if (lane == 0) part[warp][j + 1] = w;
    }
    __syncthreads();
    if (threadIdx.x < CANDIDATES) {
      unsigned long long sr = 0, sm = 0;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) {
        sr += part[w][0];
        sm += part[w][threadIdx.x + 1];
      }
      if (sr != sm) atomicAdd(totals + threadIdx.x, sr - sm);
    }
  }
};

// x [batch, rows, cols] by rows: `width` warps a row, so THREADS / (32 *
// width) rows a block at a time; `staged` words of shared memory a thread
// (two fields a word) keep what the first pass read
template <int B>
__global__ void __launch_bounds__(THREADS)
mantissa_loss_rows_kernel(const uint64_t* __restrict__ x, const int32_t* __restrict__ e_group,
                          unsigned long long* __restrict__ totals, int64_t batch, int64_t rows,
                          int64_t cols, int64_t sb, int64_t sr, int width, int staged,
                          int load16) {
  extern __shared__ uint32_t stage[];  // [staged][THREADS]
  __shared__ uint32_t row_max[2][WARPS];
  __shared__ unsigned long long part[WARPS][CANDIDATES + 1];
  Sums<B> sums;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int tpr = 32 * width;           // threads of a row
  const int per_block = WARPS / width;  // rows of a block at a time
  const int slot = threadIdx.x / tpr, t = threadIdx.x % tpr;
  const int64_t n_rows = batch * rows;
  const int64_t step = 2 * (int64_t)tpr;  // elements of a row a pass over its threads covers
  const bool l16 = load16 != 0;
  int parity = 0;
  for (int64_t g0 = (int64_t)blockIdx.x * per_block; g0 < n_rows;
       g0 += (int64_t)gridDim.x * per_block) {
    const int64_t g = g0 + slot;
    const bool live = g < n_rows;
    const uint64_t* xr = x;
    if (live) {
      const int64_t bi = g / rows;
      xr = x + bi * sb + (g - bi * rows) * sr;
    }
    if (e_group != nullptr) {  // the group maximum is given: one pass
      if (live) {
        const int32_t base = base_of(e_group[g]);
#pragma unroll 4
        for (int64_t c = 2 * (int64_t)t; c < cols; c += step) {
          const Pair v = load_pair(xr, c, cols, l16);
          sums.add(required(base, code(v.x)), required(base, code(v.y)));
        }
      }
      continue;
    }
    uint32_t e = 0;
    if (live) {
      int i = 0;
#pragma unroll 4
      for (int64_t c = 2 * (int64_t)t; c < cols; c += step, ++i) {
        const Pair v = load_pair(xr, c, cols, l16);
        e = max(e, max(field(v.x), field(v.y)));
        if (i < staged) stage[i * THREADS + threadIdx.x] = pack(v);
      }
    }
    e = __reduce_max_sync(0xFFFFFFFFu, e);
    if (lane == 0) row_max[parity][warp] = e;
    __syncthreads();
    uint32_t eg = 0;
    for (int w = slot * width; w < (slot + 1) * width; ++w) eg = max(eg, row_max[parity][w]);
    parity ^= 1;
    if (live) {
      const int32_t base = base_of((int32_t)eg);
      int i = 0;
#pragma unroll 4
      for (int64_t c = 2 * (int64_t)t; c < cols; c += step, ++i) {
        const uint32_t w = i < staged ? stage[i * THREADS + threadIdx.x]
                                      : pack(load_pair(xr, c, cols, l16));
        sums.add(required(base, w & 0xFFFFu), required(base, w >> 16));
      }
    }
  }
  sums.flush(totals, part);
}

// x [batch, rows, cols] by columns: a strip of STRIP columns over all rows
// a block at a time, two columns a thread, THREADS / (STRIP / 2) rows a
// step; `staged` as for the rows (the fourth int, the rows kernel's
// `width`, is not used)
template <int B>
__global__ void __launch_bounds__(THREADS)
mantissa_loss_cols_kernel(const uint64_t* __restrict__ x, const int32_t* __restrict__ e_group,
                          unsigned long long* __restrict__ totals, int64_t batch, int64_t rows,
                          int64_t cols, int64_t sb, int64_t sr, int, int staged, int load16) {
  extern __shared__ uint32_t stage[];  // [staged][THREADS]
  __shared__ uint32_t col_max[2][WARPS][STRIP];
  __shared__ unsigned long long part[WARPS][CANDIDATES + 1];
  Sums<B> sums;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  constexpr int tpr = STRIP / 2;        // threads across a row
  constexpr int rstep = THREADS / tpr;  // rows a step
  const int tx = threadIdx.x % tpr, ty = threadIdx.x / tpr;
  const int64_t strips = (cols + STRIP - 1) / STRIP;
  const bool l16 = load16 != 0;
  int parity = 0;
  for (int64_t s = blockIdx.x; s < batch * strips; s += gridDim.x) {
    const int64_t bi = s / strips;
    const int64_t c = (s - bi * strips) * STRIP + 2 * tx;
    const bool live = c < cols;
    const uint64_t* xc = x + bi * sb;
    if (e_group != nullptr) {  // the group maxima are given: one pass
      if (live) {
        const int32_t b0 = base_of(e_group[bi * cols + c]);
        const int32_t b1 = c + 1 < cols ? base_of(e_group[bi * cols + c + 1]) : 0;
#pragma unroll 4
        for (int64_t r = ty; r < rows; r += rstep) {
          const Pair v = load_pair(xc + r * sr, c, cols, l16);
          sums.add(required(b0, code(v.x)), required(b1, code(v.y)));
        }
      }
      continue;
    }
    uint32_t e0 = 0, e1 = 0;
    if (live) {
      int i = 0;
#pragma unroll 4
      for (int64_t r = ty; r < rows; r += rstep, ++i) {
        const Pair v = load_pair(xc + r * sr, c, cols, l16);
        e0 = max(e0, field(v.x));
        e1 = max(e1, field(v.y));
        if (i < staged) stage[i * THREADS + threadIdx.x] = pack(v);
      }
    }
    // the lanes of a warp with the same tx hold the same two columns
    for (int o = tpr; o < 32; o <<= 1) {
      e0 = max(e0, __shfl_xor_sync(0xFFFFFFFFu, e0, o));
      e1 = max(e1, __shfl_xor_sync(0xFFFFFFFFu, e1, o));
    }
    if (lane < tpr) {
      col_max[parity][warp][2 * lane] = e0;
      col_max[parity][warp][2 * lane + 1] = e1;
    }
    __syncthreads();
    uint32_t eg0 = 0, eg1 = 0;
    for (int w = 0; w < WARPS; ++w) {
      eg0 = max(eg0, col_max[parity][w][2 * tx]);
      eg1 = max(eg1, col_max[parity][w][2 * tx + 1]);
    }
    parity ^= 1;
    if (live) {
      const int32_t b0 = base_of((int32_t)eg0), b1 = base_of((int32_t)eg1);
      int i = 0;
#pragma unroll 4
      for (int64_t r = ty; r < rows; r += rstep, ++i) {
        const uint32_t w = i < staged ? stage[i * THREADS + threadIdx.x]
                                      : pack(load_pair(xc + r * sr, c, cols, l16));
        sums.add(required(b0, w & 0xFFFFu), required(b1, w >> 16));
      }
    }
  }
  sums.flush(totals, part);
}

template <int B>
int launch(const uint64_t* x, const int32_t* e_group, unsigned long long* totals, int64_t batch,
           int64_t rows, int64_t cols, int64_t sb, int64_t sr, int axis, int width, int staged,
           int load16, unsigned grid, int smem, cudaStream_t s) {
  auto kernel = axis == 1 ? mantissa_loss_rows_kernel<B> : mantissa_loss_cols_kernel<B>;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<grid, THREADS, smem, s>>>(x, e_group, totals, batch, rows, cols, sb, sr, width, staged,
                                     load16);
  return (int)cudaGetLastError();
}

}  // namespace

// x: float64 [batch, rows, cols] at strides (batch_stride, row_stride, 1),
// reduced along axis (1: rows, the A operand; 0: columns, the B operand);
// e_group: null, or the int32 group maxima to use, [batch * rows] (axis 1)
// or [batch, cols] (axis 0); totals: int64 [16], zeroed here first where
// `zero` is set, then added to.  `width` is the warps of a row (axis 1;
// the columns kernel's strips are STRIP wide).
extern "C" int oz_mantissa_loss(const void* x, const void* e_group, void* totals, int zero,
                                int64_t batch, int64_t rows, int64_t cols, int64_t batch_stride,
                                int64_t row_stride, int axis, int b, int width, int staged,
                                int load16, int64_t grid, int smem, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  if (zero) {
    const cudaError_t err = cudaMemsetAsync(totals, 0, CANDIDATES * sizeof(int64_t), s);
    if (err != cudaSuccess) return (int)err;
  }
  if (grid <= 0) return (int)cudaGetLastError();  // an empty operand adds nothing
  const uint64_t* xp = (const uint64_t*)x;
  const int32_t* ep = (const int32_t*)e_group;
  unsigned long long* tp = (unsigned long long*)totals;
  const unsigned g = (unsigned)grid;
#define OZ_ML_LAUNCH(B)                                                                        \
  case B:                                                                                      \
    return launch<B>(xp, ep, tp, batch, rows, cols, batch_stride, row_stride, axis, width,     \
                     staged, load16, g, smem, s)
  switch (b) {
    OZ_ML_LAUNCH(0);
    OZ_ML_LAUNCH(1);
    OZ_ML_LAUNCH(2);
    OZ_ML_LAUNCH(3);
    OZ_ML_LAUNCH(4);
    OZ_ML_LAUNCH(5);
    OZ_ML_LAUNCH(6);
    OZ_ML_LAUNCH(7);
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef OZ_ML_LAUNCH
}
