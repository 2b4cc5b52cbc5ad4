// exponent_max: the int32 max of the biased exponent field of float64
// elements along the contraction axis, per row (axis = 1, the A operand)
// or per column (axis = 0, the B operand) of each matrix of a batch.
//
// Replaces ozimmu_tpu/ops/split.py:42 row_exponent (plain XLA in the JAX
// package: jnp.max(exponent_field(x), axis)) and computes the same value
// as the plain PyTorch version ozimmu_tpu_torch/ops/split.py::row_exponent_plain
// (torch.amax of the field, which takes four full passes over the operand:
// shift, mask, cast, max).
//
// What bounds it on an H100: device memory, 8 bytes read per element and
// next to nothing written.  So each element is read once, with 16-byte
// loads where the rows are 16-byte aligned, and the field is taken from the
// high word with a shift and a mask:
//   * rows (exponent_rows_kernel): one warp per row, each lane striding the
//     row two elements at a time (a warp's loads are 512 contiguous bytes),
//     then a warp max (__reduce_max_sync);
//   * columns (exponent_cols_kernel): a block per strip of 64 columns
//     (32 without 16-byte loads) and slab of rows, 8 warps over the slab's
//     rows, a max over the warps in shared memory, then one integer
//     atomicMax per column into the zero-filled output.  The max is
//     order-free, so the result does not depend on the order of the
//     atomics.
// The input is read through its batch and row strides (its elements along
// a row contiguous), so a column panel is reduced where it lies.  The grid
// and the slab are chosen on the host
// (ozimmu_tpu_torch/ops/exponent_cuda.py::exponent_plan).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

__device__ __forceinline__ uint32_t field(uint64_t bits) {
  return (uint32_t)(bits >> 52) & 0x7FFu;
}

template <bool LOAD16>
__global__ void __launch_bounds__(THREADS)
exponent_rows_kernel(const uint64_t* __restrict__ x, int32_t* __restrict__ out, int64_t batch,
                     int64_t rows, int64_t cols, int64_t sb, int64_t sr) {
  const int lane = threadIdx.x & 31;
  const int64_t n_rows = batch * rows;
  const int64_t warps = (int64_t)gridDim.x * WARPS;
  for (int64_t g = ((int64_t)blockIdx.x * THREADS + threadIdx.x) >> 5; g < n_rows; g += warps) {
    const int64_t bi = g / rows;
    const uint64_t* xr = x + bi * sb + (g - bi * rows) * sr;
    uint32_t e = 0;
    if constexpr (LOAD16) {
      int64_t c = 2 * lane;
#pragma unroll 4
      for (; c + 1 < cols; c += 64) {
        const ulonglong2 v = *reinterpret_cast<const ulonglong2*>(xr + c);
        e = max(e, max(field(v.x), field(v.y)));
      }
      if (c < cols) e = max(e, field(xr[c]));
    } else {
#pragma unroll 4
      for (int64_t c = lane; c < cols; c += 32) e = max(e, field(xr[c]));
    }
    e = __reduce_max_sync(0xFFFFFFFFu, e);
    if (lane == 0) out[g] = (int32_t)e;
  }
}

template <bool LOAD16>
__global__ void __launch_bounds__(THREADS)
exponent_cols_kernel(const uint64_t* __restrict__ x, int32_t* __restrict__ out, int64_t batch,
                     int64_t rows, int64_t cols, int64_t sb, int64_t sr, int64_t slab) {
  constexpr int W = LOAD16 ? 64 : 32;  // columns of a strip
  __shared__ uint32_t part[WARPS][W];
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  const int64_t strips = (cols + W - 1) / W;
  const int64_t slabs = (rows + slab - 1) / slab;
  int64_t t = blockIdx.x;
  const int64_t s = t % strips;
  t /= strips;
  const int64_t r0 = (t % slabs) * slab;
  const int64_t bi = t / slabs;
  const int64_t r1 = min(r0 + slab, rows);
  const int64_t c = s * W + (LOAD16 ? 2 * tx : tx);
  const uint64_t* xc = x + bi * sb + c;
  uint32_t e0 = 0, e1 = 0;
  if (LOAD16 && c + 1 < cols) {
#pragma unroll 4
    for (int64_t r = r0 + ty; r < r1; r += WARPS) {
      const ulonglong2 v = *reinterpret_cast<const ulonglong2*>(xc + r * sr);
      e0 = max(e0, field(v.x));
      e1 = max(e1, field(v.y));
    }
  } else if (c < cols) {
#pragma unroll 4
    for (int64_t r = r0 + ty; r < r1; r += WARPS) e0 = max(e0, field(xc[r * sr]));
  }
  if (LOAD16) {
    part[ty][2 * tx] = e0;
    part[ty][2 * tx + 1] = e1;
  } else {
    part[ty][tx] = e0;
  }
  __syncthreads();
  if (threadIdx.x < W) {
    uint32_t e = part[0][threadIdx.x];
#pragma unroll
    for (int i = 1; i < WARPS; ++i) e = max(e, part[i][threadIdx.x]);
    const int64_t cc = s * W + threadIdx.x;
    if (cc < cols) atomicMax(reinterpret_cast<unsigned int*>(out) + bi * cols + cc, e);
  }
}

}  // namespace

// x: float64 [batch, rows, cols] at strides (batch_stride, row_stride, 1);
// out: int32 [batch * rows] (axis = 1) or [batch, cols] (axis = 0; zeroed
// here first).  The reduced length (cols, or rows) is at least 1.
extern "C" int oz_exponent_max(const void* x, void* out, int64_t batch, int64_t rows,
                               int64_t cols, int64_t batch_stride, int64_t row_stride, int axis,
                               int load16, int64_t grid, int64_t slab, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const uint64_t* xp = (const uint64_t*)x;
  int32_t* op = (int32_t*)out;
  if (axis == 1) {
    auto kernel = load16 ? exponent_rows_kernel<true> : exponent_rows_kernel<false>;
    kernel<<<(unsigned)grid, THREADS, 0, s>>>(xp, op, batch, rows, cols, batch_stride, row_stride);
  } else {
    const cudaError_t err = cudaMemsetAsync(out, 0, (size_t)(batch * cols) * sizeof(int32_t), s);
    if (err != cudaSuccess) return (int)err;
    auto kernel = load16 ? exponent_cols_kernel<true> : exponent_cols_kernel<false>;
    kernel<<<(unsigned)grid, THREADS, 0, s>>>(xp, op, batch, rows, cols, batch_stride,
                                              row_stride, slab);
  }
  return (int)cudaGetLastError();
}
