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
// What bounds it on an H100: device memory.  Each element is 8 bytes in
// and ns bytes out, a few dozen integer operations in between, so the
// kernel is far below the card's compute-to-bandwidth ratio.  The design
// follows from that: one thread per element, grid-stride, neighbouring
// threads on neighbouring columns so that the 8-byte reads and each
// plane's 1-byte writes are coalesced; all ns planes are written in one
// pass, so the operand is read once (the plain version reads it once per
// plane).  The 128-bit shift runs on two uint64 words; every shift count
// that could reach 64 is a branch, never a C shift (undefined behaviour).
//
// A batch (the TPU kernel under jax.vmap, one call with a leading grid
// axis) is one launch over the contiguous [batch, rows, cols] operand, and
// a 2-D call is its batch-1 case.  Rows' exponents (axis = 1, the A
// operand) are int32 [batch * rows], the batch being only more rows;
// columns' exponents (axis = 0, the B operand) are int32 [batch, cols], one
// row of them per matrix.  The planes are int8 [ns, batch, rows, cols].
// Every flattened index is 64-bit.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__global__ void split_digits_kernel(const uint64_t* __restrict__ x,
                                    const int32_t* __restrict__ e_max,
                                    int8_t* __restrict__ out, int64_t batch,
                                    int64_t rows, int64_t cols, int num_split,
                                    int b, int axis) {
  const int64_t plane = rows * cols;  // one matrix
  const int64_t total = batch * plane;
  const uint64_t mask = (1ull << b) - 1ull;
  for (int64_t idx = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
       idx < total; idx += (int64_t)gridDim.x * blockDim.x) {
    const uint64_t bits = x[idx];
    const int e = (int)((bits >> 52) & 0x7FFull);
    uint64_t m53 = bits & ((1ull << 52) - 1ull);
    if (e > 0) m53 |= 1ull << 52;
    const int neg = (int)(bits >> 63);
    int er;
    if (axis == 1) {
      er = e_max[idx / cols];
    } else {
      const int64_t col = idx % cols;
      er = e_max[batch == 1 ? col : (idx / plane) * cols + col];
    }
    int u = er > 0 ? er + 1 - e : 159;
    // u < 0 only for an e_max below the element's own exponent; the TPU
    // kernel's unsigned shift flushes that to zero digits, and so does this
    if (u < 0 || u > 159) u = 159;

    // t = (m53 << 75) >> u as two words (hi:lo); m53 << 75 is (m53 << 11):0
    uint64_t hi = m53 << 11, lo = 0;
    if (u >= 128) {
      hi = 0;
      lo = 0;
    } else if (u >= 64) {
      lo = u == 64 ? hi : hi >> (u - 64);
      hi = 0;
    } else if (u > 0) {
      lo = hi << (64 - u);
      hi = hi >> u;
    }

    for (int p = 0; p < num_split; ++p) {
      const int q = 128 - (p + 1) * b;  // window LSB position, in [2, 121]
      uint64_t win;
      if (q >= 64) {
        win = hi >> (q - 64);
      } else if (q + b <= 64) {
        win = lo >> q;
      } else {
        win = (lo >> q) | (hi << (64 - q));
      }
      const int d = (int)(win & mask);
      out[p * total + idx] = (int8_t)(neg ? -d : d);
    }
  }
}

}  // namespace

// x: float64 [batch, rows, cols], contiguous; e_max: int32 [batch * rows]
// (axis = 1) or [batch, cols] (axis = 0); out: int8 [ns, batch, rows, cols].
extern "C" int oz_split_digits(const void* x, const void* e_max, void* out,
                               int64_t batch, int64_t rows, int64_t cols,
                               int num_split, int b, int axis, void* stream) {
  const int threads = 256;
  const int64_t total = batch * rows * cols;
  int64_t blocks = (total + threads - 1) / threads;
  if (blocks > 132 * 64) blocks = 132 * 64;  // grid-stride beyond this
  split_digits_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const uint64_t*)x, (const int32_t*)e_max, (int8_t*)out, batch, rows,
      cols, num_split, b, axis);
  return (int)cudaGetLastError();
}

extern "C" const char* oz_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
