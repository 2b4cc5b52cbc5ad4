// recombine: every scheduled slice-pair int8 product, int32 totals per
// equal-weight group, folded into a triple-float32 accumulator.
//
// Replaces the TPU kernel ozimmu_tpu/ops/recombine_pallas.py:182
// (recombine_pallas, body _make_kernel) and computes the same three f32
// planes, bit for bit, as the plain PyTorch version
// ozimmu_tpu_torch/ops/recombine.py::group_totals + fold_group_totals.
//
// For each group of group_schedule(ns, k_true, b), in ascending order, the
// kernel forms the exact int32 sum of da[i-1] @ db[j-1] over the group's
// pairs, splits it into hi16 and lo16, and folds the two exact f32 terms
// hi * 2^(w+16) and lo * 2^w into the triple with add_term; a final renorm
// gives the three output planes (scaled by 2^ACC_SHIFT).
//
// Why the result is bitwise equal to the plain version:
//   * a group's int32 total is exact whatever the summation order: the
//     schedule's cap bounds the sum of magnitudes over the full k
//     (ozimmu_tpu_torch/schedule.py::max_safe_pairs_per_group);
//   * the fold runs in exactly fold_group_totals' order, with
//     round-to-nearest intrinsics and no contraction (also built with
//     --fmad=false), so every f32 operation matches.
//
// What bounds it on an H100: int8 arithmetic, ns(ns+1)/2 * 2*m*n*k
// operations, and the bytes that feed it: every pair streams its two
// digit planes through shared memory once per output tile.  This version
// runs on the int8 tensor cores through the warp-level
// mma.sync.m16n8k32 (s8 x s8 -> s32); wgmma with TMA-fed, deeper
// pipelines is the next step.  The design keeps what the TPU kernel kept
// out of device memory out of it: the groups are the OUTER loop and each
// group's int32 tile lives in registers until it is folded, so one int32
// tile and one triple are live per thread and no partial product touches
// device memory.
// Block: a 64x64 output tile, 4 warps of 32x32 (2 x 4 mma tiles of 16x8),
// registers capped so that three blocks share an SM (the unaligned-k path
// ran 1.7x faster so; the aligned path already fit).
// Both operands arrive k-contiguous (A as [ns, m, k], B transposed by the
// wrapper to [ns, n, k]), so every mma fragment is one aligned 32-bit
// shared-memory word and every tile row is copied in 16-byte chunks.  The
// 64-deep k tiles of all (pair, k) steps of the schedule form one sequence
// that is double-buffered in shared memory: cp.async copies step s+1 while
// the tensor cores work on step s (when k % 16 == 0; otherwise plain
// loads fill the next buffer, still ahead of the barrier).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxPairs = 171;   // ns = 18: 18 * 19 / 2
constexpr int kMaxGroups = 171;  // at most one group per pair
constexpr int BM = 64, BN = 64, BK = 64;
constexpr int LDS = BK + 16;  // row stride of the shared tiles, bytes
constexpr int kThreads = 128;

// The schedule travels by value, as a kernel parameter: it is a few
// hundred bytes, read uniformly by every thread.
struct Schedule {
  int n_groups;
  uint16_t start[kMaxGroups + 1];  // group g has pairs [start[g], start[g+1])
  uint8_t pi[kMaxPairs];           // 0-based A plane of each pair
  uint8_t pj[kMaxPairs];           // 0-based B plane of each pair
  float scale_hi[kMaxGroups];      // 2^(w+16)
  float scale_lo[kMaxGroups];      // 2^w
};

__device__ __forceinline__ void two_sum(float a, float b, float& s, float& e) {
  s = __fadd_rn(a, b);
  const float bb = __fsub_rn(s, a);
  e = __fadd_rn(__fsub_rn(a, __fsub_rn(s, bb)), __fsub_rn(b, bb));
}

__device__ __forceinline__ void quick_two_sum(float a, float b, float& s,
                                              float& e) {
  s = __fadd_rn(a, b);
  e = __fsub_rn(b, __fsub_rn(s, a));
}

// ops/tf32x3.py::add_term
__device__ __forceinline__ void add_term(float& t0, float& t1, float& t2,
                                         float x) {
  float s0, e0, s1, e1;
  two_sum(t0, x, s0, e0);
  two_sum(t1, e0, s1, e1);
  t0 = s0;
  t1 = s1;
  t2 = __fadd_rn(t2, e1);
}

// ops/tf32x3.py::renorm
__device__ __forceinline__ void renorm(float& t0, float& t1, float& t2) {
  float s, e2, s0, e1, s1, s2;
  quick_two_sum(t1, t2, s, e2);
  quick_two_sum(t0, s, s0, e1);
  quick_two_sum(e1, e2, s1, s2);
  quick_two_sum(s0, s1, t0, t1);
  t2 = s2;
}

__device__ __forceinline__ int lds32(const int8_t* p) {
  return *reinterpret_cast<const int*>(p);
}

// d += a (16x32, row-major fragment) * b (32x8, column-major fragment)
__device__ __forceinline__ void mma_s8(int (&d)[4], const int (&a)[4],
                                       const int (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// One 64-row x BK-byte tile of a k-contiguous [rows, k] int8 plane into
// shared memory (row stride LDS), zero outside the plane.  Thread tid
// copies the 16-byte chunks tid and tid + kThreads.  VEC (k % 16 == 0 and
// 16-byte aligned planes): asynchronous cp.async copies, zero-filled at
// the edge; otherwise plain byte loads.
template <bool VEC>
__device__ __forceinline__ void load_tile(int8_t* __restrict__ dst,
                                          const int8_t* __restrict__ plane,
                                          int row0, int rows, int k0, int k,
                                          int tid) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int c = tid + h * kThreads;
    const int r = c >> 2, col = (c & 3) * 16;
    const int grow = row0 + r, gcol = k0 + col;
    int8_t* d = dst + r * LDS + col;
    const int8_t* src = plane + (int64_t)grow * k + gcol;
    if (VEC) {
      const bool in = grow < rows && gcol < k;
      const unsigned saddr = (unsigned)__cvta_generic_to_shared(d);
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(saddr),
                   "l"(in ? src : plane), "r"(in ? 16 : 0));
    } else {
      union {
        int4 v;
        int8_t b[16];
      } u;
#pragma unroll
      for (int x = 0; x < 16; ++x)
        u.b[x] = grow < rows && gcol + x < k ? src[x] : 0;
      *reinterpret_cast<int4*>(d) = u.v;
    }
  }
}

template <bool VEC>
__global__ void __launch_bounds__(kThreads, 3)
    recombine_kernel(const int8_t* __restrict__ da,
                     const int8_t* __restrict__ dbt, float* __restrict__ o0,
                     float* __restrict__ o1, float* __restrict__ o2, int m,
                     int n, int k, const Schedule sch) {
  // two stages of (A tile, B tile), each 64 rows of LDS bytes
  __shared__ __align__(16) int8_t smem[2][2][BM * LDS];

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;  // mma fragment coordinates
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int64_t plane_a = (int64_t)m * k, plane_b = (int64_t)n * k;
  const int k_tiles = (k + BK - 1) / BK;
  const int steps = sch.start[sch.n_groups] * k_tiles;

  // element e = (mi * 4 + ni) * 4 + r of this thread's 32 outputs sits at
  // row wm + mi*16 + g + 8*(r >> 1), column wn + ni*8 + 2*t + (r & 1)
  float t0[32], t1[32], t2[32];
  int acc[2][4][4];
#pragma unroll
  for (int e = 0; e < 32; ++e) t0[e] = t1[e] = t2[e] = 0.0f;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[mi][ni][r] = 0;

  // step s = (pair s / k_tiles, k tile s % k_tiles), in schedule order
  auto issue = [&](int s) {
    const int p = s / k_tiles, k0 = (s - p * k_tiles) * BK;
    load_tile<VEC>(smem[s & 1][0], da + sch.pi[p] * plane_a, m0, m, k0, k, tid);
    load_tile<VEC>(smem[s & 1][1], dbt + sch.pj[p] * plane_b, n0, n, k0, k, tid);
    if (VEC) asm volatile("cp.async.commit_group;\n" ::);
  };

  issue(0);
  int gi = 0;  // group of the current step
  for (int s = 0; s < steps; ++s) {
    if (s + 1 < steps) {
      issue(s + 1);
      if (VEC) asm volatile("cp.async.wait_group 1;\n" ::);
    } else if (VEC) {
      asm volatile("cp.async.wait_group 0;\n" ::);
    }
    __syncthreads();

    const int8_t* As = smem[s & 1][0];
    const int8_t* Bs = smem[s & 1][1];
#pragma unroll
    for (int ks = 0; ks < BK; ks += 32) {
      int af[2][4], bf[4][2];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const int8_t* r0 = As + (wm + mi * 16 + g) * LDS + ks + t * 4;
        af[mi][0] = lds32(r0);
        af[mi][1] = lds32(r0 + 8 * LDS);
        af[mi][2] = lds32(r0 + 16);
        af[mi][3] = lds32(r0 + 8 * LDS + 16);
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int8_t* c0 = Bs + (wn + ni * 8 + g) * LDS + ks + t * 4;
        bf[ni][0] = lds32(c0);
        bf[ni][1] = lds32(c0 + 16);
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_s8(acc[mi][ni], af[mi], bf[ni]);
    }
    __syncthreads();  // the buffer of step s is refilled by step s + 2

    if (s + 1 == sch.start[gi + 1] * k_tiles) {
      // the group's total is complete: fold it (ops/recombine.py
      // fold_group_totals: hi term, then lo term) and start the next
      const float shi = sch.scale_hi[gi], slo = sch.scale_lo[gi];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int e = (mi * 4 + ni) * 4 + r;
            const int d = acc[mi][ni][r];
            const int hi = d >> 16;     // arithmetic: [-2^15, 2^15)
            const int lo = d & 0xFFFF;  // == d - hi * 2^16, in [0, 2^16)
            add_term(t0[e], t1[e], t2[e], __fmul_rn(__int2float_rn(hi), shi));
            add_term(t0[e], t1[e], t2[e], __fmul_rn(__int2float_rn(lo), slo));
            acc[mi][ni][r] = 0;
          }
      ++gi;
    }
  }

#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int e = (mi * 4 + ni) * 4 + r;
        const int row = m0 + wm + mi * 16 + g + 8 * (r >> 1);
        const int col = n0 + wn + ni * 8 + 2 * t + (r & 1);
        renorm(t0[e], t1[e], t2[e]);
        if (row < m && col < n) {
          const int64_t o = (int64_t)row * n + col;
          o0[o] = t0[e];
          o1[o] = t1[e];
          o2[o] = t2[e];
        }
      }
}

}  // namespace

// da: [ns, m, k]; dbt: B's planes transposed to [ns, n, k].
// group_start: n_groups + 1 pair offsets; pair_i / pair_j: 0-based planes
// of each pair; scale_hi / scale_lo: the two f32 factors of each group.
// All five are host arrays; returns a cudaError_t code (0 = launched).
extern "C" int oz_recombine(const void* da, const void* dbt, void* o0,
                            void* o1, void* o2, int m, int n, int k,
                            int n_groups, const int32_t* group_start,
                            const int32_t* pair_i, const int32_t* pair_j,
                            const float* scale_hi, const float* scale_lo,
                            void* stream) {
  if (n_groups < 1 || n_groups > kMaxGroups ||
      group_start[n_groups] > kMaxPairs || k < 1)
    return (int)cudaErrorInvalidValue;
  Schedule sch;
  sch.n_groups = n_groups;
  for (int g = 0; g <= n_groups; ++g) sch.start[g] = (uint16_t)group_start[g];
  for (int p = 0; p < group_start[n_groups]; ++p) {
    sch.pi[p] = (uint8_t)pair_i[p];
    sch.pj[p] = (uint8_t)pair_j[p];
  }
  for (int g = 0; g < n_groups; ++g) {
    sch.scale_hi[g] = scale_hi[g];
    sch.scale_lo[g] = scale_lo[g];
  }
  const bool vec = k % 16 == 0 && (uintptr_t)da % 16 == 0 && (uintptr_t)dbt % 16 == 0;
  const dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM);
  cudaStream_t s = (cudaStream_t)stream;
  const int8_t* a = (const int8_t*)da;
  const int8_t* b = (const int8_t*)dbt;
  float *p0 = (float*)o0, *p1 = (float*)o1, *p2 = (float*)o2;
  if (vec)
    recombine_kernel<true><<<grid, kThreads, 0, s>>>(a, b, p0, p1, p2, m, n, k, sch);
  else
    recombine_kernel<false><<<grid, kThreads, 0, s>>>(a, b, p0, p1, p2, m, n, k, sch);
  return (int)cudaGetLastError();
}
