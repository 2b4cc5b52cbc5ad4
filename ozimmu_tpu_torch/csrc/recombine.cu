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
//     --fmad=false), so every f32 operation matches; a triple parked in
//     the output planes between two groups is stored and reloaded exactly.
//
// What bounds it on an H100: int8 arithmetic, ns(ns+1)/2 * 2*m*n*k
// operations, and the bytes that feed them from L2: every (pair, k-tile)
// step streams one A and one B tile into shared memory.  The design:
//   * wgmma.mma_async m64nNk32 s8 x s8 -> s32, both operands from shared
//     memory, K-major (the only layout wgmma takes for 8-bit types: A's
//     planes are [ns, m, k], B's are transposed by the wrapper to
//     [ns, n, k]);
//   * a ring of STAGES shared-memory stages filled by TMA
//     (cp.async.bulk.tensor.3d over (k, rows, plane), 128-byte swizzle,
//     BK = 128 bytes of k per stage), with a full and an empty mbarrier per
//     stage; one producer thread walks the same flat (pair, k-tile) step
//     sequence as the consumers, choosing the plane of each pair by the
//     third tensor-map coordinate;
//   * warp specialisation: one producer warpgroup (its registers given up
//     through setmaxnreg) and NC consumer warpgroups, each owning 64 rows
//     of the block tile and keeping one wgmma group in flight;
//   * in the large classes only the int32 group accumulator lives in
//     registers (BN/2 a thread); the triple lives in the output planes
//     o0/o1/o2 and is read, updated and written back at each group end
//     (the first group writes without reading, the last ends with
//     renorm), while the producer keeps filling the ring;
//   * in the kept class (MODE == kKeep) each consumer thread also keeps
//     the triple of its BN/2 output elements in registers across all of
//     the tile's groups (4 registers an element: the int32 total and
//     three f32), folds each group into it with the same steps in the
//     same order, and stores the three planes once, after the last
//     group's renorm: o0/o1/o2 are never read.  The round trip of the
//     parked triple (12 B + 24 B at each later group end, an element)
//     costs as much as the int8 work itself at k = 1024, and nothing at
//     k = 16384;
//   * a persistent grid: one block per SM walking the output tiles in
//     bands of kGroupM cluster tile rows, so that the tiles in flight
//     share A row panels and B column panels in L2;
//   * at long k over many waves of units, the bounded-skew walk (MODE |
//     kWalk, class 0 only, where ops/recombine_cuda.py::launch_plan
//     engages it): the tiles in flight share their panels in L2 only while
//     their clusters stay near the same (pair, k-tile) step, and nothing
//     else keeps them there over the 62 waves of 5760 steps of 16384^3 at
//     ns = 9.  Free, the pack of clusters there runs at one of two paces,
//     launch by launch: 306-320 ms or 400-520 ms (an H100 at its cap,
//     PERF.md §6).  So each cluster's producer publishes the steps it has
//     issued, and issues none more than `window` steps ahead of the
//     slowest cluster still working (struct Walk below); launches then
//     take 316-353 ms.  The window (lockstep_window) is three times the
//     steps whose distinct tiles fill the L2: an empirical multiple fitted
//     on the card, not one the L2-reuse model gives, which would keep it
//     under one L2 of steps (a third of one lost there).  Only the producer waits: the consumers, the ring, the
//     multicast, the fold and the order of every operation are those of
//     the free walk, so the bits are the same;
//   * tile classes, chosen by the launch plan in ops/recombine_cuda.py:
//     128x256 (two consumer warpgroups) for large products at long k, in
//     clusters of two blocks that take vertically adjacent tiles and
//     share one B tile by TMA multicast (a third less L2 traffic; 10-30 %
//     faster at 8192^3 on an H100 held at its power cap, PERF.md); 64x128
//     (one consumer warpgroup, no cluster) when the large tile would leave
//     most SMs idle; and the kept class, 128x96 (two consumer warpgroups of
//     m64n96k32, 48 accumulators and 144 triple registers a thread) at
//     short k, in clusters of 2x2 blocks: the two stacked along m share
//     their B tile and the two side by side along n their A tile, each
//     block loading half of each by multicast, so that its L2 bytes per
//     int8 operation stay near the large class's despite the smaller
//     tile.
// The wrapper zero-pads k to a multiple of 16 (TMA's stride rule); zero
// digits add zero products, and TMA fills the rest of the last k tile and
// the rows beyond m or n with zeros.
//
// The totals mode (MODE == kTotals; oz_recombine_totals) is the same kernel
// with the fold left out: at each group's end the int32 accumulator goes
// to an int32 totals tensor [G, batch, m, n], stored (the first k panel of
// a streamed product) or added to what is there (the later panels: exact,
// the schedule's cap bounds the whole contraction).  The ring, stream and
// k-sharded variants of ozimmu_tpu_torch/parallel/ sum their totals over
// k panels (or reduce-scatter them across ranks) before one fold, so they
// take this mode, then totals_fold_kernel below; its plain version is
// group_totals summed, then fold_group_totals.  The group schedule comes
// from the global k, the k tiles from the panel's own k_pad.
//
// A batch (the TPU kernel under jax.vmap, one call with a leading grid
// axis) is one launch, and a 2-D call is its batch-1 case.  The planes are
// [ns, batch, rows, k_pad]; the tensor maps see them as [ns * batch] planes
// of [rows, k_pad], plane p of matrix i being plane p * batch + i, so that
// every matrix keeps its own row bound and TMA's zero fill beyond m (or n)
// applies per matrix: no tile reads a neighbouring matrix's rows.  The
// persistent walk covers batch x units_m x tiles_n units, matrix by
// matrix, its bands of kGroupM inside one matrix; a cluster's stacked
// tiles belong to one matrix.  The output planes are [batch, m, n], each
// matrix at a 64-bit offset.

#include <climits>
#include <cstdint>
#include <cuda.h>  // CUtensorMap and the encoder's types; libcuda is reached at run time
#include <cuda_runtime.h>

namespace {

constexpr int kMaxPairs = 171;   // ns = 18: 18 * 19 / 2
constexpr int kMaxGroups = 171;  // at most one group per pair
constexpr int BK = 128;          // k bytes per stage: one 128-byte swizzle row
constexpr int kGroupM = 8;       // cluster tile rows per band of the persistent order

// what the kernel does with a finished group total: fold it into the
// triple parked in the output planes, write it as int32 totals, or fold
// it into the triple kept in registers (MODE & kWhat); kWalk added: the
// bounded-skew walk, with either of the first two
enum Mode { kFold = 0, kTotals = 1, kKeep = 2, kWhat = 3, kWalk = 4 };

// Blocks of a cluster side by side along n, sharing their A tile: two in
// the kept class, whose narrow tile would otherwise stream twice the A
// bytes per operation of the large class; one (no sharing) otherwise.
__host__ __device__ constexpr int cluster_cols(int mode) { return (mode & kWhat) == kKeep ? 2 : 1; }

// The schedule travels by value, as a kernel parameter: about 2 KB, read
// uniformly by every thread.
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

// One group's exact int32 total v folded into the triple: its hi16 and
// lo16 halves as the exact f32 terms hi * 2^(w+16) and lo * 2^w, in that
// order (ops/recombine.py fold_group_totals, one group)
__device__ __forceinline__ void fold_total(int v, float& t0, float& t1, float& t2, float shi,
                                           float slo) {
  const int hi = v >> 16;     // arithmetic: [-2^15, 2^15)
  const int lo = v & 0xFFFF;  // == v - hi * 2^16, in [0, 2^16)
  add_term(t0, t1, t2, __fmul_rn(__int2float_rn(hi), shi));
  add_term(t0, t1, t2, __fmul_rn(__int2float_rn(lo), slo));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

// one box of a 3-D tensor map (k, row, plane) into shared memory,
// completing `bytes` on the mbarrier `bar`
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int k0, int row0,
                                         int plane) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(k0), "r"(row0), "r"(plane)
      : "memory");
}

// the same, written into the shared memory of every CTA of the cluster in
// `mask`, completing on the mbarrier at `bar`'s offset in each of them
__device__ __forceinline__ void tma_load_multicast(uint32_t dst, const CUtensorMap* map,
                                                   uint32_t bar, int k0, int row0,
                                                   int plane, uint16_t mask) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".multicast::cluster [%0], [%1, {%3, %4, %5}], [%2], %6;\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(k0), "r"(row0), "r"(plane),
      "h"(mask)
      : "memory");
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// arrive on the mbarrier at `bar`'s offset in the cluster's CTA `cta`
__device__ __forceinline__ void mbar_arrive_cluster(uint32_t bar, uint32_t cta) {
  asm volatile(
      "{\n.reg .b32 remote;\n"
      "mapa.shared::cluster.u32 remote, %0, %1;\n"
      "mbarrier.arrive.shared::cluster.b64 _, [remote];\n}\n" ::"r"(bar),
      "r"(cta)
      : "memory");
}

__device__ __forceinline__ int ld_relaxed(const int* p) {
  int v;
  asm volatile("ld.relaxed.gpu.global.b32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_relaxed(int* p, int v) {
  asm volatile("st.relaxed.gpu.global.b32 [%0], %1;\n" ::"l"(p), "r"(v) : "memory");
}

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

// The bounded-skew walk, run by the whole producer warp of each cluster's
// first block (the other blocks' producers follow it through the ring's
// barriers, never more than a ring ahead).  progress: the times a producer
// had to wait, the times one gave up waiting, then one slot a cluster: the
// steps its producer has issued, stored after each (relaxed: the slots
// order no data, they only pace the loads).  Before a step the producer
// compares its steps with the slowest cluster's as last read.  Only a
// whole window ahead does it read every slot again (one slot a lane, one
// round trip: about a step's time, hidden behind the ring's other
// stages); if it is still a window ahead, it waits until it is no more
// than window - slack ahead, so that its next `slack` steps go out with
// no read of the slots (a read at every step would cost more than the
// step itself).  A cluster out of units stores a count 2^30 ahead, which
// holds nobody back (counts compare as 32-bit differences, so they may
// wrap).  Every cluster is resident (the launch
// checks), so a wait ends; should it last kWaitNs all the same (another
// grid holding SMs), the producer stops waiting for the rest of the
// launch: the pace, never the result, depends on the walk.
struct Walk {
  static constexpr uint64_t kWaitNs = 10000000;  // 10 ms: about 10^4 steps
  static constexpr uint32_t kDone = 1u << 30;
  int* count;  // [0] waits, [1] releases
  int* slots;
  int clusters, window, slack;
  uint32_t step = 0, lo = 0;  // steps issued; the slowest cluster's, as last read
  bool leader;                // the producer warp of the cluster's first block

  __device__ Walk(int* progress, int n_clusters, int w, bool first)
      : count(progress), slots(progress + 2), clusters(n_clusters), window(w),
        slack(max(1, w / 4)), leader(first) {}

  // the most steps this cluster is ahead of any cluster (warp-collective)
  __device__ __forceinline__ int lead(int lane) const {
    int most = INT_MIN;
    for (int c0 = 0; c0 < clusters; c0 += 4 * 32) {
      int v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = c0 + 32 * j + lane;
        v[j] = c < clusters ? (int)(step - (uint32_t)ld_relaxed(slots + c)) : INT_MIN;
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) most = max(most, v[j]);
    }
    return __reduce_max_sync(0xffffffffu, most);
  }

  __device__ __forceinline__ void before_step(int lane) {
    if (!leader || (int)(step - lo) < window) return;
    lo = step - (uint32_t)lead(lane);
    if ((int)(step - lo) < window) return;
    if (lane == 0) atomicAdd(count, 1);
    const uint64_t t0 = global_ns();
    do {
      __nanosleep(256);
      lo = step - (uint32_t)lead(lane);
      if ((int)(step - lo) <= window - slack) return;
    } while (__shfl_sync(0xffffffffu, (int)(global_ns() - t0 < kWaitNs), 0));
    if (lane == 0) atomicAdd(count + 1, 1);
    window = INT_MAX;
  }

  __device__ __forceinline__ void after_step(int cluster, int lane) {
    ++step;
    if (leader && lane == 0) st_relaxed(slots + cluster, (int)step);
  }

  __device__ __forceinline__ void done(int cluster, int lane) {
    if (leader && lane == 0) st_relaxed(slots + cluster, (int)(step + kDone));
  }
};

// wgmma descriptor of a K-major tile of 128-byte rows, 128-byte swizzle:
// 8-row core groups 1024 bytes apart (stride byte offset), leading byte
// offset unused (1), layout type 1 = SWIZZLE_128B.  The tile base is
// 1024-byte aligned; each k32 step adds 32 bytes to the start address.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t saddr) {
  return (uint64_t)((saddr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of the accumulators
// across the asynchronous wgmma issue and wait points.
template <int R>
__device__ __forceinline__ void fence_regs(int (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

#define OZ_D8(i)                                                            \
  "+r"(d[i]), "+r"(d[i + 1]), "+r"(d[i + 2]), "+r"(d[i + 3]), "+r"(d[i + 4]), \
      "+r"(d[i + 5]), "+r"(d[i + 6]), "+r"(d[i + 7])
#define OZ_D32(i) OZ_D8(i), OZ_D8(i + 8), OZ_D8(i + 16), OZ_D8(i + 24)

// d (64 x BN s32 over the warpgroup) = A (64 x 32 s8) * B (32 x BN s8)
// [+ d when `accumulate`]
template <int BN>
struct Wgmma;

template <>
struct Wgmma<256> {
  __device__ __forceinline__ static void run(int (&d)[128], uint64_t a, uint64_t b,
                                             int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
        "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
        "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
        "%58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
        "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, "
        "%86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, "
        "%100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
        "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, "
        "%124, %125, %126, %127}, "
        "%128, %129, p;\n}\n"
        : OZ_D32(0), OZ_D32(32), OZ_D32(64), OZ_D32(96)
        : "l"(a), "l"(b), "r"(accumulate));
  }
};

template <>
struct Wgmma<128> {
  __device__ __forceinline__ static void run(int (&d)[64], uint64_t a, uint64_t b,
                                             int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
        "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
        "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
        "%58, %59, %60, %61, %62, %63}, "
        "%64, %65, p;\n}\n"
        : OZ_D32(0), OZ_D32(32)
        : "l"(a), "l"(b), "r"(accumulate));
  }
};

template <>
struct Wgmma<96> {
  __device__ __forceinline__ static void run(int (&d)[48], uint64_t a, uint64_t b,
                                             int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %50, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n96k32.s32.s8.s8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
        "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
        "%44, %45, %46, %47}, "
        "%48, %49, p;\n}\n"
        : OZ_D32(0), OZ_D8(32), OZ_D8(40)
        : "l"(a), "l"(b), "r"(accumulate));
  }
};

#undef OZ_D32
#undef OZ_D8

// Unit `t` of `batch` grids of tiles_m x tiles_n (cluster tile rows x tile
// columns) in the persistent order: matrix by matrix, bands of kGroupM
// rows inside one matrix, column-major inside a band.
__device__ __forceinline__ void tile_coords(int t, int tiles_m, int tiles_n,
                                            int& mat, int& tm, int& tn) {
  mat = t / (tiles_m * tiles_n);
  t -= mat * tiles_m * tiles_n;
  const int per_band = kGroupM * tiles_n;
  const int band = t / per_band;
  const int first = band * kGroupM;
  const int rows = min(tiles_m - first, kGroupM);
  const int r = t - band * per_band;
  tm = first + r % rows;
  tn = r / rows;
}

// Folds one finished group total into the triple parked in o0/o1/o2
// (ops/recombine.py fold_group_totals: hi term, then lo term; renorm
// after the last group).  Accumulator register r of a thread holds row
// row0 + 8 * ((r >> 1) & 1), column col0 + (r >> 2) * 8 + (r & 1).  The
// loads of kBatch elements are issued before the first of them is used.
template <int R>
__device__ __forceinline__ void fold_group(const int (&d)[R],
                                           float* __restrict__ o0,
                                           float* __restrict__ o1,
                                           float* __restrict__ o2, int row0,
                                           int col0, int m, int n, float shi,
                                           float slo, bool first, bool last) {
  constexpr int kBatch = 16;
#pragma unroll
  for (int b0 = 0; b0 < R; b0 += kBatch) {
    float t0[kBatch], t1[kBatch], t2[kBatch];
#pragma unroll
    for (int q = 0; q < kBatch; ++q) {
      const int r = b0 + q;
      const int row = row0 + 8 * ((r >> 1) & 1);
      const int col = col0 + (r >> 2) * 8 + (r & 1);
      t0[q] = t1[q] = t2[q] = 0.0f;
      if (!first && row < m && col < n) {
        const int64_t o = (int64_t)row * n + col;
        t0[q] = o0[o];
        t1[q] = o1[o];
        t2[q] = o2[o];
      }
    }
#pragma unroll
    for (int q = 0; q < kBatch; ++q) {
      const int r = b0 + q;
      const int row = row0 + 8 * ((r >> 1) & 1);
      const int col = col0 + (r >> 2) * 8 + (r & 1);
      fold_total(d[r], t0[q], t1[q], t2[q], shi, slo);
      if (last) renorm(t0[q], t1[q], t2[q]);
      if (row < m && col < n) {
        const int64_t o = (int64_t)row * n + col;
        o0[o] = t0[q];
        o1[o] = t1[q];
        o2[o] = t2[q];
      }
    }
  }
}

// Writes one finished group total to its int32 plane t [m, n] (the
// totals mode), or with `add` adds it to what is there.  Accumulator
// registers r and r + 1 (r even) hold columns col and col + 1 of one row
// (fold_group's map); col is even, so where n is even too both go in one
// 8-byte access.  The loads of kBatch registers are issued before the
// first of them is used.
template <int R>
__device__ __forceinline__ void store_group(const int (&d)[R], int* __restrict__ t,
                                            int row0, int col0, int m, int n,
                                            bool add) {
  constexpr int kBatch = 16;
  const bool pairs = (n & 1) == 0;
#pragma unroll
  for (int b0 = 0; b0 < R; b0 += kBatch) {
    int old[kBatch];
#pragma unroll
    for (int q = 0; q < kBatch; ++q) old[q] = 0;
    if (add) {
#pragma unroll
      for (int q = 0; q < kBatch; q += 2) {
        const int r = b0 + q;
        const int row = row0 + 8 * ((r >> 1) & 1);
        const int col = col0 + (r >> 2) * 8;
        if (row >= m) continue;
        const int* p = t + (int64_t)row * n + col;
        if (pairs && col + 1 < n) {
          const int2 v = *reinterpret_cast<const int2*>(p);
          old[q] = v.x;
          old[q + 1] = v.y;
        } else {
          if (col < n) old[q] = p[0];
          if (col + 1 < n) old[q + 1] = p[1];
        }
      }
    }
#pragma unroll
    for (int q = 0; q < kBatch; q += 2) {
      const int r = b0 + q;
      const int row = row0 + 8 * ((r >> 1) & 1);
      const int col = col0 + (r >> 2) * 8;
      if (row >= m) continue;
      int* p = t + (int64_t)row * n + col;
      const int x = d[r] + old[q], y = d[r + 1] + old[q + 1];
      if (pairs && col + 1 < n) {
        *reinterpret_cast<int2*>(p) = make_int2(x, y);
      } else {
        if (col < n) p[0] = x;
        if (col + 1 < n) p[1] = y;
      }
    }
  }
}

// The kept class's end of a tile: renorm the triple of each element (its
// last group folded) and store it, once (fold_group's map of registers to
// elements).  Registers r and r + 1 (r even) hold columns col and col + 1
// of one row, so where n is even both go in one 8-byte store per plane.
template <int R>
__device__ __forceinline__ void store_triple(float (&t0)[R], float (&t1)[R], float (&t2)[R],
                                             float* __restrict__ o0, float* __restrict__ o1,
                                             float* __restrict__ o2, int row0, int col0, int m,
                                             int n) {
  const bool pairs = (n & 1) == 0;
#pragma unroll
  for (int r = 0; r < R; r += 2) {
    renorm(t0[r], t1[r], t2[r]);
    renorm(t0[r + 1], t1[r + 1], t2[r + 1]);
    const int row = row0 + 8 * ((r >> 1) & 1);
    const int col = col0 + (r >> 2) * 8;
    if (row >= m) continue;
    const int64_t o = (int64_t)row * n + col;
    if (pairs && col + 1 < n) {
      *reinterpret_cast<float2*>(o0 + o) = make_float2(t0[r], t0[r + 1]);
      *reinterpret_cast<float2*>(o1 + o) = make_float2(t1[r], t1[r + 1]);
      *reinterpret_cast<float2*>(o2 + o) = make_float2(t2[r], t2[r + 1]);
    } else {
      if (col < n) {
        o0[o] = t0[r];
        o1[o] = t1[r];
        o2[o] = t2[r];
      }
      if (col + 1 < n) {
        o0[o + 1] = t0[r + 1];
        o1[o + 1] = t1[r + 1];
        o2[o + 1] = t2[r + 1];
      }
    }
  }
}

template <int NC, int BN, int STAGES, int CM>
struct Tile {
  static constexpr int BM = 64 * NC;
  static constexpr int A_BYTES = BM * BK;
  static constexpr int B_BYTES = BN * BK;
  static constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
  static constexpr int THREADS = (NC + 1) * 128;
  // the ring, its 2 * STAGES mbarriers, and slack to align the ring's base
  static constexpr int SMEM_BYTES = STAGES * STAGE_BYTES + 2 * STAGES * 8 + 1024;
};

// NC consumer warpgroups (warpgroups 0 .. NC-1) and one producer
// warpgroup (NC).  k_tiles = ceil(k_pad / BK).  A cluster is CM x CN
// blocks (CN = cluster_cols(MODE)) that take the output tiles of a CM x CN
// unit: the CM blocks of one column share the B tile and the CN blocks of
// one row the A tile, each block loading 1/CM of the B tile and 1/CN of
// the A tile and multicasting it to its sharers.  MODE kFold folds into
// the triple o0/o1/o2 (tot unused); kKeep folds into the triple kept in
// registers and stores it to o0/o1/o2 once a tile; kTotals writes group g
// of matrix i to tot + (g * batch + i) * m * n (adds to it where `add`;
// o0/o1/o2 unused).  With kWalk the producers take the bounded-skew walk
// over `progress` (struct Walk) with `window`; without, both are unused.
template <int NC, int BN, int STAGES, int CM, int MODE>
__global__ void __launch_bounds__(Tile<NC, BN, STAGES, CM>::THREADS, 1)
    recombine_kernel(const __grid_constant__ CUtensorMap map_a,
                     const __grid_constant__ CUtensorMap map_b,
                     float* __restrict__ o0, float* __restrict__ o1,
                     float* __restrict__ o2, int* __restrict__ tot, int add, int m,
                     int n, int k_tiles, int batch, const Schedule sch,
                     int* __restrict__ progress, int window) {
  using T = Tile<NC, BN, STAGES, CM>;
  constexpr int WHAT = MODE & kWhat;
  constexpr bool WALK = (MODE & kWalk) != 0;
  constexpr int CN = cluster_cols(MODE);
  constexpr int CL = CM * CN;  // blocks of a cluster
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t ring = (raw + 1023) & ~1023u;  // 128-byte swizzle wants 1024
  const uint32_t full0 = ring + STAGES * T::STAGE_BYTES;
  const uint32_t empty0 = full0 + STAGES * 8;

  const int wg = threadIdx.x / 128;
  const int rank = CL > 1 ? (int)cluster_rank() : 0;
  const int rank_m = rank % CM, rank_n = rank / CM;
  // the cluster's unit of work: CM x CN tiles
  const int units_m = ((m + T::BM - 1) / T::BM + CM - 1) / CM;
  const int units_n = ((n + BN - 1) / BN + CN - 1) / CN;
  const int units = batch * units_m * units_n;
  const int unit0 = blockIdx.x / CL, units_step = gridDim.x / CL;
  const int n_pairs = sch.start[sch.n_groups];

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);        // the producer's expect_tx
      mbar_init(empty0 + 8 * s, 4 * NC * CL);  // each consumer warp of the cluster
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if constexpr (CL > 1)
    cluster_sync();
  else
    __syncthreads();

  if (wg == NC) {
    // producer: one thread keeps the ring full (in the bounded-skew walk
    // its whole warp runs the loop, to read every cluster's progress at once)
    if constexpr (NC == 2) asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    const bool issuer = threadIdx.x == NC * 128;
    if (WALK ? threadIdx.x / 32 == NC * 4 : issuer) {
      // the blocks sharing this block's A tile (its cluster row) and B tile
      // (its cluster column)
      uint16_t row_mask = 0;
      for (int j = 0; j < CN; ++j) row_mask |= (uint16_t)(1 << (rank_m + CM * j));
      const uint16_t col_mask = (uint16_t)(((1 << CM) - 1) << (CM * rank_n));
      int stage = 0;
      uint32_t phase = 0;
      [[maybe_unused]] const int lane = threadIdx.x & 31, cluster = blockIdx.x / CL;
      [[maybe_unused]] Walk walk(progress, gridDim.x / CL, window, rank == 0);
      for (int u = unit0; u < units; u += units_step) {
        int mat, um, un;
        tile_coords(u, units_m, units_n, mat, um, un);
        const int tm = um * CM + rank_m, tn = un * CN + rank_n;
        for (int p = 0; p < n_pairs; ++p) {
          const int pa = sch.pi[p] * batch + mat, pb = sch.pj[p] * batch + mat;
          for (int kt = 0; kt < k_tiles; ++kt) {
            if constexpr (WALK) walk.before_step(lane);
            mbar_wait(empty0 + 8 * stage, phase ^ 1);
            if (!WALK || issuer) {
              const uint32_t full = full0 + 8 * stage;
              const uint32_t dst = ring + stage * T::STAGE_BYTES;
              mbar_expect_tx(full, T::STAGE_BYTES);
              if constexpr (CN == 1)
                tma_load(dst, &map_a, full, kt * BK, tm * T::BM, pa);
              else
                tma_load_multicast(dst + rank_n * (T::BM / CN) * BK, &map_a, full, kt * BK,
                                   tm * T::BM + rank_n * (T::BM / CN), pa, row_mask);
              if constexpr (CM == 1)
                tma_load(dst + T::A_BYTES, &map_b, full, kt * BK, tn * BN, pb);
              else
                tma_load_multicast(dst + T::A_BYTES + rank_m * (BN / CM) * BK, &map_b, full,
                                   kt * BK, tn * BN + rank_m * (BN / CM), pb, col_mask);
            }
            if constexpr (WALK) walk.after_step(cluster, lane);
            if (++stage == STAGES) {
              stage = 0;
              phase ^= 1;
            }
          }
        }
      }
      if constexpr (WALK) walk.done(cluster, lane);
      if constexpr (CL > 1) {
        // stay until every consumer of the cluster has released every
        // stage: their arrivals land in this block's barriers
        for (int i = 0; i < STAGES; ++i) {
          mbar_wait(empty0 + 8 * stage, phase ^ 1);
          if (++stage == STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    // consumers: warpgroup wg owns rows wg*64 .. wg*64+63 of the block tile
    if constexpr (NC == 2) asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
    int d[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) d[i] = 0;
    // the kept class's triple of each accumulator register's element
    constexpr int KEPT = WHAT == kKeep ? BN / 2 : 1;
    [[maybe_unused]] float t0[KEPT], t1[KEPT], t2[KEPT];
    int stage = 0;
    uint32_t phase = 0;
    // a stage is free again once every consumer warp of the cluster is done
    auto release = [&](int s) {
      if constexpr (CL == 1) {
        if (lane == 0) mbar_arrive(empty0 + 8 * s);
      } else {
        if (lane < CL) mbar_arrive_cluster(empty0 + 8 * s, lane);
      }
    };
    for (int u = unit0; u < units; u += units_step) {
      int mat, um, un;
      tile_coords(u, units_m, units_n, mat, um, un);
      const int tm = um * CM + rank_m, tn = un * CN + rank_n;
      const int64_t out0 = (int64_t)mat * m * n;  // this matrix's output
      const int row0 = tm * T::BM + wg * 64 + warp * 16 + (lane >> 2);
      const int col0 = tn * BN + (lane & 3) * 2;
      if constexpr (WHAT == kKeep) {
#pragma unroll
        for (int i = 0; i < KEPT; ++i) t0[i] = t1[i] = t2[i] = 0.0f;
      }
      int p = 0;
      for (int g = 0; g < sch.n_groups; ++g) {
        int prev = -1;  // stage whose wgmma group may still be in flight
        bool fresh = true;
        for (; p < sch.start[g + 1]; ++p) {
          for (int kt = 0; kt < k_tiles; ++kt) {
            mbar_wait(full0 + 8 * stage, phase);
            const uint32_t a = ring + stage * T::STAGE_BYTES + wg * 64 * BK;
            const uint64_t da = sw128_desc(a);
            const uint64_t db = sw128_desc(ring + stage * T::STAGE_BYTES + T::A_BYTES);
            fence_regs(d);
            wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < BK / 32; ++kk)  // a group's first step overwrites d
              Wgmma<BN>::run(d, da + 2 * kk, db + 2 * kk, (fresh && kk == 0) ? 0 : 1);
            wgmma_commit();
            wgmma_wait<1>();  // the previous step's products are done
            if (prev >= 0) release(prev);
            prev = stage;
            fresh = false;
            if (++stage == STAGES) {
              stage = 0;
              phase ^= 1;
            }
          }
        }
        wgmma_wait<0>();
        fence_regs(d);
        release(prev);
        if constexpr (WHAT == kFold) {
          fold_group(d, o0 + out0, o1 + out0, o2 + out0, row0, col0, m, n, sch.scale_hi[g],
                     sch.scale_lo[g], g == 0, g == sch.n_groups - 1);
        } else if constexpr (WHAT == kKeep) {
          const float shi = sch.scale_hi[g], slo = sch.scale_lo[g];
#pragma unroll
          for (int i = 0; i < KEPT; ++i) fold_total(d[i], t0[i], t1[i], t2[i], shi, slo);
        } else {
          store_group(d, tot + (int64_t)g * batch * m * n + out0, row0, col0, m, n, add != 0);
        }
      }
      if constexpr (WHAT == kKeep)
        store_triple(t0, t1, t2, o0 + out0, o1 + out0, o2 + out0, row0, col0, m, n);
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, through the runtime's entry
// point query, so the library needs no link against libcuda.
EncodeTiled encoder() {
  static const EncodeTiled fn = []() -> EncodeTiled {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    return e == cudaSuccess && q == cudaDriverEntryPointSuccess ? (EncodeTiled)p : nullptr;
  }();
  return fn;
}

// Tensor map of int8 planes [planes, rows, k_pad] (k contiguous), boxes of
// BK bytes of k by box_rows rows of one plane, 128-byte swizzle, zeros
// outside each plane's rows and k.
bool plane_map(CUtensorMap* map, const void* planes, int n_planes, int rows, int k_pad,
               int box_rows) {
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)k_pad, (cuuint64_t)rows, (cuuint64_t)n_planes};
  const cuuint64_t strides[2] = {(cuuint64_t)k_pad, (cuuint64_t)rows * k_pad};
  const cuuint32_t box[3] = {(cuuint32_t)BK, (cuuint32_t)box_rows, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, const_cast<void*>(planes), dims,
                strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int NC, int BN, int STAGES, int CM, int MODE>
int launch(const void* da, const void* dbt, float* o0, float* o1, float* o2, int* tot,
           int add, int m, int n, int ns, int k_pad, int batch, const Schedule& sch,
           int grid, int smem_bytes, int* progress, int window, cudaStream_t stream) {
  using T = Tile<NC, BN, STAGES, CM>;
  constexpr int CN = cluster_cols(MODE), CL = CM * CN;
  if (smem_bytes != T::SMEM_BYTES || grid % CL != 0) return (int)cudaErrorInvalidValue;
  CUtensorMap map_a, map_b;
  if (!plane_map(&map_a, da, ns * batch, m, k_pad, T::BM / CN) ||
      !plane_map(&map_b, dbt, ns * batch, n, k_pad, BN / CM))
    return (int)cudaErrorInvalidValue;
  auto kernel = recombine_kernel<NC, BN, STAGES, CM, MODE>;
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = CL;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(T::THREADS);
  cfg.dynamicSmemBytes = smem_bytes;
  cfg.stream = stream;
  cfg.attrs = &cluster;
  cfg.numAttrs = CL > 1 ? 1 : 0;
  if (CL > 1) {
    // a persistent grid must be resident at once: no more clusters than fit
    int fit = 0;
    e = cudaOccupancyMaxActiveClusters(&fit, kernel, &cfg);
    if (e != cudaSuccess) return (int)e;
    if (fit < 1) return (int)cudaErrorInvalidConfiguration;
    if (grid > fit * CL) cfg.gridDim = dim3(fit * CL);
  }
  e = cudaLaunchKernelEx(&cfg, kernel, map_a, map_b, o0, o1, o2, tot, add, m, n,
                         (k_pad + BK - 1) / BK, batch, sch, progress, window);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

// The checks both entries share, and the schedule from its host arrays
// (the scales only where given).
bool make_schedule(Schedule& sch, const void* da, const void* dbt, int m, int n, int ns,
                   int k_pad, int batch, int n_groups, const int32_t* group_start,
                   const int32_t* pair_i, const int32_t* pair_j, const float* scale_hi,
                   const float* scale_lo, int grid) {
  if (n_groups < 1 || n_groups > kMaxGroups || group_start[n_groups] > kMaxPairs ||
      k_pad < 16 || k_pad % 16 != 0 || m < 1 || n < 1 || ns < 1 || batch < 1 || grid < 1 ||
      (uintptr_t)da % 16 != 0 || (uintptr_t)dbt % 16 != 0)
    return false;
  sch.n_groups = n_groups;
  for (int g = 0; g <= n_groups; ++g) sch.start[g] = (uint16_t)group_start[g];
  for (int p = 0; p < group_start[n_groups]; ++p) {
    sch.pi[p] = (uint8_t)pair_i[p];
    sch.pj[p] = (uint8_t)pair_j[p];
  }
  for (int g = 0; g < n_groups; ++g) {
    sch.scale_hi[g] = scale_hi ? scale_hi[g] : 0.0f;
    sch.scale_lo[g] = scale_lo ? scale_lo[g] : 0.0f;
  }
  return true;
}

// window > 0: the bounded-skew walk over progress (class 0 only; int32
// [2 + clusters of the grid], zero)
template <int MODE>
int launch_tile(int tile, const void* da, const void* dbt, float* o0, float* o1, float* o2,
                int* tot, int add, int m, int n, int ns, int k_pad, int batch,
                const Schedule& sch, int grid, int smem_bytes, int* progress, int window,
                cudaStream_t s) {
  if (window < 0 || (window > 0 && (tile != 0 || progress == nullptr)))
    return (int)cudaErrorInvalidValue;
  switch (tile) {
    case 0:
      if (window > 0)
        return launch<2, 256, 4, 2, MODE | kWalk>(da, dbt, o0, o1, o2, tot, add, m, n, ns,
                                                  k_pad, batch, sch, grid, smem_bytes,
                                                  progress, window, s);
      return launch<2, 256, 4, 2, MODE>(da, dbt, o0, o1, o2, tot, add, m, n, ns, k_pad,
                                        batch, sch, grid, smem_bytes, nullptr, 0, s);
    case 1:
      return launch<1, 128, 8, 1, MODE>(da, dbt, o0, o1, o2, tot, add, m, n, ns, k_pad,
                                        batch, sch, grid, smem_bytes, nullptr, 0, s);
    case 2:  // the kept class folds only: its triple has no place in the totals mode
      if constexpr (MODE == kFold)
        return launch<2, 96, 8, 2, kKeep>(da, dbt, o0, o1, o2, tot, add, m, n, ns, k_pad,
                                          batch, sch, grid, smem_bytes, nullptr, 0, s);
      return (int)cudaErrorInvalidValue;
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The totals fold (replaces ozimmu_tpu_torch/ops/recombine.py::
// fold_group_totals, plain XLA in the JAX package: ozimmu_tpu/ops/
// recombine.py:127): int32 group totals [G, elems] -> the triple's three
// f32 planes [3, elems], elementwise, in fold_group_totals' order (per
// group ascending: the hi term then the lo term through add_term, then
// renorm), with fold_group's round-to-nearest steps, so bit for bit.
// Bound by bytes: 4 G + 12 per element.  V consecutive elements a thread,
// each group's V totals in one load (16 bytes where V = 4) and each
// plane's V results in one store.
struct Scales {
  int n_groups;
  float hi[kMaxGroups];  // 2^(w+16)
  float lo[kMaxGroups];  // 2^w
};

template <int V>
__global__ void __launch_bounds__(256)
    totals_fold_kernel(const int* __restrict__ tot, float* __restrict__ out, int64_t elems,
                       const Scales sc) {
  const int64_t units = elems / V;
  for (int64_t u = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; u < units;
       u += (int64_t)gridDim.x * blockDim.x) {
    const int64_t e0 = u * V;
    float t0[V], t1[V], t2[V];
#pragma unroll
    for (int q = 0; q < V; ++q) t0[q] = t1[q] = t2[q] = 0.0f;
    for (int g = 0; g < sc.n_groups; ++g) {
      int v[V];
      const int* src = tot + (int64_t)g * elems + e0;
      if constexpr (V == 4) {
        const int4 x = __ldg(reinterpret_cast<const int4*>(src));
        v[0] = x.x;
        v[1] = x.y;
        v[2] = x.z;
        v[3] = x.w;
      } else {
        v[0] = __ldg(src);
      }
#pragma unroll
      for (int q = 0; q < V; ++q) fold_total(v[q], t0[q], t1[q], t2[q], sc.hi[g], sc.lo[g]);
    }
#pragma unroll
    for (int q = 0; q < V; ++q) renorm(t0[q], t1[q], t2[q]);
    if constexpr (V == 4) {
      *reinterpret_cast<float4*>(out + e0) = make_float4(t0[0], t0[1], t0[2], t0[3]);
      *reinterpret_cast<float4*>(out + elems + e0) = make_float4(t1[0], t1[1], t1[2], t1[3]);
      *reinterpret_cast<float4*>(out + 2 * elems + e0) = make_float4(t2[0], t2[1], t2[2], t2[3]);
    } else {
      out[e0] = t0[0];
      out[elems + e0] = t1[0];
      out[2 * elems + e0] = t2[0];
    }
  }
}

}  // namespace

// da: [ns, batch, m, k_pad]; dbt: B's planes transposed to
// [ns, batch, n, k_pad]; both 16-byte aligned, k_pad a multiple of 16, zero
// beyond the true k; o0, o1, o2: [batch, m, n]; batch x (cluster units of
// one matrix) below 2^31 (the launch plan checks).
// group_start: n_groups + 1 pair offsets; pair_i / pair_j: 0-based planes
// of each pair; scale_hi / scale_lo: the two f32 factors of each group.
// All five are host arrays.  tile: 0 = 128x256 in clusters of 2 (4
// stages), 1 = 64x128 (8 stages), 2 = 128x96 with the triple kept in
// registers, in clusters of 2x2 (8 stages); grid: persistent blocks, a
// multiple of the cluster size (fewer are launched if fewer clusters fit
// on the card at once); smem_bytes must equal the tile class's dynamic
// shared memory (ops/recombine_cuda.py::launch_plan).  window > 0 (tile 0
// only): the bounded-skew walk, `progress` int32 [2 + grid / 2], zero
// (struct Walk); else 0, and progress unused.
// Returns a cudaError_t code (0 = launched).
extern "C" int oz_recombine(const void* da, const void* dbt, void* o0, void* o1,
                            void* o2, int m, int n, int ns, int k_pad, int batch,
                            int n_groups,
                            const int32_t* group_start, const int32_t* pair_i,
                            const int32_t* pair_j, const float* scale_hi,
                            const float* scale_lo, int tile, int grid, int smem_bytes,
                            void* progress, int window, void* stream) {
  Schedule sch;
  if (!make_schedule(sch, da, dbt, m, n, ns, k_pad, batch, n_groups, group_start, pair_i,
                     pair_j, scale_hi, scale_lo, grid))
    return (int)cudaErrorInvalidValue;
  return launch_tile<kFold>(tile, da, dbt, (float*)o0, (float*)o1, (float*)o2, nullptr, 0, m,
                            n, ns, k_pad, batch, sch, grid, smem_bytes, (int*)progress,
                            window, (cudaStream_t)stream);
}

// The totals mode: the same operands, plan, walk and schedule as
// oz_recombine (no scales; tile 0 or 1); totals: int32 [n_groups, batch, m,
// n], 8-byte aligned, stored (add == 0) or added to (add != 0).  Returns a
// cudaError_t code.
extern "C" int oz_recombine_totals(const void* da, const void* dbt, void* totals, int add,
                                   int m, int n, int ns, int k_pad, int batch, int n_groups,
                                   const int32_t* group_start, const int32_t* pair_i,
                                   const int32_t* pair_j, int tile, int grid,
                                   int smem_bytes, void* progress, int window,
                                   void* stream) {
  Schedule sch;
  if ((uintptr_t)totals % 8 != 0 ||
      !make_schedule(sch, da, dbt, m, n, ns, k_pad, batch, n_groups, group_start, pair_i,
                     pair_j, nullptr, nullptr, grid))
    return (int)cudaErrorInvalidValue;
  return launch_tile<kTotals>(tile, da, dbt, nullptr, nullptr, nullptr, (int*)totals, add, m,
                              n, ns, k_pad, batch, sch, grid, smem_bytes, (int*)progress,
                              window, (cudaStream_t)stream);
}

// The totals fold: totals int32 [n_groups, elems] -> out float32
// [3, elems]; vec 4 (elems a multiple of 4, both 16-byte aligned) or 1;
// scale_hi / scale_lo: host arrays of the groups' two f32 factors; a
// grid-stride loop over `grid` blocks of `threads`
// (ops/recombine_cuda.py::fold_plan).  Returns a cudaError_t code.
extern "C" int oz_totals_fold(const void* totals, void* out, int64_t elems, int n_groups,
                              const float* scale_hi, const float* scale_lo, int vec,
                              int grid, int threads, void* stream) {
  if (n_groups < 1 || n_groups > kMaxGroups || elems < 1 || grid < 1 || threads != 256 ||
      (vec != 1 && vec != 4) ||
      (vec == 4 && (elems % 4 != 0 || (uintptr_t)totals % 16 != 0 || (uintptr_t)out % 16 != 0)))
    return (int)cudaErrorInvalidValue;
  Scales sc;
  sc.n_groups = n_groups;
  for (int g = 0; g < n_groups; ++g) {
    sc.hi[g] = scale_hi[g];
    sc.lo[g] = scale_lo[g];
  }
  cudaStream_t s = (cudaStream_t)stream;
  if (vec == 4)
    totals_fold_kernel<4><<<grid, threads, 0, s>>>((const int*)totals, (float*)out, elems, sc);
  else
    totals_fold_kernel<1><<<grid, threads, 0, s>>>((const int*)totals, (float*)out, elems, sc);
  return (int)cudaGetLastError();
}
