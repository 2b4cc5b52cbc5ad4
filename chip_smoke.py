#!/usr/bin/env python3
"""Smoke run of ozimmu_tpu_torch on one CUDA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from ``ozimmu_tpu_torch/csrc``, checks each kernel
bit for bit against its plain PyTorch version (the exponent max; the split
in both plane layouts, natural and k-major; the recombine kernel in each
of its tile classes, from either layout), drives the main path — the real
DGEMM ``gemm(a, b, mode="fp64_int8_9")`` at m = n = k = 8192 — checks its
bits against the plain pipeline and its residual against a long-double
oracle, shows that the main path launched the exponent max and the split
twice each, recombine and the epilogue once, and times the main path, its
phases, each operand's split stage and each kernel against its plain
version and its bound, the transposed copy of B's planes that the k-major
split removed and the int8 products alone through ``torch._int_mm`` as
yardsticks, the GEMM's peak memory, and ``torch.matmul`` on float64.  Then
the epilogue and complex-fold kernels bit for bit against their plain
versions (the main path's S and exponent parts, crafted triples in every
branch at odd n with E as a plane and as crafted parts, a column panel
written at an odd column, sgemm's E-plane route, HPL's 15360^2 update with
a strided c, a batch by pa [B, m] and pb [B, n], ZGEMM's four passes at
8192^2), each timed beside its bound, the same kernel on an exponent plane
built in the call and its plain version, and an issue-time model from a
SASS count; the ``[build]`` lines give each instantiation's registers,
spills and SASS instructions, its element loops' instructions per element,
and the probe kernels' count of one admitted element of each case
(tools/torch_epilogue_sass.py).

Then it drives the rest of the public GEMM API, each path with the launch
counts set to 0 just before it and read just after:

  * AUTO: ``gemm(a, b)`` with no mode at 8192^3, its 16 loss totals held
    against the literal estimator, its bits against the chosen mode's;
  * ZGEMM: complex128 8192^3 ``fp64_int8_9``, bits against the plain
    pipeline, residual, time against ``torch.matmul`` on complex128, and an
    op_a="C" / complex alpha, beta, c probe;
  * sgemm at 4096^3: demoted operands, an f32 error bound, the caller's
    TF32 setting kept out and restored; one complex probe;
  * ``gemm_batched`` (one launch of each kernel per sub-batch): 8 x 1024^3
    real and complex, 64 x 256^3, an odd 5 x 1000 x 777 x 513 batch and
    4 x 4096^3, also in sub-batches under a 3 GiB budget; bits against a
    loop of 2-D ``gemm``, both kernels bitwise against their plain versions
    on each batch, and timed beside the loop and batched ``torch.matmul``;
  * ``device_trace`` of one 4096^3 GEMM: kernel names and the device's
    busy share over the traced window;
  * ``warmup`` and ``reallocate_working_memory``;
  * interception: ``a @ b`` at 8192^3 under ``intercept(mode=...)`` bitwise
    equal to the direct call and timed against it, batched ``einsum``, a
    conj-bit ``a.mH @ b``, an ``nn.Linear`` step with its backward, the
    size gate and the per-call env mode;
  * ``traced.gemm`` at 8192^3 inside ``torch.compile(fullgraph=True)``,
    bitwise equal to the eager call;
  * the bench CLI: one 8192^3 CSV row, the 72-case ``ci_test`` at 513,
    and the ``power`` mode with NVML watts;
  * the solvers (``linalg``): resident LU (real n = 1024, complex n = 512)
    and Cholesky with host panels bitwise equal to the same call on CPU
    tensors, device panels with the same pivots, ``solve`` with refinement
    at n = 2048, launch counts equal to the step formula on every path;
    then ``bench_cli hpl`` at n = 16384 and ``hpl --dtype z`` at n = 8192
    beside ``torch.linalg.lu_factor``, both kernels bit for bit against
    their plain versions on every engine product of those two runs' first
    step, and the first HPL trailing update staged, its peak memory held
    against the working-set model, also under a 12 GiB budget;
  * the distributed layer (``parallel``), each rank a process of its own:
    SUMMA at 8192^3 on a 1 x 1 mesh over NCCL, bitwise equal to ``gemm``
    and timed beside it; then four ranks sharing the card over gloo (the
    collectives staged through host memory): SUMMA at 8192^3, the ring,
    streamed, k-sharded, complex SUMMA and complex ring variants, AUTO,
    alpha / beta / c and the pre-sharded entry's budget re-check at 4096^3
    or below, each bitwise equal to the one-device ``gemm`` on every rank,
    with each rank's kernel launches; and the 8192^3 GEMM's peak memory
    against the working-set model;
  * the solvers' ``mesh=`` (row-sharded, each rank a process): HPL at
    n = 16384 on a 1 x 1 mesh over NCCL with device and host panels,
    bitwise equal to the one-device ``lu_factor`` and timed beside it;
    then both kernels against their plain versions on the first step's
    products at the shapes of each of four ranks, and real LU (host and
    device panels), complex LU and Cholesky at n = 4096 on four ranks
    sharing the card over gloo, against the one-device factor on the
    card, with each rank's seconds, staged bytes and kernel launches;
  * the examples (``examples/torch_0*.py``): the six single-process ones
    through ``main(device="cuda")`` at the JAX examples' sizes, each with
    its launch counts, "bitwise ==" values and residual gates, and both
    kernels against their plain versions on 05's matvec and 08's first
    trailing update; 03's case table on four gloo ranks sharing the card
    and 07 through its ``main`` (2 "hosts" x 2 gloo ranks on the hybrid
    mesh); 09 at m = n = k = 16384 on a 1 x 1 NCCL mesh, the pre-sharded
    result bitwise equal to the dense-fed ``gemm``, both kernels against
    their plain versions on its operands, residual against
    ``torch.matmul`` (summed over k-panels) and a sampled oracle block,
    both calls' peak memory against the model and their times beside
    ``torch.matmul``; and the split kernel bitwise against
    ``hostref.split_fp64``, the card's ``gemm`` within 2 ulp of
    ``hostref.gemm_fp64``.

Any failed phase raises, and the script exits non-zero without printing a
result.  It needs a CUDA GPU: without one it exits non-zero at once.  The
last line of its output is a JSON object naming the device; the line
before it is a JSON object with one entry per kernel.
"""

from __future__ import annotations

import contextlib
import glob
import io
import json
import os
import re
import subprocess
import sys
import tempfile
import time

# torch.compile's code generation runs in this process, not in a pool of
# worker processes that could outlive the script
os.environ.setdefault("TORCHINDUCTOR_COMPILE_THREADS", "1")

import numpy as np  # noqa: E402
import torch  # noqa: E402

N = 8192  # main-path size: m = n = k
NS = 9  # fp64_int8_9
RESIDUAL_GATE = 1e-15
# NVIDIA's data sheet for the H100 SXM (dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12
F32_OPS_PER_S = 67e12  # outside the tensor cores
F64_OPS_PER_S = 34e12  # outside the tensor cores
#: f32 additions, subtractions and multiplications per element of the
#: device functions of ozimmu_tpu_torch/csrc/tf32x3.cuh on the routes the
#: epilogue takes (an FMA counts two): mul_scalar with the FMA TwoProd,
#: unpack_f64's three magic-number subtractions, pack_f64's
#: renorm and tail test; and the f64 operations of pack_f64 (what an
#: operations bound of the epilogue counts; integer work not counted)
F32_OPS = {"mul": 66, "aligned_add": 63, "unpack": 3, "pack": 13}
F64_OPS = {"pack": 12}
HPL_UPDATE = (15360, 1024)  # m = n, k of HPL's first trailing update at n = 16384

# recombine cases (m, n, k, ns): ragged edges, k % 16 != 0, one group per
# pair at ns = 18 (171 pairs), the int32 group splits of k = 16384
# (8 + 1) and k = 32768 (groups of at most 4 pairs), and the solvers' wide
# products over a short k: the first trailing update and the first U12 of
# HPL at n = 16384 and of ZHPL at n = 8192 with block 1024 (many tiles per
# persistent block in both tile classes), and a block of 256
RECOMBINE_CASES = ((200, 136, 272, 6), (256, 128, 1024, 8), (1000, 1234, 777, 9),
                   (64, 64, 16384, 9), (17, 9, 32, 3), (1025, 1023, 1025, 16),
                   (130, 260, 4096, 18), (512, 640, 32768, 12),
                   (3072, 3072, 256, 9), (15360, 15360, 1024, 9), (1024, 15360, 1024, 9),
                   (7168, 7168, 1024, 9), (1024, 7168, 1024, 9))


def gpu_label() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    return out.splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 1) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls (CUDA
    events, after ``warmup`` calls)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def special_matrix() -> np.ndarray:
    """Zero row and column, subnormals, -0.0 and extreme magnitudes."""
    x = np.random.default_rng(3).standard_normal((64, 128))
    x[0, :] = 0.0
    x[:, 0] = 0.0
    x[1, 1] = 5e-324
    x[2, 2] = -1e-310
    x[3, 3] = -0.0
    x[4, 4] = 1e300
    x[5, 5] = -1e-300
    return x


def bound_ms(n_bytes: float, ops: float, peak_ops: float):
    """The least time the card could take (ms) and what sets it: the bytes
    over the memory rate, or the operations over the peak rate."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S * 1e3, ops / peak_ops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def bits_equal(x: torch.Tensor, y: torch.Tensor) -> bool:
    view = {torch.float64: torch.int64, torch.float32: torch.int32}.get(x.dtype, x.dtype)
    return x.shape == y.shape and torch.equal(x.view(view), y.view(view))


#: the kernels' launch counters, by the name each has in the results
KERNEL_KEYS = ("split_digits", "row_exponent", "recombine", "epilogue", "zfold")


def reset_launches() -> None:
    from ozimmu_tpu_torch.ops import epilogue_cuda, exponent_cuda, recombine_cuda, split_cuda

    torch.cuda.synchronize()
    split_cuda.LAUNCHES = 0
    exponent_cuda.LAUNCHES = 0
    recombine_cuda.LAUNCHES = 0
    epilogue_cuda.LAUNCHES = 0
    epilogue_cuda.ZFOLD_LAUNCHES = 0


def read_launches() -> dict:
    from ozimmu_tpu_torch.ops import epilogue_cuda, exponent_cuda, recombine_cuda, split_cuda

    torch.cuda.synchronize()
    return {"split_digits": split_cuda.LAUNCHES, "row_exponent": exponent_cuda.LAUNCHES,
            "recombine": recombine_cuda.LAUNCHES, "epilogue": epilogue_cuda.LAUNCHES,
            "zfold": epilogue_cuda.ZFOLD_LAUNCHES}


def per_path(split: int, recombine: int, epilogue: int = 0, zfold: int = 0) -> dict:
    """The launch counts of a path that splits ``split`` operands (each
    split is one exponent-max launch and one split launch), runs
    ``recombine`` recombine launches, ``epilogue`` epilogue launches (one
    per real GEMM, column panel or sub-batch) and ``zfold`` complex folds
    (one per ZGEMM, panel or sub-batch)."""
    return {"split_digits": split, "row_exponent": split, "recombine": recombine,
            "epilogue": epilogue, "zfold": zfold}


def gemms(real: int = 0, complex_: int = 0) -> dict:
    """The launch counts of ``real`` real and ``complex_`` complex engine
    GEMMs, each unchunked and with its recombine kernel: a real one splits
    two operands, recombines once and runs one epilogue, a complex one
    splits four planes, recombines four times and runs one fold."""
    return per_path(2 * real + 4 * complex_, real + 4 * complex_, real, complex_)


def counts_of(res: dict, prefix: str = "") -> dict:
    """The launch counts in a rank's or an example's results (keys
    ``prefix + kernel``), as :func:`read_launches` gives them."""
    return {k: int(res[prefix + k]) for k in KERNEL_KEYS}


def traced_events(run, name: str = None, attempts: int = 3) -> list:
    """The Chrome-trace events of ``device_trace`` around ``run()`` (inside
    a ``record_function`` window called ``name``, if given), traced again,
    ``attempts`` times in all at most, while the trace lost kernels of the
    block's launches: torch.profiler on an H100 now and then keeps none or
    only some of a trace's kernels (PERF.md §6).  The last attempt's
    events are taken as they are, unless it lost every kernel."""
    import ozimmu_tpu_torch as ozt
    from ozimmu_tpu_torch.utils.profiling import (TRACE_OPENING_LAUNCHES, TraceLostError,
                                                  launches_and_kernels)

    for attempt in range(1, attempts + 1):
        log_dir = tempfile.mkdtemp(prefix="oz_trace_")
        try:
            with ozt.device_trace(log_dir):
                with contextlib.ExitStack() as stack:
                    if name is not None:
                        stack.enter_context(torch.profiler.record_function(name))
                    run()
                    torch.cuda.synchronize()
        except TraceLostError as e:
            if attempt == attempts:
                raise
            print(f"[trace] attempt {attempt}: {e}; tracing again", flush=True)
            continue
        (path,) = glob.glob(os.path.join(log_dir, "*.json"))
        with open(path) as f:
            events = json.load(f)["traceEvents"]
        launches, kernels = launches_and_kernels(events, skip=TRACE_OPENING_LAUNCHES)
        if kernels == launches or attempt == attempts:
            return events
        print(f"[trace] attempt {attempt}: {kernels} of {launches} kernels kept; tracing again",
              flush=True)


def kernel_ms(fn, names, iters: int = 5) -> float:
    """Mean device time (ms) per call of ``fn`` of the device kernels whose
    name contains one of ``names``, over ``iters`` calls after one, from a
    ``torch.profiler`` trace: the kernels' own time, where a call is too
    short for CUDA events around it to see past the host's issue time."""
    fn()
    torch.cuda.synchronize()

    def run():
        for _ in range(iters):
            fn()

    events = traced_events(run)
    total = sum(float(e["dur"]) for e in events if e.get("cat") == "kernel"
                and any(n in e.get("name", "") for n in names))
    if total <= 0:
        raise AssertionError(f"no device time of {names} in the profile")
    return total / iters / 1e3


def residual(got: np.ndarray, ref: np.ndarray) -> dict:
    from ozimmu_tpu_torch.testing import error_metrics

    r = error_metrics(got, None, None, c_ref=ref)
    if not r["relative_residual"] < RESIDUAL_GATE:
        raise AssertionError(f"relative residual {r['relative_residual']:.3e} >= {RESIDUAL_GATE}")
    return r


def complex_residual(got: np.ndarray, ref: np.ndarray) -> float:
    """Relative Frobenius residual of a complex result against a
    clongdouble reference, under the same gate."""
    r = float(np.linalg.norm((got.astype(np.clongdouble) - ref).astype(np.complex128))
              / np.linalg.norm(ref.astype(np.complex128)))
    if not r < RESIDUAL_GATE:
        raise AssertionError(f"complex relative residual {r:.3e} >= {RESIDUAL_GATE}")
    return r


def block(rng, m: int, n: int):
    """A sampled (64 rows x 256 columns) block of an m x n output."""
    rows = np.sort(rng.choice(m, size=min(64, m), replace=False))
    cols = np.sort(rng.choice(n, size=min(256, n), replace=False))
    return rows, cols


def walled(phase, *args):
    """Run one phase and print the host seconds it took, device work
    included."""
    t0 = time.perf_counter()
    out = phase(*args)
    torch.cuda.synchronize()
    print(f"[wall] {phase.__name__}: {time.perf_counter() - t0:.1f} s", flush=True)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this check needs a CUDA GPU",
              file=sys.stderr)
        return 1
    t_start = time.perf_counter()

    import ozimmu_tpu_torch as ozt
    from ozimmu_tpu_torch import native
    from ozimmu_tpu_torch.ops import exponent_cuda, recombine_cuda, split_cuda
    from ozimmu_tpu_torch.core.gemm import Exponents, _epilogue_block, _epilogue_SE
    from ozimmu_tpu_torch.ops.recombine import (
        acc_shift, fold_group_totals, group_totals, padded_k, recombine,
    )
    from ozimmu_tpu_torch.ops.split import (
        row_exponent_plain, split_f64, split_f64_cols, split_with_row_exp,
    )
    from ozimmu_tpu_torch.schedule import bits_per_int8, group_schedule
    from ozimmu_tpu_torch.testing import generate_input, reference_gemm

    dev = torch.device("cuda")

    # 1. the device
    label = gpu_label()
    print(f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    print(label, flush=True)

    # 2. build the kernels from the sources in the checkout
    t0 = time.perf_counter()
    native.lib()
    print(f"[build] kernels built and loaded in {time.perf_counter() - t0:.2f} s "
          f"({native.library_path()})", flush=True)
    entry = "?"
    for line in native.build_log.splitlines():
        m = re.search(r"([a-z_]+_kernel)(I(?:L[ib]-?\d+E)+)?", line)
        if "Compiling entry function" in line and m:
            targs = re.findall(r"L[ib](-?\d+)E", m[2] or "")
            entry = m[1] + (f"<{', '.join(targs)}>" if targs else "")
        elif "Function properties for" in line and not m:  # an out-of-line device function
            f = re.search(r"_ZN2oz\d+(\w+?)E", line)
            entry = f"out-of-line {f[1] if f else line.split()[-1]}"
        if "Used" in line or "spill" in line:
            print(f"[build] {entry}: {line.strip()}", flush=True)
    sass = sass_report()

    max_err = {"split_digits": 0.0, "row_exponent": 0.0, "recombine": 0.0}

    # 3. exponent max and split: kernel vs plain, bitwise, the split in both
    #    plane layouts (natural [ns, R, C]; k-major [ns, R or C, k_pad], as
    #    the engine splits), on 2-D operands, batches, strided column panels
    #    and k around the multiple of 16
    mats = {
        "normal01(1000x1234)": generate_input("normal01", (1000, 1234), seed=1),
        "exp_rand-8(1000x1234)": generate_input("exp_rand-8", (1000, 1234), seed=2),
        "special(64x128)": special_matrix(),
    }
    n_cases = {"natural": 0, "k-major": 0, "exponent": 0}

    def check_split(what, x, axis, ns, b):
        e = row_exponent_plain(x, axis)
        got_e = exponent_cuda.exponent_max(x, axis)
        max_err["row_exponent"] = max(max_err["row_exponent"],
                                      float((got_e - e).abs().max().item()))
        if not torch.equal(got_e, e):
            raise AssertionError(f"exponent mismatch: {what} axis={axis}")
        n_cases["exponent"] += 1
        k = x.shape[-1] if axis == 1 else x.shape[-2]
        for layout, kp in (("natural", None), ("k-major", padded_k(k))):
            want, _ = split_with_row_exp(x, e, ns, b, axis, kp)
            got = split_cuda.split_digits(x, e, ns, b, axis, kp)
            err = (want.to(torch.int16) - got.to(torch.int16)).abs().max().item()
            max_err["split_digits"] = max(max_err["split_digits"], float(err))
            if not bits_equal(want, got):
                raise AssertionError(f"split mismatch: {what} axis={axis} ns={ns} b={b} {layout}")
            n_cases[layout] += 1

    for name, x_np in mats.items():
        x = torch.from_numpy(x_np).to(dev)
        for axis in (0, 1):
            for ns in (3, 9, 18):
                for b in (7, 5):
                    check_split(name, x, axis, ns, b)
    xb = generate_input("exp_rand-8", (3, 300, 777), seed=4)
    xb[0, 5, :] = 0.0
    xb[1, :, 7] = 0.0
    xb[2, 3, 3] = 5e-324
    wide = torch.from_numpy(mats["exp_rand-8(1000x1234)"]).to(dev)
    extra = {"batch exp_rand-8(3x300x777)": torch.from_numpy(xb).to(dev),
             "panel [:, 3:700] (8-byte aligned rows)": wide[:, 3:700],
             "panel [:, 64:1000]": wide[:, 64:1000]}
    for k in (1, 15, 16, 17):
        extra[f"normal01({k}x129)"] = torch.from_numpy(
            generate_input("normal01", (k, 129), seed=k)).to(dev)
        extra[f"normal01(129x{k})"] = torch.from_numpy(
            generate_input("normal01", (129, k), seed=k)).to(dev)
    for name, x in extra.items():
        for axis in (0, 1):
            for ns, b in ((3, 7), (9, 5), (18, 7)):
                check_split(name, x, axis, ns, b)
    torch.cuda.synchronize()
    print(f"[split] split kernel == plain bitwise in {n_cases['natural']} cases in the natural "
          f"layout and {n_cases['k-major']} k-major (A [ns, m, k_pad], B [ns, n, k_pad]); "
          f"exponent-max kernel == plain in {n_cases['exponent']} (batches, strided column "
          f"panels, k in 1, 15, 16, 17, 777, 1234 among them)", flush=True)

    # 4. recombine: kernel vs plain, bitwise on all three f32 planes, in
    #    every tile class (the launch plan picks one per shape)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for m, n, k, ns in RECOMBINE_CASES:
        b = bits_per_int8(k)
        a_t = torch.from_numpy(generate_input("normal01", (m, k), seed=m)).to(dev)
        b_t = torch.from_numpy(generate_input("exp_rand-8", (k, n), seed=n)).to(dev)
        da, _ = split_f64(a_t, ns, b)
        db, _ = split_f64_cols(b_t, ns, b)
        dak, _ = split_f64(a_t, ns, b, padded_k(k))
        dbk, _ = split_f64_cols(b_t, ns, b, padded_k(k))
        want = fold_group_totals(group_totals(da, db, ns, k, b), ns, k, b)
        for tile in range(len(recombine_cuda.TILES)):
            for got in (recombine_cuda.recombine(da, db, ns, b, k, tile=tile),
                        recombine_cuda.recombine(dak, dbk, ns, b, k, tile=tile, b_kmajor=True)):
                err = max((w - g).abs().max().item() for w, g in zip(want, got))
                max_err["recombine"] = max(max_err["recombine"], float(err))
                if not all(bits_equal(w, g) for w, g in zip(want, got)):
                    raise AssertionError(
                        f"recombine mismatch at m,n,k={m},{n},{k} ns={ns} tile={tile}")
        del want, got, da, db, dak, dbk
        groups = group_schedule(ns, k, b)
        plan = recombine_cuda.launch_plan(m, n, k, ns, sms)
        print(f"[recombine] kernel == plain bitwise (3 planes, tile classes "
              f"{list(range(len(recombine_cuda.TILES)))}, B's planes [ns, k, n] and k-major; "
              f"plan: {plan.tile}) at m,n,k={m},{n},{k} "
              f"ns={ns} b={b}: {len(groups)} groups of {[len(g.pairs) for g in groups]} pairs",
              flush=True)

    # 5. the main path at full size
    rng = np.random.default_rng(0)
    a_np = generate_input("urand01", (N, N), seed=0)
    b_np = generate_input("urand01", (N, N), seed=1)
    a = torch.from_numpy(a_np).to(dev)
    b = torch.from_numpy(b_np).to(dev)
    reset_launches()
    out = ozt.gemm(a, b, mode=f"fp64_int8_{NS}")
    launches = read_launches()

    bb = bits_per_int8(N)
    pda, ppa = split_with_row_exp(a, row_exponent_plain(a, 1), NS, bb, 1)
    pdb, ppb = split_with_row_exp(b, row_exponent_plain(b, 0), NS, bb, 0)
    S = fold_group_totals(group_totals(pda, pdb, NS, N, bb), NS, N, bb)
    E = (ppa[:, None] + ppb[None, :] - acc_shift(NS, bb)).to(torch.int32)
    plain_out = _epilogue_block(S, E, 1.0, 0.0, None)
    if not bits_equal(out, plain_out):
        raise AssertionError("main path output differs from the plain pipeline")
    del pda, pdb, S, E, plain_out
    rows, cols = block(rng, N, N)
    ref = reference_gemm(a_np[rows], b_np[:, cols])
    r = residual(out[rows][:, cols].cpu().numpy(), ref)
    if not torch.isfinite(out).all():
        raise AssertionError("non-finite values in the main-path output")
    print(f"[main] gemm fp64_int8_{NS} {N}^3 on {dev}: bits == plain pipeline; sampled 64x256 "
          f"block relative_residual={r['relative_residual']:.3e} "
          f"max_relative_error={r['max_relative_error']:.3e}", flush=True)

    # probes at modest sizes, each under the same residual gate
    m, n, k = 1000, 1234, 777
    at_np = generate_input("normal01", (k, m), seed=11)  # op_a="T" reads it as [m, k]
    bt_np = generate_input("normal01", (k, n), seed=12)
    ct_np = generate_input("normal01", (m, n), seed=13)
    got = ozt.gemm(at_np, bt_np, mode=f"fp64_int8_{NS}", op_a="T", alpha=2.0, beta=-0.5,
                   c=ct_np, device=dev)
    rows, cols = block(rng, m, n)
    ref = 2.0 * reference_gemm(at_np.T[rows], bt_np[:, cols]) - 0.5 * ct_np[rows][:, cols].astype(np.longdouble)
    r = residual(got[rows][:, cols], ref)
    print(f"[probe] {m}x{n}x{k} op_a=T alpha=2 beta=-0.5: "
          f"relative_residual={r['relative_residual']:.3e}", flush=True)

    x_np = generate_input("exp_rand-8", (1024, 1024), seed=21)
    y_np = generate_input("exp_rand-8", (1024, 1024), seed=22)
    got = ozt.gemm(x_np, y_np, mode="fp64_int8_18", device=dev)
    r = residual(got, reference_gemm(x_np, y_np))
    print(f"[probe] 1024^3 fp64_int8_18 exp_rand-8: relative_residual={r['relative_residual']:.3e}",
          flush=True)

    xa = torch.from_numpy(at_np.T.copy()).to(dev)
    xb = torch.from_numpy(bt_np).to(dev)
    one = ozt.gemm_f64(xa, xb, NS, n_chunks=1)
    three = ozt.gemm_f64(xa, xb, NS, n_chunks=3)
    if not bits_equal(one, three):
        raise AssertionError("n_chunks=3 differs from n_chunks=1")
    r = residual(three[rows][:, cols].cpu().numpy(), reference_gemm(at_np.T[rows], bt_np[:, cols]))
    print(f"[probe] {m}x{n}x{k} n_chunks=3 == n_chunks=1 bitwise; "
          f"relative_residual={r['relative_residual']:.3e}", flush=True)

    # 6. the main path went through every kernel: each operand's exponent
    #    max and split, one recombine
    if launches != gemms(1):
        raise AssertionError(f"the main path's launches {launches}, expected {gemms(1)}")
    print(f"[launches] main path {N}^3: {launches}", flush=True)

    # 7. timing (CUDA events, after warm-up); nothing is asserted on speed
    ms_main = cuda_ms(lambda: ozt.gemm(a, b, mode=f"fp64_int8_{NS}"), iters=3)
    print(f"[time] {label}: gemm fp64_int8_{NS} {N}^3: {ms_main:.3f} ms, "
          f"{2 * N**3 / ms_main / 1e9:.3f} effective FP64 TFLOPS", flush=True)

    # the engine's phases: each operand split (exponent max + split kernel)
    # into the k-major planes that recombine reads as they are
    kp = padded_k(N)
    phases = {}
    phases["split_A"] = cuda_ms(lambda: split_f64(a, NS, bb, kp), iters=5)
    phases["split_B"] = cuda_ms(lambda: split_f64_cols(b, NS, bb, kp), iters=5)
    da, pa = split_f64(a, NS, bb, kp)
    db, pb = split_f64_cols(b, NS, bb, kp)
    phases["recombine"] = cuda_ms(lambda: recombine(da, db, NS, bb, N, b_kmajor=True), iters=3)
    S = recombine(da, db, NS, bb, N, b_kmajor=True)
    main_SE = (S, Exponents(pa, pb, acc_shift(NS, bb)))
    phases["epilogue"] = cuda_ms(lambda: _epilogue_SE(*main_SE, 1.0, 0.0, None), iters=5)
    del S
    print(f"[time] {label}: phases of {N}^3 fp64_int8_{NS}: "
          + ", ".join(f"{k_} {v:.3f} ms" for k_, v in phases.items())
          + f" (sum {sum(phases.values()):.3f} ms)", flush=True)
    # a stage's bound: one read of the f64 operand and one write of its planes
    stage_bound = bound_ms(a.numel() * 8 + da.numel(), 0, INT8_OPS_PER_S)
    for op in ("A", "B"):
        print(f"[time] {label}: split {op} stage (row_exponent + split_digits, k-major planes) "
              f"{N}^2 ns={NS}: {phases[f'split_{op}']:.3f} ms, bound {stage_bound[0]:.3f} ms "
              f"({stage_bound[1]}: the operand read once, its planes written once), "
              f"{stage_bound[0] / phases[f'split_{op}']:.1%} of the bound", flush=True)

    e_a = exponent_cuda.exponent_max(a, 1)
    e_b = exponent_cuda.exponent_max(b, 0)
    ms = {
        "split_digits": cuda_ms(lambda: split_cuda.split_digits(a, e_a, NS, bb, 1, kp), iters=10),
        "row_exponent": cuda_ms(lambda: exponent_cuda.exponent_max(a, 1), iters=10),
        "recombine": cuda_ms(
            lambda: recombine_cuda.recombine(da, db, NS, bb, N, b_kmajor=True), iters=3),
    }
    ms_b = {  # the B operand: by columns, its planes through the shared-memory tiles
        "split_digits": cuda_ms(lambda: split_cuda.split_digits(b, e_b, NS, bb, 0, kp), iters=10),
        "row_exponent": cuda_ms(lambda: exponent_cuda.exponent_max(b, 0), iters=10),
    }
    plain_ms = {
        "split_digits": cuda_ms(lambda: split_with_row_exp(a, e_a, NS, bb, 1, kp), iters=3),
        "row_exponent": cuda_ms(lambda: row_exponent_plain(a, 1), iters=5),
        "recombine": cuda_ms(
            lambda: fold_group_totals(group_totals(da, db, NS, N, bb, b_kmajor=True), NS, N, bb),
            iters=3),
    }
    pairs = NS * (NS + 1) // 2
    rec_ops = pairs * 2 * N**3
    bounds = {
        # read f64 [N, N] and the int32 row exponents, write ns int8 planes
        "split_digits": bound_ms(a.numel() * 8 + e_a.numel() * 4 + da.numel(), 0,
                                 INT8_OPS_PER_S),
        # read f64 [N, N], write the int32 row exponents
        "row_exponent": bound_ms(a.numel() * 8 + e_a.numel() * 4, 0, INT8_OPS_PER_S),
        # read both operands' planes, write three f32 planes; 2mnk int8
        # operations per scheduled pair
        "recombine": bound_ms(da.numel() + db.numel() + 3 * 4 * N * N, rec_ops, INT8_OPS_PER_S),
    }
    for name in ms:
        print(f"[time] {label}: {name} at the main-path shape: kernel {ms[name]:.3f} ms"
              + (f" (A; B {ms_b[name]:.3f} ms)" if name in ms_b else "")
              + f", plain PyTorch {plain_ms[name]:.3f} ms, bound {bounds[name][0]:.3f} ms "
              f"({bounds[name][1]}), {bounds[name][0] / ms[name]:.1%} of the bound", flush=True)
    print(f"[time] {label}: recombine {N}^3 ns={NS}: {rec_ops / ms['recombine'] / 1e9:.1f} int8 "
          f"TOPS ({pairs} pairs x 2mnk)", flush=True)
    # a yardstick of what the k-major split removed: B's planes in the
    # operand's own layout [ns, k, n], copied into [ns, n, k_pad] as the
    # recombine wrapper did before (it still does for the distributed
    # layer's planes), timed alone; recombine from those planes (with the
    # copy, bitwise the same) against recombine from the split's (without)
    dn = split_cuda.split_digits(b, e_b, NS, bb, 0)
    ms_copy = cuda_ms(lambda: recombine_cuda._pad_k_major(dn.transpose(1, 2), kp), iters=5)
    ms_rec_copy = cuda_ms(lambda: recombine_cuda.recombine(da, dn, NS, bb, N), iters=3)
    if not all(bits_equal(w, g) for w, g in zip(recombine_cuda.recombine(da, dn, NS, bb, N),
                                                 recombine(da, db, NS, bb, N, b_kmajor=True))):
        raise AssertionError("recombine from [ns, k, n] planes differs from the k-major planes")
    copy_bound = bound_ms(2 * dn.numel(), 0, INT8_OPS_PER_S)
    print(f"[time] {label}: yardstick, the parent layout's transposed copy of B's planes "
          f"[ns, k, n] -> [ns, n, k_pad] at {N}^2 ns={NS}, alone: {ms_copy:.3f} ms (bound "
          f"{copy_bound[0]:.3f} ms, {copy_bound[1]}); recombine from [ns, k, n] planes (with "
          f"that copy) {ms_rec_copy:.3f} ms, from the k-major planes (no copy) "
          f"{ms['recombine']:.3f} ms, bitwise the same", flush=True)
    # the int8 products alone, without the group sums and the fold: not the
    # same function, a yardstick of the library's int8 rate
    pair_list = [(i - 1, j - 1) for g in group_schedule(NS, N, bb) for i, j in g.pairs]
    ms_mm = cuda_ms(lambda: [torch._int_mm(da[i], dn[j]) for i, j in pair_list], iters=3)
    ms_mm_t = cuda_ms(lambda: [torch._int_mm(da[i], db[j].t()) for i, j in pair_list], iters=3)
    print(f"[time] {label}: yardstick, NOT the same function: the {pairs} int8 products alone "
          f"through torch._int_mm at {N}^3: {ms_mm:.3f} ms ({rec_ops / ms_mm / 1e9:.1f} TOPS) with "
          f"B's planes [k, n] as the plain version passes them, {ms_mm_t:.3f} ms "
          f"({rec_ops / ms_mm_t / 1e9:.1f} TOPS) with them k-contiguous", flush=True)
    del da, db, dn
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ozt.gemm(a, b, mode=f"fp64_int8_{NS}")
    torch.cuda.synchronize()
    print(f"[memory] {label}: gemm fp64_int8_{NS} {N}^3: peak "
          f"{(torch.cuda.max_memory_allocated() - before) / 2**30:.3f} GiB allocated during the "
          f"call", flush=True)

    ms_dgemm = cuda_ms(lambda: torch.matmul(a, b), iters=3)
    print(f"[time] {label}: torch.matmul float64 {N}^3: {ms_dgemm:.3f} ms, "
          f"{2 * N**3 / ms_dgemm / 1e9:.3f} TFLOPS", flush=True)

    # 7b. the epilogue and fold kernels against their plain versions
    epi_figs = walled(phase_epilogue, label, main_SE, sass)
    del main_SE

    # 8.-19. the rest of the public surface, each path counted on its own
    print(f"[wall] phases 1-7 (build, kernels vs plain, main path, timing): "
          f"{time.perf_counter() - t_start:.1f} s", flush=True)
    by_path = {"main": launches}
    by_path["auto"] = walled(phase_auto, ozt, a, b, a_np, b_np, mats, label, rng)
    del a, b
    by_path["zgemm"] = walled(phase_zgemm, ozt, label, rng)
    walled(phase_sgemm, ozt)
    batched_counts, batched_figs = walled(phase_batched, ozt, label)
    by_path.update(batched_counts)
    walled(phase_trace, ozt)
    walled(phase_warmup, ozt)
    by_path["intercept"] = walled(phase_intercept, ozt, label)
    by_path["traced"] = walled(phase_traced, ozt, label)
    by_path["bench"] = walled(phase_bench, label)
    by_path.update(walled(phase_solvers, ozt, label))
    by_path.update(walled(phase_parallel, ozt, label))
    by_path.update(walled(phase_mesh_solvers, ozt, label))
    by_path.update(walled(phase_examples, ozt, label))

    kernels = [
        {"name": "split_digits", "route": "cuda", "source": "ozimmu_tpu_torch/csrc/split.cu",
         "replaces": "ozimmu_tpu/ops/split_pallas.py:134"},
        {"name": "recombine", "route": "cuda", "source": "ozimmu_tpu_torch/csrc/recombine.cu",
         "replaces": "ozimmu_tpu/ops/recombine_pallas.py:182"},
        # the split's exponent max: plain XLA in the JAX package
        {"name": "row_exponent", "route": "cuda", "source": "ozimmu_tpu_torch/csrc/exponent.cu",
         "replaces": "ozimmu_tpu/ops/split.py:42"},
    ]
    for kern in kernels:
        name = kern["name"]
        # no single PyTorch call computes any of these functions: library_ms
        # is null
        kern.update(launches=launches[name], max_abs_err=max_err[name],
                    ms=ms[name], plain_ms=plain_ms[name], bound_ms=bounds[name][0],
                    bound_by=bounds[name][1], library_ms=None,
                    launches_by_path={p: c[name] for p, c in by_path.items()})
        if name in ms_b:
            kern["ms_by_operand"] = {"A": ms[name], "B": ms_b[name]}
    # the same kernels in their batched form (one launch over a whole
    # batch, as the TPU kernels run under jax.vmap): launches in phase 11's
    # real 8 x 1024^3 run, times and bounds at that shape
    main_batch = by_path["batched_real_8x1024"]
    for kern in kernels[:3]:
        name = kern["name"]
        k_ms, p_ms, (b_ms, b_by), err, _ = batched_figs[name]
        batched = dict(
            kern, name=f"{name}_batched", launches=main_batch[name], max_abs_err=err, ms=k_ms,
            plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by, library_ms=None,
            launches_by_path={p: c[name] for p, c in by_path.items() if p.startswith("batched")})
        if name in batched_figs["B"]:
            batched["ms_by_operand"] = {"A": k_ms, "B": batched_figs["B"][name]}
        kernels.append(batched)
    # the epilogue (plain XLA in the JAX package, fused by jax.jit) on the
    # main path, the fold on ZGEMM's: launches from that path's run, times
    # and bounds at its shape (phase 7b)
    for name, path, line in (("epilogue", "main", 40), ("zfold", "zgemm", 175)):
        t, err = epi_figs[name]
        b_ms, b_by = t["bound"]
        kernels.append({
            "name": name, "route": "cuda", "source": "ozimmu_tpu_torch/csrc/epilogue.cu",
            "replaces": f"ozimmu_tpu/core/gemm.py:{line}", "launches": by_path[path][name],
            "max_abs_err": err, "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": None,
            "launches_by_path": {p: c[name] for p, c in by_path.items()}})
        if by_path[path][name] < 1:
            raise AssertionError(f"the {path} path did not launch the {name} kernel")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def epilogue_bound(rows: int, n: int, alpha: float, beta: float):
    """The epilogue kernel's bound (ms, what sets it) over a rows x n
    output: S (12 B) and c where beta != 0 (8 B) read once, the exponents'
    parts (4 B a row and a column) once, the output (8 B) written once;
    the f32 and f64 operations of its branches on the routes the kernel
    takes (F32_OPS, F64_OPS), each over its own peak rate."""
    f32 = F32_OPS["pack"] + (F32_OPS["mul"] if alpha != 1.0 else 0)
    if beta != 0.0:
        f32 += F32_OPS["unpack"] + F32_OPS["aligned_add"] + (F32_OPS["mul"] if beta != 1.0 else 0)
    n_bytes = rows * n * (20 + (8 if beta != 0.0 else 0)) + 4 * (rows + n)
    return ops_bound(n_bytes, rows * n, f32, F64_OPS["pack"])


def zfold_bound(rows: int, n: int, alpha: complex, beta: complex, with_c: bool):
    """The fold kernel's bound: four passes' S (12 B each) and their
    exponents' parts, c's two parts where the plan reads them, both output
    planes written once; the f32 and f64 operations of the plan's steps."""
    from ozimmu_tpu_torch.ops.epilogue_cuda import zfold_plan

    plan = zfold_plan(alpha, beta)
    reads_c = with_c and (plan.init_from_c or any(st.src >= 4 for st in plan.steps))
    f32 = (2 * F32_OPS["pack"] + len(plan.steps) * (F32_OPS["mul"] + F32_OPS["aligned_add"])
           + (2 * F32_OPS["unpack"] if reads_c else 0))
    n_bytes = rows * n * (4 * 12 + 16 + (16 if reads_c else 0)) + 4 * 4 * (rows + n)
    return ops_bound(n_bytes, rows * n, f32, 2 * F64_OPS["pack"])


def ops_bound(n_bytes: float, elements: int, f32: int, f64: int):
    """:func:`bound_ms` with two kinds of operation, each at its own peak:
    the f32 and the f64 operations per element over ``elements``."""
    t_ops = max(elements * f32 / F32_OPS_PER_S, elements * f64 / F64_OPS_PER_S) * 1e3
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def issue_ms(elements: int, per_element):
    """A model, not a measurement: the least time for ``per_element`` SASS
    instructions of each of ``elements`` outputs, one warp instruction a
    cycle on each of an SM's four schedulers at the card's highest SM clock
    (nvidia-smi); None where there is no count."""
    if not per_element:
        return None
    props = torch.cuda.get_device_properties(0)
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60).stdout.split()[0])
    return elements * per_element / (props.multi_processor_count * 4 * 32 * mhz * 1e6) * 1e3


def sass_report() -> dict:
    """[build] lines of the epilogue and fold kernels: SASS instructions,
    registers and spills of each instantiation and its element loops'
    instructions per element, and each case's count from the built
    kernels and from the probes' model (tools/torch_epilogue_sass.py);
    {} where the toolkit has no cuobjdump."""
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tools",
                        "torch_epilogue_sass.py")
    spec = importlib.util.spec_from_file_location("torch_epilogue_sass", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    try:
        rep = mod.report()
    except FileNotFoundError as e:
        print(f"[build] SASS counts not measured: {e}", flush=True)
        return {}
    for name, k in rep["kernels"].items():
        loops = ", ".join(f"{lp['instructions']} for {lp['elements']}" for lp in k["element_loops"])
        print(f"[build] {name}: {k['sass']} SASS instructions, {k.get('registers')} registers, "
              f"{k.get('spill_bytes')} bytes spilled; element loops: {loops or 'none found'}",
              flush=True)
    print("[build] SASS instructions per element of the built kernels' element loops (static: "
          "every branch of the body): " + "; ".join(
              f"{case} {n:.2f}" if n else f"{case} not found"
              for case, n in rep["built_per_element"].items()), flush=True)
    print("[build] SASS instructions per element of the probes (a model: one admitted element "
          "of each case straight through): " + "; ".join(
              f"{case} {n}" for case, n in rep["per_element"].items()), flush=True)
    return {"built": rep["built_per_element"], "probe": rep["per_element"]}


def max_abs_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| over the elements (0 where both are the same
    infinity)."""
    d = (got - want).abs()
    return float(torch.where(got == want, torch.zeros_like(d), d).max())


def window_of(c: torch.Tensor, pad: int = 1024) -> torch.Tensor:
    """``c`` as the strided window ``big[pad:, pad:]`` of a wider matrix,
    as HPL passes its trailing block."""
    m, n = c.shape
    big = torch.zeros((m + pad, n + pad), dtype=c.dtype, device=c.device)
    big[pad:, pad:] = c
    return big[pad:, pad:]


def phase_epilogue(label, main_SE, sass) -> dict:
    """7b. The epilogue and fold kernels against their plain versions
    (``_epilogue_block``, ``_zfold_block``), bit for bit, each call one
    launch: the main path's own S and exponent parts at 8192^2 (alpha = 1,
    beta = 0) and with alpha, beta and c; crafted triples in every branch
    at 1031 x 1029 (odd n: the one-column tail), with E as a plane (the
    sgemm route) and as crafted parts; HPL's first trailing update, 15360^2
    from the split and recombine kernels, alpha = -1, beta = 1 and c the
    strided window of a 16384^2 matrix; a column panel written in place at
    an odd column offset; an 8 x 1024^3 batch by its parts pa [B, m] and
    pb [B, n]; sgemm's alpha and beta through the E-plane route; the fold
    on crafted passes and at 8192^2 on four recombined passes with alpha =
    1 (ZGEMM's main path) and with complex alpha, beta and c, contiguous
    and strided.  Then each timed case: the kernel, the same kernel on an
    exponent plane built in the call (the exponents as the callers passed
    them before: the plane's torch kernels, then the E-plane route), the
    plain version, the bound and the issue time of its SASS count.
    Returns the figures of the kernels line."""
    import ozimmu_tpu_torch as ozt
    from ozimmu_tpu_torch.core.gemm import (
        Exponents, _epilogue_block, _epilogue_SE, _zfold_block, _zpasses, _zsplit,
    )
    from ozimmu_tpu_torch.ops import epilogue_cuda
    from ozimmu_tpu_torch.ops.pack import unpack_f64
    from ozimmu_tpu_torch.ops.recombine import acc_shift, padded_k, recombine
    from ozimmu_tpu_torch.ops.split import split_f64, split_f64_cols
    from ozimmu_tpu_torch.schedule import bits_per_int8
    from ozimmu_tpu_torch.testing import crafted_exponents, crafted_triples, generate_input

    err = {"epilogue": 0.0, "zfold": 0.0}
    cases = {"epilogue": 0, "zfold": 0}
    plane = lambda E: E.plane() if isinstance(E, Exponents) else E  # noqa: E731

    def check_epilogue(what, S, E, alpha, beta, c, via=None, out=None):
        want = _epilogue_block(S, plane(E), alpha, beta, c if beta != 0.0 else None)
        before = epilogue_cuda.LAUNCHES
        got = (via or epilogue_cuda.epilogue)(S, E, alpha, beta, c if beta != 0.0 else None, out)
        torch.cuda.synchronize()
        if epilogue_cuda.LAUNCHES - before != 1 or not bits_equal(got, want.view(got.shape)):
            raise AssertionError(f"epilogue kernel != plain: {what} alpha={alpha} beta={beta}")
        err["epilogue"] = max(err["epilogue"], max_abs_err(got, want.view(got.shape)))
        cases["epilogue"] += 1

    def check_zfold(what, SEs, alpha, beta, c_re, c_im):
        m, n = SEs[0][0][0].shape
        want = _zfold_block(SEs, m, n, complex(alpha), complex(beta), c_re, c_im, "cuda")
        before = epilogue_cuda.ZFOLD_LAUNCHES
        got = epilogue_cuda.zfold(SEs, alpha, beta, c_re, c_im)
        torch.cuda.synchronize()
        if epilogue_cuda.ZFOLD_LAUNCHES - before != 1 or not all(
                bits_equal(g, w) for g, w in zip(got, want)):
            raise AssertionError(f"fold kernel != plain: {what} alpha={alpha} beta={beta}")
        err["zfold"] = max([err["zfold"]] + [max_abs_err(g, w) for g, w in zip(got, want)])
        cases["zfold"] += 1
        del want, got

    times = {}

    def time_epilogue(key, S, E, alpha, beta, cc, plain_iters):
        m_, n_ = S[0].shape
        times[key] = dict(
            ms=cuda_ms(lambda: epilogue_cuda.epilogue(S, E, alpha, beta, cc), iters=10),
            plane_ms=cuda_ms(lambda: epilogue_cuda.epilogue(S, E.plane(), alpha, beta, cc),
                             iters=10),
            plain_ms=cuda_ms(lambda: _epilogue_block(S, E.plane(), alpha, beta, cc),
                             iters=plain_iters),
            bound=epilogue_bound(m_, n_, alpha, beta), elements=m_ * n_)

    rng = np.random.default_rng(7)
    S, E = main_SE
    c = torch.from_numpy(generate_input("normal01", (N, N), seed=20)).cuda()
    check_epilogue(f"main path {N}^2", S, E, 1.0, 0.0, None)
    check_epilogue(f"main path {N}^2 with c", S, E, 2.0, -0.5, c)
    check_epilogue(f"main path {N}^2, E as a plane", S, E.plane(), 2.0, -0.5, c)
    time_epilogue("main", S, E, 1.0, 0.0, None, 2)
    time_epilogue("scaled", S, E, 2.0, -0.5, c, 2)
    # a column panel written in place at an odd column offset (one-double
    # stores), the window's c at another
    w = N // 4
    wide = torch.full((N, w + 5), 7.0, dtype=torch.float64, device="cuda")
    Sp = tuple(s[:, :w].contiguous() for s in S)
    Ep = Exponents(E.pa, E.pb[:w].contiguous(), E.shift)
    check_epilogue(f"{N} x {w} panel at column 3 of a wider output", Sp, Ep, -1.0, 1.0,
                   window_of(c[:, :w], 5), via=_epilogue_SE, out=wide[:, 3:3 + w])
    if not bool((wide[:, :3] == 7.0).all() and (wide[:, 3 + w:] == 7.0).all()):
        raise AssertionError("the panel's epilogue wrote outside its columns")
    del S, E, c, main_SE, wide, Sp, Ep
    torch.cuda.empty_cache()

    # crafted triples: odd n (every column through the one-column tail),
    # E as a plane and as crafted parts, in every branch
    St, Et, ct = crafted_triples(1031, 1029, seed=21, device="cuda")
    Ex = Exponents(*crafted_exponents(1031, 1029, seed=22, device="cuda"))
    for alpha, beta in ((1.0, 0.0), (-1.5, 0.0), (1.0, 1.0), (-1.0, 1.0), (1.0, -0.5),
                        (2.5, -0.5), (0.0, 1.5), (0.1, 1.0 / 3.0)):
        for cc in (ct, window_of(ct, 7)):
            for EE in (Et, Ex):
                check_epilogue("crafted 1031x1029", St, EE, alpha, beta, cc)
    passes = [crafted_triples(515, 517, seed=22 + i, device="cuda") for i in range(4)]
    SEs = [(p[0], Exponents(*crafted_exponents(515, 517, seed=40 + i, device="cuda")))
           for i, p in enumerate(passes)]
    for alpha, beta in ((1.0, 0.0), (-1.0, 1.0), (0.5 - 1.5j, 1.25 + 0.5j), (0.0, -1.0),
                        (2.5, 0.75), (1j, 2j)):
        for parts in ((None, None), (passes[0][2], passes[1][2]),
                      (window_of(passes[2][2], 5), window_of(passes[3][2], 3))):
            check_zfold("crafted 515x517", SEs, alpha, beta, *parts)
    del St, Et, ct, Ex, passes, SEs

    # sgemm's alpha and beta: the E-plane route on the unpacked result
    xa = torch.from_numpy(generate_input("normal01", (1000, 777), seed=27)).cuda()
    xb = torch.from_numpy(generate_input("normal01", (777, 1234), seed=28)).cuda()
    xc = torch.from_numpy(generate_input("normal01", (1000, 1234), seed=29)).cuda()
    before = epilogue_cuda.LAUNCHES
    got = ozt.gemm(xa, xb, mode="sgemm", alpha=-2.5, beta=0.75, c=xc)
    t, Eu = unpack_f64(ozt.gemm(xa, xb, mode="sgemm"))
    if epilogue_cuda.LAUNCHES - before != 1 or not bits_equal(
            got, _epilogue_block(t, Eu, -2.5, 0.75, xc)):
        raise AssertionError("sgemm's epilogue (the E-plane route) != plain")
    cases["epilogue"] += 1
    del xa, xb, xc, got, t, Eu

    # HPL's first trailing update: 15360^2 x 1024 through the kernels
    m, k = HPL_UPDATE
    bb = bits_per_int8(k)
    l21 = torch.from_numpy(rng.uniform(-1, 1, (m, k))).cuda()
    u12 = torch.from_numpy(rng.uniform(-1, 1, (k, m))).cuda()
    da, pa = split_f64(l21, NS, bb, padded_k(k))
    db, pb = split_f64_cols(u12, NS, bb, padded_k(k))
    S = recombine(da, db, NS, bb, k, b_kmajor=True)
    E = Exponents(pa, pb, acc_shift(NS, bb))
    del l21, u12, da, db
    a_hpl = torch.from_numpy(rng.uniform(-1, 1, (m + k, m + k))).cuda()
    c22 = a_hpl[k:, k:]
    check_epilogue(f"HPL update {m}^2, c a window of {m + k}^2", S, E, -1.0, 1.0, c22)
    time_epilogue("hpl", S, E, -1.0, 1.0, c22, 1)
    del S, E, a_hpl, c22
    torch.cuda.empty_cache()

    # a batch by its parts: pa [B, m], pb [B, n], through the dispatch
    bsz, n1 = 8, 1024
    xa = torch.from_numpy(generate_input("normal01", (bsz, n1, n1), seed=23)).cuda()
    xb = torch.from_numpy(generate_input("exp_rand-8", (bsz, n1, n1), seed=24)).cuda()
    xc = torch.from_numpy(generate_input("normal01", (bsz, n1, n1), seed=25)).cuda()
    bb = bits_per_int8(n1)
    da, pa = split_f64(xa, NS, bb, padded_k(n1))
    db, pb = split_f64_cols(xb, NS, bb, padded_k(n1))
    Sb = recombine(da, db, NS, bb, n1, b_kmajor=True)
    Eb = Exponents(pa, pb, acc_shift(NS, bb))
    check_epilogue(f"batch {bsz} x {n1}^2 by pa [B, m] and pb [B, n]", Sb, Eb, 1.5, -0.5, xc,
                   via=_epilogue_SE)
    check_epilogue(f"batch {bsz} x {n1}^2, E as a plane", Sb, Eb.plane(), 1.5, -0.5, xc,
                   via=_epilogue_SE)
    del xa, xb, xc, da, db, Sb, Eb

    # the fold on four recombined passes at 8192^2
    bb = bits_per_int8(N)
    kp = padded_k(N)
    planes = [torch.from_numpy(generate_input("urand01", (N, N), seed=26 + i)).cuda()
              for i in range(4)]
    a_planes = _zsplit(planes[0], planes[1], NS, bb, kp, cols=False)
    b_planes = _zsplit(planes[2], planes[3], NS, bb, kp, cols=True)
    del planes
    SEs = _zpasses(a_planes, b_planes, NS, bb, N, b_kmajor=True)
    del a_planes, b_planes
    c_re, c_im = (torch.from_numpy(generate_input("normal01", (N, N), seed=30 + i)).cuda()
                  for i in range(2))
    check_zfold(f"ZGEMM {N}^2", SEs, 1.0, 0.0, None, None)
    za, zb = 2 - 0.5j, 0.25 + 1j
    check_zfold(f"ZGEMM {N}^2 with c", SEs, za, zb, c_re, c_im)
    check_zfold(f"ZGEMM {N}^2 with c windows", SEs, za, zb, window_of(c_re, 64),
                window_of(c_im, 64))
    four_planes = cuda_ms(lambda: [E.plane() for _, E in SEs], iters=5)
    for key, (alpha, beta, cs) in {"zfold": (1.0, 0.0, (None, None)),
                                   "zfold_c": (za, zb, (c_re, c_im))}.items():
        times[key] = dict(
            ms=cuda_ms(lambda: epilogue_cuda.zfold(SEs, alpha, beta, *cs), iters=5),
            planes_ms=four_planes,
            plain_ms=cuda_ms(lambda: _zfold_block(SEs, N, N, complex(alpha), complex(beta),
                                                  *cs, "cuda"), iters=1),
            bound=zfold_bound(N, N, alpha, beta, cs[0] is not None), elements=N * N)
    del SEs, c_re, c_im
    torch.cuda.empty_cache()
    print(f"[epilogue] epilogue kernel == plain bitwise in {cases['epilogue']} cases, fold "
          f"kernel == plain in {cases['zfold']} (the main path's S and exponent parts, crafted "
          f"triples in every branch with E as a plane and as crafted parts at odd n, c "
          f"contiguous and as strided windows, a panel at an odd column, sgemm's E-plane "
          f"route, HPL's 15360^2 update, a batch by pa [B, m] and pb [B, n], ZGEMM's four "
          f"passes at {N}^2), one launch each", flush=True)
    names = {"main": (f"epilogue {N}^2 alpha=1 beta=0 (the main path)",
                      "epilogue alpha=1 beta=0"),
             "scaled": (f"epilogue {N}^2 alpha=2 beta=-0.5 with c", "epilogue alpha beta"),
             "hpl": (f"epilogue {m}^2 alpha=-1 beta=1, c a strided window (HPL's first update)",
                     "epilogue alpha beta=1 (HPL: -1, 1)"),
             "zfold": (f"fold {N}^2 alpha=1 beta=0 (ZGEMM's main path)",
                       "fold alpha=1 (4 steps)"),
             "zfold_c": (f"fold {N}^2 alpha=2-0.5i beta=0.25+1i with c",
                         "fold complex alpha, beta, c (12 steps)")}
    for key, t in times.items():
        what, case = names[key]
        b_ms, b_by = t["bound"]
        models = []
        for kind, per in (("built element loop", sass.get("built", {}).get(case)),
                          ("probe", sass.get("probe", {}).get(case))):
            issue = issue_ms(t["elements"], per)
            models.append(f"{kind} not counted" if issue is None else
                          f"{kind} {per:.2f} SASS instructions an element, {issue:.4f} ms")
        model = "issue model (not a measurement): " + "; ".join(models)
        before = (f"on a plane built in the call {t['plane_ms']:.4f} ms" if "plane_ms" in t else
                  f"the four planes it no longer takes {t['planes_ms']:.4f} ms to build")
        print(f"[time] {label}: {what}: kernel {t['ms']:.4f} ms ({before}), plain PyTorch "
              f"{t['plain_ms']:.3f} ms, bound {b_ms:.4f} ms ({b_by}), {b_ms / t['ms']:.1%} of the "
              f"bound; {model}", flush=True)
    return {"epilogue": (times["main"], err["epilogue"]), "zfold": (times["zfold"], err["zfold"])}


def phase_auto(ozt, a, b, a_np, b_np, mats, label, rng) -> dict:
    """8. AUTO (no mode) on the main path's operands at the default
    threshold 0.0: totals against the literal estimator, bits against the
    chosen mode, residual, launches."""
    from ozimmu_tpu_torch.core.bits import exponent_field
    from ozimmu_tpu_torch.ops.mantissa_loss import auto_mode_select, mantissa_loss_totals
    from ozimmu_tpu_torch.schedule import bits_per_int8
    from ozimmu_tpu_torch.testing import loss_totals_literal, reference_gemm

    bb = bits_per_int8(N)
    h = ozt.create(device="cuda")
    if h.avg_mantissa_loss_threshold != 0.0:
        raise AssertionError("the AUTO phase expects the default threshold 0.0")
    totals = (mantissa_loss_totals(a, bb, 1) + mantissa_loss_totals(b, bb, 0)).cpu()
    # the literal form materialises [16, rows, cols]: feed it 2048-row slabs
    e_a = torch.amax(exponent_field(a), dim=1)
    e_b = torch.amax(exponent_field(b), dim=0)
    literal = sum(loss_totals_literal(a[r:r + 2048], e_a[r:r + 2048], bb, 1)
                  for r in range(0, N, 2048))
    literal = literal + sum(loss_totals_literal(b[r:r + 2048], e_b, bb, 0)
                            for r in range(0, N, 2048))
    if not torch.equal(totals, literal.cpu()):
        raise AssertionError(f"AUTO totals {totals.tolist()} != literal {literal.tolist()}")
    n_cases = 0
    for name, x_np in mats.items():
        x = torch.from_numpy(x_np).cuda()
        for axis in (0, 1):
            e = torch.amax(exponent_field(x), dim=axis)
            for b_ in (7, 5):
                got = mantissa_loss_totals(x, b_, axis)
                if not torch.equal(got, loss_totals_literal(x, e, b_, axis)):
                    raise AssertionError(
                        f"loss totals differ from the literal form: {name} axis={axis} b={b_}")
                n_cases += 1
    print(f"[auto] loss totals == literal estimator: {N}^2 urand01 A and B, and {n_cases} "
          f"cases of {sorted(mats)}", flush=True)

    reset_launches()
    out = ozt.gemm(a, b, handle=h)
    counts = read_launches()
    chosen = auto_mode_select(a, b, N, 0.0)
    print(f"[auto] {N}^3 urand01, threshold 0.0 (the default): AUTO chose {chosen.value}; "
          f"loss totals ns=3..18 {totals.tolist()}", flush=True)
    if not chosen.is_int8:
        raise AssertionError(f"AUTO chose {chosen.value}: these operands do not reach the kernels")
    if not bits_equal(out, ozt.gemm(a, b, mode=chosen)):
        raise AssertionError(f"AUTO output differs from mode={chosen.value}")
    rows, cols = block(rng, N, N)
    r = residual(out[rows][:, cols].cpu().numpy(), reference_gemm(a_np[rows], b_np[:, cols]))
    if counts["split_digits"] < 2 or counts["recombine"] < 1 or counts["epilogue"] < 1:
        raise AssertionError(f"the AUTO path did not launch the kernels: {counts}")
    print(f"[auto] bits == gemm(mode={chosen.value}); sampled 64x256 block "
          f"relative_residual={r['relative_residual']:.3e}; launches {counts}", flush=True)
    del out
    ms_est = cuda_ms(lambda: auto_mode_select(a, b, N, 0.0), iters=3)
    ms_auto = cuda_ms(lambda: ozt.gemm(a, b, handle=h), iters=2)
    print(f"[time] {label}: AUTO estimator on both {N}^2 operands: {ms_est:.3f} ms; gemm AUTO "
          f"({chosen.value}) {N}^3: {ms_auto:.3f} ms, {2 * N**3 / ms_auto / 1e9:.3f} effective "
          f"FP64 TFLOPS", flush=True)
    return counts


def plain_zgemm(a_re, a_im, b_re, b_im, ns, alpha, beta, c_re, c_im):
    """The complex engine on the plain split, the plain recombine and the
    plain fold (``_zfold_block``)."""
    from ozimmu_tpu_torch.core.gemm import ZGEMM_PASSES, _exponent_plane, _zfold_block
    from ozimmu_tpu_torch.ops.recombine import acc_shift, fold_group_totals, group_totals
    from ozimmu_tpu_torch.ops.split import row_exponent_plain, split_with_row_exp
    from ozimmu_tpu_torch.schedule import bits_per_int8

    m, k = a_re.shape
    n = b_re.shape[1]
    bb = bits_per_int8(k)

    def split(x, axis):
        return split_with_row_exp(x, row_exponent_plain(x, axis), ns, bb, axis)

    a_planes = {0: split(a_re, 1), 1: split(a_im, 1)}
    b_planes = {0: split(b_re, 0), 1: split(b_im, 0)}
    SEs = []
    for ap, bp in ZGEMM_PASSES:
        da, pa = a_planes[ap]
        db, pb = b_planes[bp]
        S = fold_group_totals(group_totals(da, db, ns, k, bb), ns, k, bb)
        SEs.append((S, _exponent_plane(pa, pb, acc_shift(ns, bb))))
    return _zfold_block(SEs, m, n, complex(alpha), complex(beta), c_re, c_im, a_re.device)


def phase_zgemm(ozt, label, rng) -> dict:
    """9. ZGEMM at 8192^3 fp64_int8_9 on complex urand01 operands, and a
    1000x1234x777 op_a=C probe with complex alpha, beta and c."""
    from ozimmu_tpu_torch.schedule import effective_flops
    from ozimmu_tpu_torch.testing import generate_input, reference_gemm

    a_np = generate_input("urand01", (N, N), seed=40, complex_=True)
    b_np = generate_input("urand01", (N, N), seed=41, complex_=True)
    a = torch.from_numpy(a_np).cuda()
    b = torch.from_numpy(b_np).cuda()
    reset_launches()
    out = ozt.gemm(a, b, mode=f"fp64_int8_{NS}")
    counts = read_launches()
    if counts != gemms(complex_=1):
        raise AssertionError(f"ZGEMM launches {counts}, expected {gemms(complex_=1)}")
    planes = [x.contiguous() for x in (a.real, a.imag, b.real, b.imag)]
    re, im = plain_zgemm(*planes, NS, 1.0, 0.0, None, None)
    if not (bits_equal(out.real.contiguous(), re) and bits_equal(out.imag.contiguous(), im)):
        raise AssertionError("ZGEMM output differs from the plain pipeline")
    del re, im, planes
    if not (torch.isfinite(out.real).all() and torch.isfinite(out.imag).all()):
        raise AssertionError("non-finite values in the ZGEMM output")
    rows, cols = block(rng, N, N)
    r = complex_residual(out[rows][:, cols].cpu().numpy(),
                         reference_gemm(a_np[rows], b_np[:, cols]))
    print(f"[zgemm] gemm fp64_int8_{NS} complex128 {N}^3: bits == plain pipeline; sampled "
          f"64x256 block relative_residual={r:.3e}; launches {counts}", flush=True)
    del out
    flops = effective_flops(N, N, N, complex_=True)
    ms_z = cuda_ms(lambda: ozt.gemm(a, b, mode=f"fp64_int8_{NS}"), iters=3)
    ms_zm = cuda_ms(lambda: torch.matmul(a, b), iters=3)
    print(f"[time] {label}: ZGEMM fp64_int8_{NS} {N}^3: {ms_z:.3f} ms, {flops / ms_z / 1e9:.3f} "
          f"effective FP64 TFLOPS; torch.matmul complex128: {ms_zm:.3f} ms, "
          f"{flops / ms_zm / 1e9:.3f} TFLOPS", flush=True)
    del a, b

    m, n, k = 1000, 1234, 777
    ah_np = generate_input("normal01", (k, m), seed=42, complex_=True)  # op_a="C" reads [m, k]
    bp_np = generate_input("normal01", (k, n), seed=43, complex_=True)
    cp_np = generate_input("normal01", (m, n), seed=44, complex_=True)
    alpha, beta = 2.0 - 0.5j, 0.25 + 1.0j
    got = ozt.gemm(ah_np, bp_np, mode=f"fp64_int8_{NS}", op_a="C", alpha=alpha, beta=beta,
                   c=cp_np, device="cuda")
    rows, cols = block(rng, m, n)
    ref = (alpha * reference_gemm(np.conj(ah_np).T[rows], bp_np[:, cols])
           + beta * cp_np[rows][:, cols].astype(np.clongdouble))
    r = complex_residual(got[rows][:, cols], ref)
    xr, xi, yr, yi = (torch.from_numpy(np.ascontiguousarray(p)).cuda()
                      for p in (ah_np.T.real, -ah_np.T.imag, bp_np.real, bp_np.imag))
    one = ozt.zgemm_f64(xr, xi, yr, yi, NS, alpha=alpha, n_chunks=1)
    three = ozt.zgemm_f64(xr, xi, yr, yi, NS, alpha=alpha, n_chunks=3)
    if not all(bits_equal(o, t) for o, t in zip(one, three)):
        raise AssertionError("ZGEMM n_chunks=3 differs from n_chunks=1")
    print(f"[probe] zgemm {m}x{n}x{k} op_a=C alpha={alpha} beta={beta}: "
          f"relative_residual={r:.3e}; n_chunks=3 == n_chunks=1 bitwise", flush=True)
    return counts


def phase_sgemm(ozt) -> None:
    """10. sgemm at 4096^3: demoted operands equal the plain path's (the
    same torch ops on the CPU), the product lies within the f32 bound of an
    f64 product of the demoted operands, and a caller's TF32 setting
    neither leaks in nor is lost; one complex probe."""
    from ozimmu_tpu_torch.core.api import _f64_to_f32
    from ozimmu_tpu_torch.testing import generate_input

    n = 4096
    a_np = generate_input("normal01", (n, n), seed=50)
    b_np = generate_input("normal01", (n, n), seed=51)
    a, b = torch.from_numpy(a_np).cuda(), torch.from_numpy(b_np).cuda()
    a32, b32 = _f64_to_f32(a), _f64_to_f32(b)
    if not (bits_equal(a32.cpu(), _f64_to_f32(torch.from_numpy(a_np)))
            and bits_equal(b32.cpu(), _f64_to_f32(torch.from_numpy(b_np)))):
        raise AssertionError("demoted operands differ from the plain (CPU) demotion")
    got = ozt.gemm(a, b, mode="sgemm")
    ref = a32.double() @ b32.double()
    bound = 2 * n * 2.0**-24 * (a32.double().abs() @ b32.double().abs())
    worst = float(((got - ref).abs() / bound).max())
    if not worst <= 1.0:
        raise AssertionError(f"sgemm error {worst:.3f} x the bound 2*k*2^-24*(|a|@|b|)")
    saved = torch.backends.cuda.matmul.fp32_precision
    torch.backends.cuda.matmul.fp32_precision = "tf32"
    try:
        tf32_on = ozt.gemm(a, b, mode="sgemm")
        kept = torch.backends.cuda.matmul.fp32_precision
    finally:
        torch.backends.cuda.matmul.fp32_precision = saved
    if not bits_equal(tf32_on, got) or kept != "tf32":
        raise AssertionError(
            f"a caller's TF32 setting changed the sgemm result or was lost ({kept})")
    print(f"[sgemm] {n}^3: demoted operands == plain demotion bitwise; max |err| / bound = "
          f"{worst:.3e} (bound 2*k*2^-24*(|a|@|b|) against the f64 product of the demoted "
          f"operands); the caller's TF32 setting kept out and restored", flush=True)
    del a, b, a32, b32, got, ref, bound, tf32_on
    m = 1024
    ac = generate_input("normal01", (m, m), seed=52, complex_=True)
    bc = generate_input("normal01", (m, m), seed=53, complex_=True)
    got = ozt.gemm(ac, bc, mode="sgemm", device="cuda")
    ar, ai, br, bi = (_f64_to_f32(torch.from_numpy(np.ascontiguousarray(p)).cuda()).double()
                      for p in (ac.real, ac.imag, bc.real, bc.imag))
    ref_re, ref_im = ar @ br - ai @ bi, ar @ bi + ai @ br
    bound = 4 * m * 2.0**-24 * ((ar.abs() + ai.abs()) @ (br.abs() + bi.abs()))
    err = torch.maximum((torch.from_numpy(got.real.copy()).cuda() - ref_re).abs(),
                        (torch.from_numpy(got.imag.copy()).cuda() - ref_im).abs())
    worst = float((err / bound).max())
    if not worst <= 1.0:
        raise AssertionError(f"complex sgemm error {worst:.3f} x the bound")
    print(f"[sgemm] complex {m}^3: max |err| / bound = {worst:.3e} "
          f"(bound 4*k*2^-24*((|ar|+|ai|)@(|br|+|bi|)))", flush=True)


#: phase 11's batches: (B, m, k, n, kind, budget MiB or None for the
#: default).  8 x 1024^3 as before; 64 x 256^3, products too small to fill
#: the card one at a time; an odd batch (m, k and n off every tile and
#: k % 16 != 0), so that a tile reaching past one matrix's last row reads
#: zeros and not the next matrix's rows; 4 x 4096^3, also under a 3 GiB
#: budget, where the batch runs in two sub-batches (1.09 GiB of working set
#: per matrix: the epilogue kernel holds no temporaries)
BATCH_CASES = ((8, 1024, 1024, 1024, "real", None), (8, 1024, 1024, 1024, "complex", None),
               (64, 256, 256, 256, "real", None), (5, 1000, 777, 513, "real", None),
               (4, 4096, 4096, 4096, "real", None), (4, 4096, 4096, 4096, "real", 3072))


def wall_ms(fn, iters: int = 3) -> float:
    """Mean host milliseconds of ``fn`` over ``iters`` calls after one
    warm-up call, the device's work included (synchronised)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / iters * 1e3


def busy_ms(fn, name: str):
    """(busy ms, window ms, device kernels) of one traced call of ``fn``:
    the union of the device's spans inside it (``busy_in_window``) and the
    kernels that ran in it."""
    torch.cuda.synchronize()
    events = traced_events(fn, name)
    busy, window = busy_in_window(events, name)
    (win,) = [e for e in events if e.get("name") == name and e.get("cat") == "user_annotation"]
    t0 = float(win["ts"])
    kernels = sum(1 for e in events
                  if e.get("cat") == "kernel" and t0 <= float(e["ts"]) <= t0 + window)
    return busy / 1e3, window / 1e3, kernels


#: the device kernels of the split and of the exponent max, by name
SPLIT_KERNELS = ("split_rows_kernel", "split_tiles_kernel")
EXPONENT_KERNELS = ("exponent_rows_kernel", "exponent_cols_kernel")


def batched_kernels_equal_plain(a: torch.Tensor, b: torch.Tensor, ns: int) -> dict:
    """The kernels, one launch each over the batch a [B, m, k] @ b [B, k, n]
    (A by rows, B by columns, k-major planes as the engine splits them),
    bitwise against their plain versions on the same inputs; returns each
    kernel's (ms, the plain version's ms (CUDA events), the bound,
    max |kernel - plain|, the ms of one 2-D launch per matrix), the B
    operand's split and exponent ms, and the tile class.  The split's and
    the exponent max's ms are their kernels' device time (``kernel_ms``):
    one call over such a batch is short enough that CUDA events around it
    see the host's issue time."""
    from ozimmu_tpu_torch.ops import exponent_cuda, recombine_cuda, split_cuda
    from ozimmu_tpu_torch.ops.recombine import fold_group_totals, group_totals, padded_k
    from ozimmu_tpu_torch.ops.split import row_exponent_plain, split_with_row_exp
    from ozimmu_tpu_torch.schedule import bits_per_int8

    bsz, m, k = a.shape
    n = b.shape[2]
    bb = bits_per_int8(k)
    kp = padded_k(k)
    planes, err = [], {"split_digits": 0.0, "row_exponent": 0.0}
    for x, axis in ((a, 1), (b, 0)):
        e = row_exponent_plain(x, axis)
        got_e = exponent_cuda.exponent_max(x, axis)
        err["row_exponent"] = max(err["row_exponent"], float((got_e - e).abs().max().item()))
        if not torch.equal(got_e, e):
            raise AssertionError(f"batched exponent kernel != plain: {bsz} x {m}x{k}x{n} "
                                 f"axis={axis}")
        want, _ = split_with_row_exp(x, e, ns, bb, axis, kp)
        got = split_cuda.split_digits(x, e, ns, bb, axis, kp)
        err["split_digits"] = max(err["split_digits"], float(
            (want.to(torch.int16) - got.to(torch.int16)).abs().max().item()))
        if not bits_equal(want, got):
            raise AssertionError(f"batched split kernel != plain: {bsz} x {m}x{k}x{n} axis={axis}")
        planes.append(got)
    da, db = planes
    want = fold_group_totals(group_totals(da, db, ns, k, bb, b_kmajor=True), ns, k, bb)
    got = recombine_cuda.recombine(da, db, ns, bb, k, b_kmajor=True)
    err["recombine"] = max(float((w - g).abs().max().item()) for w, g in zip(want, got))
    if not all(bits_equal(w, g) for w, g in zip(want, got)):
        raise AssertionError(f"batched recombine kernel != plain: {bsz} x {m}x{k}x{n}")
    del want, got
    e_a = exponent_cuda.exponent_max(a, 1)
    e_b = exponent_cuda.exponent_max(b, 0)
    pairs = ns * (ns + 1) // 2
    one = [(da[:, i].contiguous(), db[:, i].contiguous()) for i in range(bsz)]
    loops = {
        "split_digits": kernel_ms(lambda: [split_cuda.split_digits(a[i], e_a[i], ns, bb, 1, kp)
                                           for i in range(bsz)], SPLIT_KERNELS, iters=3),
        "row_exponent": kernel_ms(lambda: [exponent_cuda.exponent_max(a[i], 1)
                                           for i in range(bsz)], EXPONENT_KERNELS, iters=3),
        "recombine": cuda_ms(lambda: [recombine_cuda.recombine(x, y, ns, bb, k, b_kmajor=True)
                                      for x, y in one], iters=3),
    }
    del one
    return {
        "split_digits": (
            kernel_ms(lambda: split_cuda.split_digits(a, e_a, ns, bb, 1, kp), SPLIT_KERNELS, 10),
            cuda_ms(lambda: split_with_row_exp(a, e_a, ns, bb, 1, kp), iters=3),
            bound_ms(a.numel() * 8 + e_a.numel() * 4 + da.numel(), 0, INT8_OPS_PER_S),
            err["split_digits"], loops["split_digits"]),
        "row_exponent": (
            kernel_ms(lambda: exponent_cuda.exponent_max(a, 1), EXPONENT_KERNELS, 10),
            cuda_ms(lambda: row_exponent_plain(a, 1), iters=3),
            bound_ms(a.numel() * 8 + e_a.numel() * 4, 0, INT8_OPS_PER_S),
            err["row_exponent"], loops["row_exponent"]),
        "recombine": (
            cuda_ms(lambda: recombine_cuda.recombine(da, db, ns, bb, k, b_kmajor=True), iters=3),
            cuda_ms(lambda: fold_group_totals(group_totals(da, db, ns, k, bb, b_kmajor=True),
                                              ns, k, bb), iters=3),
            bound_ms(da.numel() + db.numel() + 12 * bsz * m * n, pairs * 2 * bsz * m * n * k,
                     INT8_OPS_PER_S),
            err["recombine"], loops["recombine"]),
        "B": {
            "split_digits": kernel_ms(lambda: split_cuda.split_digits(b, e_b, ns, bb, 0, kp),
                                      SPLIT_KERNELS, 10),
            "row_exponent": kernel_ms(lambda: exponent_cuda.exponent_max(b, 0),
                                      EXPONENT_KERNELS, 10),
        },
        "tile": recombine_cuda.launch_plan(
            m, n, k, ns, torch.cuda.get_device_properties(0).multi_processor_count,
            batch=bsz).tile,
    }


def phase_batched(ozt, label):
    """11. gemm_batched, fp64_int8_9 with alpha, beta and c, at each of
    :data:`BATCH_CASES`: one split launch per operand and one recombine
    launch per sub-batch (4 + 4 complex), the result bitwise equal to a
    loop of 2-D ``gemm`` calls (the batch matrix by matrix), both kernels
    bitwise equal to their plain versions on the batch; wall ms, the
    card's busy ms and device kernels in one traced call of the batch and
    of the loop, the loop's ms and batched ``torch.matmul``'s ms.  Returns the launches by case and the batched
    kernels' figures at 8 x 1024^3."""
    from ozimmu_tpu_torch.core.gemm import _sub_batches
    from ozimmu_tpu_torch.testing import generate_input

    mode = f"fp64_int8_{NS}"
    counts, kernel_figs = {}, None
    for bsz, m, k, n, kind, budget in BATCH_CASES:
        cx = kind == "complex"
        what = f"{bsz} x {m}x{k}x{n} {kind}" + (f" under a {budget} MiB budget" if budget else "")
        seed = 60 + m % 97
        a = torch.from_numpy(generate_input("normal01", (bsz, m, k), seed=seed, complex_=cx)).cuda()
        b = torch.from_numpy(generate_input("exp_rand-8", (bsz, k, n), seed=seed + 1,
                                            complex_=cx)).cuda()
        c = torch.from_numpy(generate_input("normal01", (bsz, m, n), seed=seed + 2,
                                            complex_=cx)).cuda()
        alpha, beta = (1.5 - 0.5j, 0.5 + 0.25j) if cx else (1.5, -0.5)
        batched = lambda: ozt.gemm_batched(a, b, mode=mode, alpha=alpha, beta=beta, c=c)  # noqa: E731
        loop = lambda: [ozt.gemm(a[i], b[i], mode=mode, alpha=alpha, beta=beta, c=c[i])  # noqa: E731
                        for i in range(bsz)]
        with hbm_budget_mb(budget) if budget else contextlib.nullcontext():
            parts = _sub_batches(bsz, m, n, k, NS, cx, "cuda")
            if parts is None or (budget is None) != (len(parts) == 1):
                raise AssertionError(f"batched {what}: sub-batches {parts}")
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            before = torch.cuda.memory_allocated()
            reset_launches()
            out = batched()
            got = counts[f"batched_{kind}_{bsz}x{m}" + ("_budget" if budget else "")] = read_launches()
            peak = torch.cuda.max_memory_allocated() - before
            if got != (gemms(complex_=len(parts)) if cx else gemms(len(parts))):
                raise AssertionError(f"batched {what}: launches {got} for {len(parts)} sub-batch(es)")
            as_real = torch.view_as_real if cx else (lambda x: x)
            for i, want in enumerate(loop()):
                if not bits_equal(as_real(out[i]), as_real(want)):
                    raise AssertionError(f"batched {what}: matrix {i} differs from the 2-D gemm")
            del out
            ms_b = wall_ms(batched)
            busy, window, n_kernels = busy_ms(batched, "batched_gemm")
            ms_loop = wall_ms(loop)
            busy_loop, _, n_loop = busy_ms(loop, "loop_of_gemm")
        ms_mm = cuda_ms(lambda: torch.matmul(a, b), iters=3)
        print(f"[batched] {what} {mode} with c: bits == loop of 2-D gemm; launches {got} in "
              f"{len(parts)} sub-batch(es); peak {peak / 2**30:.3f} GiB allocated during the call",
              flush=True)
        print(f"[time] {label}: gemm_batched {what} {mode} with c: wall {ms_b:.3f} ms, card busy "
              f"{busy:.3f} ms of a {window:.3f} ms traced call, {n_kernels} device kernels; loop "
              f"of {bsz} 2-D gemm {ms_loop:.3f} ms, card busy {busy_loop:.3f} ms, {n_loop} device "
              f"kernels; batched torch.matmul {'complex128' if cx else 'float64'} {ms_mm:.3f} ms",
              flush=True)
        if budget is None:
            figs = batched_kernels_equal_plain(a.real.contiguous() if cx else a,
                                               b.real.contiguous() if cx else b, NS)
            print(f"[batched] {what}: exponent, split (k-major planes) and recombine kernels == "
                  f"plain bitwise, one launch each over the batch (recombine tile class "
                  f"{figs['tile']})", flush=True)
            for name in ("split_digits", "row_exponent", "recombine"):
                k_ms, p_ms, (b_ms, b_by), _, loop_ms = figs[name]
                dev_time = " device time" if name != "recombine" else ""
                b_side = (f"A; B by columns {figs['B'][name]:.4f} ms; " if name in figs["B"] else "")
                print(f"[time] {label}: batched {name} at {what}: kernel {k_ms:.4f} ms{dev_time} "
                      f"({b_side}one 2-D launch per matrix: {loop_ms:.4f} ms), plain PyTorch "
                      f"{p_ms:.3f} ms, bound {b_ms:.4f} ms ({b_by}), {b_ms / k_ms:.1%} of the "
                      f"bound", flush=True)
            if kernel_figs is None:
                kernel_figs = figs
        del a, b, c
        torch.cuda.empty_cache()
    return counts, kernel_figs


def busy_in_window(events, name: str):
    """(busy, window) in microseconds: the union of the device's kernel and
    copy spans inside the ``record_function`` window called ``name``."""
    (win,) = [e for e in events if e.get("name") == name and e.get("cat") == "user_annotation"]
    w0, w1 = float(win["ts"]), float(win["ts"]) + float(win["dur"])
    spans = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in events
                   if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"))
    busy, end = 0.0, w0
    for s0, s1 in spans:
        s0, s1 = max(s0, end), min(s1, w1)
        if s1 > s0:
            busy += s1 - s0
            end = s1
    return busy, w1 - w0


def phase_trace(ozt) -> None:
    """12. device_trace of one 4096^3 fp64_int8_9 GEMM: the exponent, split, recombine and
    epilogue kernels in the trace, and the device's busy share over the traced window."""
    from ozimmu_tpu_torch.testing import generate_input

    n = 4096
    a = torch.from_numpy(generate_input("urand01", (n, n), seed=70)).cuda()
    b = torch.from_numpy(generate_input("urand01", (n, n), seed=71)).cuda()
    ozt.gemm(a, b, mode=f"fp64_int8_{NS}")  # warm
    torch.cuda.synchronize()
    events = traced_events(lambda: ozt.gemm(a, b, mode=f"fp64_int8_{NS}"), "traced_gemm")
    busy, window = busy_in_window(events, "traced_gemm")
    (win,) = [e for e in events if e.get("name") == "traced_gemm" and e.get("cat") == "user_annotation"]
    t0 = float(win["ts"])
    kernels = [e for e in events if e.get("cat") == "kernel" and t0 <= float(e["ts"]) <= t0 + window]
    names = {e["name"] for e in kernels}
    wanted = ("exponent_rows_kernel", "exponent_cols_kernel", "split_rows_kernel",
              "split_tiles_kernel", "recombine_kernel", "epilogue_kernel")
    for want in wanted:
        if not any(want in nm for nm in names):
            raise AssertionError(f"{want} not in the traced kernels {sorted(names)}")
    print(f"[trace] {n}^3 fp64_int8_{NS}: {len(kernels)} device kernels traced, incl. "
          f"{', '.join(wanted)}; device busy {busy / 1e3:.3f} ms of a "
          f"{window / 1e3:.3f} ms window = busy share {busy / window:.4f}", flush=True)


def phase_warmup(ozt) -> None:
    """13. warmup of one shape and reallocate_working_memory of a list."""
    from ozimmu_tpu_torch.types import ElementKind, Operation

    h = ozt.create(device="cuda")
    t0 = time.perf_counter()
    ozt.warmup(2048, 2048, 2048, "fp64_int8_9", handle=h)
    t_w = time.perf_counter() - t0
    gemms = [(Operation.N, Operation.N, 2048, 1024, 2048, ElementKind.REAL, "fp64_int8_9"),
             (Operation.N, Operation.T, 1024, 1024, 4096, ElementKind.COMPLEX, "fp64_int8_12")]
    got = ozt.reallocate_working_memory(h, gemms)
    if got <= 0:
        raise AssertionError(f"reallocate_working_memory returned {got}")
    print(f"[warmup] warmup 2048^3 fp64_int8_9 in {t_w:.3f} s; reallocate_working_memory of "
          f"2 entries returned {got} B", flush=True)


def relative_residual(got: torch.Tensor, ref: torch.Tensor) -> float:
    """||got - ref||_F / ||ref||_F of two real tensors."""
    return float(torch.linalg.norm(got - ref) / torch.linalg.norm(ref))


def phase_intercept(ozt, label) -> dict:
    """14. Interception through a dispatch mode: ``a @ b`` at 8192^3 equals
    the direct call bitwise and launches split 2 and recombine 1; its time
    against the direct call (CUDA events) shows the mode's host overhead.
    Then a batched einsum, a conj-bit ``a.mH @ b``, an ``nn.Linear`` step
    (forward addmm and both backward mm routed), the 1024 size gate and
    ``OZIMMU_COMPUTE_MODE`` with no pinned mode."""
    import ozimmu_tpu_torch.intercept as ozi
    from ozimmu_tpu_torch.testing import generate_input

    mode = f"fp64_int8_{NS}"
    a = torch.from_numpy(generate_input("urand01", (N, N), seed=80)).cuda()
    b = torch.from_numpy(generate_input("urand01", (N, N), seed=81)).cuda()
    want = ozt.gemm(a, b, mode=mode)
    reset_launches()
    with ozi.intercept(mode=mode):
        got = a @ b
    counts = read_launches()
    if counts != gemms(1):
        raise AssertionError(f"intercepted {N}^3 launches {counts}, expected {gemms(1)}")
    if not bits_equal(got, want):
        raise AssertionError("intercepted a @ b differs from gemm(a, b)")
    del got, want
    with ozi.intercept(mode=mode):
        ms_int = cuda_ms(lambda: a @ b, iters=3)
    ms_dir = cuda_ms(lambda: ozt.gemm(a, b, mode=mode), iters=3)
    print(f"[intercept] a @ b {N}^3 under intercept(mode={mode}): bits == gemm(a, b); launches "
          f"{counts}", flush=True)
    print(f"[time] {label}: intercepted a @ b {N}^3: {ms_int:.3f} ms; direct gemm: {ms_dir:.3f} "
          f"ms; difference {ms_int - ms_dir:+.3f} ms", flush=True)
    del a, b

    B, n = 8, 1024
    a3 = torch.from_numpy(generate_input("normal01", (B, n, n), seed=82)).cuda()
    b3 = torch.from_numpy(generate_input("normal01", (B, n, n), seed=83)).cuda()
    reset_launches()
    with ozi.intercept(mode=mode):
        got = torch.einsum("bik,bkj->bij", a3, b3)
    c3 = read_launches()
    if c3 != gemms(1):
        raise AssertionError(f"intercepted einsum launches {c3}")
    if not bits_equal(got, ozt.gemm_batched(a3, b3, mode=mode)):
        raise AssertionError("intercepted einsum differs from gemm_batched")
    del a3, b3, got

    n = 2048
    x = torch.from_numpy(generate_input("normal01", (n, n), seed=84, complex_=True)).cuda()
    y = torch.from_numpy(generate_input("normal01", (n, n), seed=85, complex_=True)).cuda()
    reset_launches()
    with ozi.intercept(mode=mode):
        got = x.mH @ y
    cz = read_launches()
    want = ozt.gemm(x, y, mode=mode, op_a="C")
    if cz != gemms(complex_=1) or not bits_equal(
            torch.view_as_real(got), torch.view_as_real(want)):
        raise AssertionError(f"intercepted x.mH @ y: launches {cz} or bits differ")
    print(f"[intercept] einsum bik,bkj->bij {B} x 1024^3: bits == gemm_batched, launches {c3}; "
          f"complex x.mH @ y {n}^3: bits == gemm(op_a='C'), launches {cz}", flush=True)
    del x, y, got, want

    # On full-mantissa data native f64 at k = 4096 carries ~2e-15 of its own
    # rounding (one accumulator along k), more than the gate.  On a 2^-16
    # fixed-point grid in [-0.5, 0.5] every product and every sum of 4096
    # of them is exact in f64, so the native step is the exact answer and
    # the routed step must meet it.
    n = 4096
    rng = np.random.default_rng(86)

    def grid(*shape):
        return torch.from_numpy(np.round(rng.uniform(-0.5, 0.5, shape) * 2**16) / 2**16).cuda()

    layer = torch.nn.Linear(n, n, bias=True, dtype=torch.float64, device="cuda")
    with torch.no_grad():
        layer.weight.copy_(grid(n, n))
        layer.bias.copy_(grid(n))
    xin, gout = grid(n, n), grid(n, n)

    def step():
        layer.zero_grad(set_to_none=True)
        xr = xin.clone().requires_grad_(True)
        out = layer(xr)
        out.backward(gout)
        return out.detach(), xr.grad, layer.weight.grad, layer.bias.grad

    native = step()
    reset_launches()
    with ozi.intercept(mode=mode):
        routed = step()
    cl = read_launches()
    if cl != gemms(3):
        raise AssertionError(f"nn.Linear step launches {cl}, expected {gemms(3)} (addmm + 2 mm)")
    res = [relative_residual(r, nat) for r, nat in zip(routed, native)]
    if not max(res) < RESIDUAL_GATE:
        raise AssertionError(f"nn.Linear step differs from native f64: residuals {res}")
    print(f"[intercept] nn.Linear({n}, {n}) forward + backward on a [{n}, {n}] batch (2^-16 "
          f"grid): launches {cl}; relative residual vs the native f64 step of output, dx, dW, "
          f"db = " + ", ".join(f"{r:.3e}" for r in res), flush=True)
    del layer, xin, gout, native, routed

    small = torch.from_numpy(generate_input("urand01", (512, 512), seed=89)).cuda()
    a1 = torch.from_numpy(generate_input("urand01", (1024, 1024), seed=90)).cuda()
    reset_launches()
    with ozi.intercept(mode=mode):
        small @ small
    c512 = read_launches()
    saved = os.environ.get("OZIMMU_COMPUTE_MODE")
    os.environ["OZIMMU_COMPUTE_MODE"] = mode
    try:
        reset_launches()
        with ozi.intercept():
            got = a1 @ a1
        cenv = read_launches()
    finally:
        if saved is None:
            del os.environ["OZIMMU_COMPUTE_MODE"]
        else:
            os.environ["OZIMMU_COMPUTE_MODE"] = saved
    if c512 != gemms():
        raise AssertionError(f"a 512^3 product under the 1024 thresholds launched {c512}")
    if cenv != gemms(1) or not bits_equal(
            got, ozt.gemm(a1, a1, mode=mode)):
        raise AssertionError(f"OZIMMU_COMPUTE_MODE={mode} did not route the call: {cenv}")
    print(f"[intercept] 512^3 launches {c512}; OZIMMU_COMPUTE_MODE={mode} with no pinned mode "
          f"routes 1024^3: launches {cenv}, bits == gemm", flush=True)
    return counts


def phase_traced(ozt, label) -> dict:
    """15. ``traced.gemm`` at 8192^3 with alpha, beta and c inside
    ``torch.compile(fullgraph=True)`` (the default backend): bits equal the
    eager ``gemm`` and both kernels launch."""
    from ozimmu_tpu_torch import traced
    from ozimmu_tpu_torch.testing import generate_input

    a, b, c = (torch.from_numpy(generate_input("urand01", (N, N), seed=91 + i)).cuda()
               for i in range(3))
    f = torch.compile(lambda x, y, z: traced.gemm(x, y, num_split=NS, alpha=2.0, beta=-0.5, c=z),
                      fullgraph=True)
    t0 = time.perf_counter()
    reset_launches()
    got = f(a, b, c)
    counts = read_launches()
    t_first = time.perf_counter() - t0
    want = ozt.gemm(a, b, mode=f"fp64_int8_{NS}", alpha=2.0, beta=-0.5, c=c)
    if counts != gemms(1):
        raise AssertionError(f"compiled traced.gemm launches {counts}, expected {gemms(1)}")
    if not bits_equal(got, want):
        raise AssertionError("compiled traced.gemm differs from the eager gemm")
    ms_c = cuda_ms(lambda: f(a, b, c), iters=3)
    ms_e = cuda_ms(lambda: ozt.gemm(a, b, mode=f"fp64_int8_{NS}", alpha=2.0, beta=-0.5, c=c),
                   iters=3)
    print(f"[traced] torch.compile(fullgraph=True) of traced.gemm {N}^3 alpha=2 beta=-0.5 c: "
          f"bits == eager gemm; launches {counts}; first call (compile + run) {t_first:.2f} s",
          flush=True)
    print(f"[time] {label}: compiled traced.gemm {N}^3 alpha=2 beta=-0.5 c: {ms_c:.3f} ms; eager "
          f"gemm with the same arguments: {ms_e:.3f} ms", flush=True)
    return counts


def phase_bench(label) -> dict:
    """16. The bench CLI: one 8192^3 CSV row (sampled-block residual,
    TFLOPS), the 72-case ci_test at 513 (an odd size, an eighth of the
    oracle's work at 1025; the kernels' 1025 cases are in phase 4) and the
    power mode (NVML)."""
    from ozimmu_tpu_torch import bench_cli

    def run(fn, *args, **kw):
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = fn(*args, **kw)
        return rc, buf.getvalue().strip().splitlines(), time.perf_counter() - t0

    reset_launches()
    rc, lines, _ = run(bench_cli.main, ["urand01", "dgemm", f"fp64_int8_{NS}", "seq", str(N),
                                        str(N), "1", "--test-count", "3"])
    if rc != 0 or len(lines) != 2 or lines[0] != bench_cli.CSV_HEADER:
        raise AssertionError(f"bench_cli seq printed {lines} (rc {rc})")
    row = lines[1].split(",")
    if not (float(row[9]) < RESIDUAL_GATE and np.isfinite(float(row[11])) and float(row[11]) > 0):
        raise AssertionError(f"bench_cli row {lines[1]}")
    print(f"[bench] {lines[1]}", flush=True)

    rc, lines, t_ci = run(bench_cli.run_ci_test, sizes=(513,))
    worst = max(float(r.split(",")[9]) for r in lines[:-1])
    if rc != 0 or lines[-1] != "   72 /    72 PASSED" or len(lines) != 73:
        raise AssertionError(f"ci_test at 513: rc {rc}, last line {lines[-1]!r}")
    print(f"[bench] ci_test sizes=(513,): {lines[-1].strip()} in {t_ci:.1f} s; largest residual "
          f"{worst:.3e}", flush=True)

    rc, lines, _ = run(bench_cli.run_power, "dgemm", f"fp64_int8_{NS}", N, min_seconds=3)
    m = re.search(r"tflops=([0-9.eE+-]+),watts=([0-9.]+),gflops_per_w=([0-9.]+)$", lines[-1])
    if rc != 0 or not m:
        raise AssertionError(f"power mode printed {lines}")
    counts = read_launches()
    print(f"[bench] {lines[-1]}", flush=True)
    print(f"[time] {label}: power fp64_int8_{NS} {N}^3: {m[1]} TFLOPS at {m[2]} W = "
          f"{m[3]} GFLOPS/W", flush=True)
    return counts


def pa_lu_residual(a: torch.Tensor, lu: torch.Tensor, piv) -> float:
    """||P A - L U||_F / ||A||_F on the card, P from the getrf pivots."""
    n = a.shape[0]
    perm = np.arange(n)
    for i, p in enumerate(piv):
        perm[[i, p]] = perm[[p, i]]
    l = torch.tril(lu, -1)
    l.diagonal().fill_(1.0)
    pa = a[torch.from_numpy(perm).to(a.device)]
    return float(torch.linalg.norm(pa - l @ torch.triu(lu)) / torch.linalg.norm(a))


def step_launches(n: int, block: int, complex_: bool = False, factorizations: int = 1,
                  matvecs: int = 0) -> dict:
    """Launches of ``factorizations`` resident factorizations of an n x n
    matrix and ``matvecs`` engine matvecs: each step that has a trailing
    block runs two engine GEMMs (:func:`gemms`)."""
    count = 2 * (-(-n // block) - 1) * factorizations + matvecs
    return gemms(complex_=count) if complex_ else gemms(count)


def expect_launches(path: str, got: dict, want: dict) -> dict:
    if got != want or min(got["split_digits"], got["recombine"], got["epilogue"] + got["zfold"]) < 1:
        raise AssertionError(f"{path}: launches {got}, the step formula gives {want}")
    return got


def hpl_fields(line: str) -> dict:
    return dict(f.split("=") for f in line.split(",") if "=" in f)


def first_step_operands(size: int, blk: int, complex_: bool) -> dict:
    """The operands of the first step of the HPL (or ZHPL) matrix of
    ``bench_cli hpl``, at the solver's shapes, strides and exponent spread:
    ``l11inv`` and ``a12`` of the U12 product, ``l21`` and ``u12`` of the
    trailing update, the strided window ``c22`` that the solver passes as
    ``c``, and the unfactored ``panel``.  The panel is factored in plain f64
    (cuSOLVER); the diagonal dominates, so no row moves."""
    from ozimmu_tpu_torch import bench_cli, linalg

    a = bench_cli._hpl_matrix(size, 0, complex_, torch.device("cuda"))
    with linalg._cusolver_preferred(a.device):
        lu, _, info = linalg._panel_factor_device(a[:, :blk])
    if int(info) != 0:
        raise AssertionError(f"the first panel of the n={size} matrix is singular")
    l11inv = linalg._unit_lower_inverse_device(lu[:blk])
    return {"l11inv": l11inv, "a12": a[:blk, blk:], "l21": lu[blk:], "c22": a[blk:, blk:],
            "u12": l11inv @ a[:blk, blk:], "panel": a[:, :blk]}


def kernels_equal_plain_on(what: str, a: torch.Tensor, b: torch.Tensor, ns: int) -> str:
    """The kernels against their plain versions, bit for bit, on the
    float64 operands ``a`` [m, k] and ``b`` [k, n] of one engine product:
    the exponent max and the split of each as the engine launches them
    (k-major planes), then the recombine of the kernel's planes in the tile
    class that the launch plan picks for the shape, which is the launch the
    solver makes."""
    from ozimmu_tpu_torch.ops import exponent_cuda, recombine_cuda, split_cuda
    from ozimmu_tpu_torch.ops.recombine import fold_group_totals, group_totals, padded_k
    from ozimmu_tpu_torch.ops.split import row_exponent_plain, split_with_row_exp
    from ozimmu_tpu_torch.schedule import bits_per_int8

    a, b = a.contiguous(), b.contiguous()  # as core/gemm.py passes them
    (m, k), n = a.shape, b.shape[1]
    bb = bits_per_int8(k)
    planes = []
    for name, x, axis in (("A", a, 1), ("B", b, 0)):
        e = row_exponent_plain(x, axis)
        if not torch.equal(exponent_cuda.exponent_max(x, axis), e):
            raise AssertionError(f"{what}: exponent of {name} {tuple(x.shape)} differs from plain")
        want, _ = split_with_row_exp(x, e, ns, bb, axis, padded_k(k))
        got = split_cuda.split_digits(x, e, ns, bb, axis, padded_k(k))
        if not bits_equal(want, got):
            raise AssertionError(f"{what}: split of {name} {tuple(x.shape)} differs from plain")
        planes.append(got)
        del want
    da, db = planes
    want = fold_group_totals(group_totals(da, db, ns, k, bb, b_kmajor=True), ns, k, bb)
    got = recombine_cuda.recombine(da, db, ns, bb, k, b_kmajor=True)
    if not all(bits_equal(w, g) for w, g in zip(want, got)):
        raise AssertionError(f"{what}: recombine {m}x{n}x{k} ns={ns} differs from plain")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return f"{what} {m}x{n}x{k} (tile class {recombine_cuda.launch_plan(m, n, k, ns, sms).tile})"


def first_step_kernel_checks(size: int, blk: int, complex_: bool) -> list:
    """Every engine product of the first step of HPL (ZHPL) at ``size``,
    and the trailing update of the last step that has one (one block
    square), through :func:`kernels_equal_plain_on`; a complex product is
    four real ones on the planes."""
    ops = first_step_operands(size, blk, complex_)
    return products_equal_plain((("U12 = L11inv @ A12", ops["l11inv"], ops["a12"]),
                                 ("A22 -= L21 @ U12", ops["l21"], ops["u12"]),
                                 ("last A22 -= L21 @ U12", ops["l21"][-blk:],
                                  ops["u12"][:, -blk:])), complex_)


def products_equal_plain(products, complex_: bool) -> list:
    """:func:`kernels_equal_plain_on` for each ``(name, a, b)`` engine
    product; a complex product is four real ones on the planes."""
    parts = (lambda t: (("re", t.real), ("im", t.imag))) if complex_ else (lambda t: (("", t),))
    done = []
    for name, x, y in products:
        for px_name, px in parts(x):
            for py_name, py in parts(y):
                tag = f" [{px_name} x {py_name}]" if complex_ else ""
                done.append(kernels_equal_plain_on(name + tag, px, py, NS))
    return done


def memory_against_model(what: str, call, a: torch.Tensor, b: torch.Tensor) -> int:
    """Run ``call``, a GEMM of ``a`` [m, k] by ``b`` [k, n], and hold its
    peak device memory against the working-set model
    (``schedule.working_set_bytes_chunked`` at the planned column panels):
    on the card the epilogue is a kernel with no temporaries, so the model
    alone bounds the call.  The measured peak is what the call allocated
    on top of what was allocated before it, plus the two operands, which
    the model counts.  Returns that peak."""
    from ozimmu_tpu_torch.schedule import auto_n_chunks, hbm_budget_bytes, working_set_bytes_chunked

    (m, k), n = a.shape, b.shape[1]
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    call()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - before + (a.numel() + b.numel()) * 8
    chunks = auto_n_chunks(m, n, k, NS, device="cuda")
    model = working_set_bytes_chunked(m, n, k, NS, chunks)
    limit = 1.1 * model
    print(f"[memory] {what} {m}x{n}x{k} fp64_int8_{NS}: peak {peak / 2**30:.3f} GiB (allocated "
          f"during the call + the operands); model {model / 2**30:.3f} GiB at {chunks} column "
          f"panel(s) (budget {hbm_budget_bytes('cuda') / 2**30:.3f} GiB, "
          f"{before / 2**30:.3f} GiB held before), limit +10 % = {limit / 2**30:.3f} GiB",
          flush=True)
    if not peak <= limit:
        raise AssertionError(f"{what}: peak {peak} B above the model's limit {limit:.0f} B")
    return peak


@contextlib.contextmanager
def hbm_budget_mb(mb: int):
    """``OZIMMU_HBM_BUDGET_MB`` set to ``mb`` inside the block."""
    saved = os.environ.get("OZIMMU_HBM_BUDGET_MB")
    os.environ["OZIMMU_HBM_BUDGET_MB"] = str(mb)
    try:
        yield
    finally:
        if saved is None:
            del os.environ["OZIMMU_HBM_BUDGET_MB"]
        else:
            os.environ["OZIMMU_HBM_BUDGET_MB"] = saved


def phase_solvers(ozt, label) -> dict:
    """17. The solvers.  Small sizes first, each path counted and held
    against the same call on CPU tensors (the plain versions) or against
    its residual gate; then HPL n = 16384 and ZHPL n = 8192 through the
    bench CLI beside ``torch.linalg.lu_factor``, both kernels against their
    plain versions on the products of those runs' first step, and the
    first trailing update of that HPL staged by the handle's profiler."""
    from ozimmu_tpu_torch import bench_cli, linalg
    from ozimmu_tpu_torch.ops import recombine_cuda
    from ozimmu_tpu_torch.ops.recombine import padded_k
    from ozimmu_tpu_torch.ops.split import split_f64, split_f64_cols
    from ozimmu_tpu_torch.schedule import auto_n_chunks, bits_per_int8

    mode = f"fp64_int8_{NS}"
    as_real = lambda t: torch.view_as_real(t) if t.is_complex() else t  # noqa: E731
    counts = {}
    torch.cuda.empty_cache()

    # real and complex LU: host panels bitwise against the CPU run, device
    # panels with the same pivots
    for path, n, blk, cx in (("lu", 1024, 256, False), ("zlu", 512, 128, True)):
        rng = np.random.default_rng(100 + n)
        a_np = rng.uniform(-1, 1, (n, n)) + (1j * rng.uniform(-1, 1, (n, n)) if cx else 0.0)
        a_cpu = torch.from_numpy(a_np)
        a = a_cpu.cuda()
        reset_launches()
        lu, piv = linalg.lu_factor(a, mode=mode, block=blk)
        counts[path] = expect_launches(path, read_launches(), step_launches(n, blk, cx))
        lu_cpu, piv_cpu = linalg.lu_factor(a_cpu, mode=mode, block=blk)
        if not (np.array_equal(piv, piv_cpu) and bits_equal(as_real(lu.cpu()), as_real(lu_cpu))):
            raise AssertionError(f"{path}: the factor on the card differs from the CPU run")
        if not torch.equal(a.cpu(), a_cpu):
            raise AssertionError(f"{path}: the caller's tensor was changed")
        r_host = pa_lu_residual(a, lu, piv)
        reset_launches()
        lu_d, piv_d = linalg.lu_factor(a, mode=mode, block=blk, panel="device")
        got = expect_launches(f"{path} with device panels", read_launches(),
                              step_launches(n, blk, cx))
        if not cx:
            counts["lu_device_panels"] = got
        r_dev = pa_lu_residual(a, lu_d, piv_d)
        if not np.array_equal(piv_d, piv):
            raise AssertionError(f"{path}: device panels chose other pivots than host panels")
        if not max(r_host, r_dev) < 1e-14:
            raise AssertionError(f"{path}: ||PA - LU||/||A|| {r_host:.3e} / {r_dev:.3e} >= 1e-14")
        print(f"[solvers] {'complex ' if cx else ''}LU n={n} block={blk} {mode}: host panels == "
              f"CPU run bitwise (factor and pivots), ||PA-LU||/||A|| {r_host:.3e}; device panels "
              f"same pivots, {r_dev:.3e}, max |lu_dev - lu_host| / max |lu_host| "
              f"{float((lu_d - lu).abs().max() / lu.abs().max()):.3e}; launches {counts[path]}",
              flush=True)

    # resident Cholesky
    n, blk = 1024, 256
    g = np.random.default_rng(110).standard_normal((n, n))
    s_cpu = torch.from_numpy(g @ g.T + n * np.eye(n))
    s = s_cpu.cuda()
    reset_launches()
    l = linalg.cholesky(s, mode=mode, block=blk)
    counts["cholesky"] = expect_launches("cholesky", read_launches(), step_launches(n, blk))
    if not bits_equal(l.cpu(), linalg.cholesky(s_cpu, mode=mode, block=blk)):
        raise AssertionError("cholesky: the factor on the card differs from the CPU run")
    r = float(torch.linalg.norm(s - l @ l.T) / torch.linalg.norm(s))
    if not r < 1e-14 or torch.triu(l, 1).any():
        raise AssertionError(f"cholesky: ||A - LL^T||/||A|| {r:.3e} or a nonzero upper triangle")
    try:
        linalg.cholesky(torch.complex(s, torch.zeros_like(s)), mode=mode, block=blk)
    except ValueError as e:
        refusal = str(e)
    else:
        raise AssertionError("resident cholesky took a complex matrix")
    print(f"[solvers] Cholesky n={n} block={blk} {mode}: == CPU run bitwise, ||A-LL^T||/||A|| "
          f"{r:.3e}; launches {counts['cholesky']}; complex input refused ({refusal!r})",
          flush=True)

    # solve on a resident matrix, factored cheaply and refined
    n, blk = 2048, 256
    rng = np.random.default_rng(120)
    a_np = rng.uniform(-1, 1, (n, n)) + n * np.eye(n)
    b_np = a_np @ rng.standard_normal(n)
    a = torch.from_numpy(a_np).cuda()
    scaled = lambda x: float(np.linalg.norm(a_np @ x - b_np) / (  # noqa: E731
        np.linalg.norm(a_np) * np.linalg.norm(x) + np.linalg.norm(b_np)))
    r0 = scaled(linalg.solve(a, b_np, mode="fp64_int8_6", block=blk))
    reset_launches()
    x = linalg.solve(a, b_np, mode="fp64_int8_6", block=blk, refine=2)
    counts["solve"] = expect_launches("solve", read_launches(), step_launches(n, blk, matvecs=2))
    if not scaled(x) < 1e-15:
        raise AssertionError(f"solve: scaled residual {scaled(x):.3e} >= 1e-15 after refine=2")
    m = 1030  # not a multiple of the block
    am = torch.from_numpy(rng.uniform(-1, 1, (m, m))).cuda()
    reset_launches()
    lu, piv = linalg.lu_factor(am, mode=mode, block=blk, panel="device")
    expect_launches("lu n=1030", read_launches(), step_launches(m, blk))
    r_m = pa_lu_residual(am, lu, piv)
    if not r_m < 1e-14:
        raise AssertionError(f"LU n={m}: ||PA - LU||/||A|| {r_m:.3e} >= 1e-14")
    for panel in ("host", "device"):
        try:
            linalg.lu_factor(torch.ones((512, 512), dtype=torch.float64, device="cuda"),
                             mode=mode, block=128, panel=panel)
        except np.linalg.LinAlgError:
            continue
        raise AssertionError(f"a singular matrix did not raise with {panel} panels")
    print(f"[solvers] solve n={n} fp64_int8_6 block={blk}: scaled residual {r0:.3e} unrefined, "
          f"{scaled(x):.3e} after refine=2 (residuals at fp64_int8_12 on the card); launches "
          f"{counts['solve']}; LU n={m} block={blk} device panels ||PA-LU||/||A|| {r_m:.3e}; "
          f"singular 512^2 raises with both panel kinds", flush=True)
    del a, am, lu, s, l

    # full width: HPL and ZHPL through the bench CLI
    def hpl(path, size, args, cx, factorizations):
        buf = io.StringIO()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        with contextlib.redirect_stdout(buf):
            rc = bench_cli.main(["hpl", mode, str(size), "--block", "1024", *args])
        got = expect_launches(path, read_launches(),
                              step_launches(size, 1024, cx, factorizations, matvecs=2))
        line = buf.getvalue().strip().splitlines()[-1]
        f = hpl_fields(line)
        if rc != 0 or not line.startswith("zhpl," if cx else "hpl,") or not (
                float(f["residual"]) < 1e-14):
            raise AssertionError(f"bench_cli hpl {args}: rc {rc}, line {line!r}")
        print(f"[solvers] {line}", flush=True)
        phases = ", ".join(f"{k} {float(v.rstrip('s')):.4f} s" for k, v in f.items()
                           if k.endswith("_s"))
        print(f"[time] {label}: {'ZHPL' if cx else 'HPL'} n={size} block=1024 {mode} "
              f"panel={f['panel']}: factor {float(f['factor_time'].rstrip('s')):.4f} s, "
              f"{f['gflops_x4' if cx else 'gflops']} effective FP64 GFLOPS at "
              f"{'8/3' if cx else '2/3'} n^3, scaled residual {f['residual']}"
              + (f"; instrumented pass: {phases}" if phases else "")
              + f"; peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
              f"launches {got}", flush=True)
        return got

    n_hpl, n_zhpl = 16384, 8192
    chunks = auto_n_chunks(n_hpl - 1024, n_hpl - 1024, 1024, NS, device="cuda")
    if chunks != 1:
        raise AssertionError(f"the first HPL update is planned in {chunks} column panels: the "
                             f"step formula for the launches assumes 1")
    counts["hpl"] = hpl("hpl", n_hpl, ["--warmup", "--profile"], False, 3)
    hpl("hpl with host panels", n_hpl, ["--panel", "host", "--profile"], False, 2)
    counts["zhpl"] = hpl("zhpl", n_zhpl, ["--dtype", "z", "--warmup", "--profile"], True, 3)

    # the library's factorization of the same matrices, as a yardstick
    for size, cx in ((n_hpl, False), (n_zhpl, True)):
        a = bench_cli._hpl_matrix(size, 0, cx, torch.device("cuda"))
        torch.linalg.lu_factor(a)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        torch.linalg.lu_factor(a)
        torch.cuda.synchronize()
        t = time.perf_counter() - t0
        print(f"[time] {label}: torch.linalg.lu_factor {a.dtype} {size}^2: {t:.4f} s, "
              f"{(8 if cx else 2) / 3 * size**3 / t / 1e9:.4g} GFLOPS at "
              f"{'8/3' if cx else '2/3'} n^3", flush=True)
        del a

    # both kernels at the shapes, strides and data of those two runs, bit
    # for bit against their plain versions
    for size, cx in ((n_zhpl, True), (n_hpl, False)):
        done = first_step_kernel_checks(size, 1024, cx)
        torch.cuda.empty_cache()
        print(f"[solvers] {'ZHPL' if cx else 'HPL'} n={size} block=1024 {mode}: split (both "
              f"operands) and recombine kernels == plain bitwise on {len(done)} products: "
              + "; ".join(done), flush=True)

    # the first panel of that HPL under torch's own choice of backend and
    # with cuSOLVER preferred, as the resident path factors it
    ops = first_step_operands(n_hpl, 1024, False)
    factor_panel = lambda: torch.linalg.lu_factor_ex(ops["panel"])  # noqa: E731
    ms_default = cuda_ms(factor_panel, iters=3)
    with linalg._cusolver_preferred(torch.device("cuda")):
        ms_cusolver = cuda_ms(factor_panel, iters=3)
    print(f"[time] {label}: torch.linalg.lu_factor_ex of the first {n_hpl} x 1024 panel: "
          f"{ms_default:.3f} ms with torch's default backend, {ms_cusolver:.3f} ms with cuSOLVER "
          f"preferred (as linalg.lu_factor(panel='device') sets it)", flush=True)

    # the first trailing update of that HPL, staged: m = n = 15360, k = 1024
    l21, u12, c22 = ops["l21"], ops["u12"], ops["c22"]
    m, k = l21.shape
    h = ozt.create(device="cuda")
    update = lambda: ozt.gemm(l21, u12, mode=mode, alpha=-1.0, beta=1.0, c=c22, handle=h)  # noqa: E731
    peak = memory_against_model("the first HPL trailing update", update, l21, u12) / 2**30
    with hbm_budget_mb(12 << 10):  # a smaller card's budget: the same single panel
        peak_12 = memory_against_model("the first HPL trailing update under a 12 GiB budget",
                                       update, l21, u12) / 2**30
    ms_update = cuda_ms(update, iters=2, warmup=0)
    ozt.enable_profiling(h)
    for _ in range(2):
        update()
    ozt.disable_profiling(h)
    staged = {name: ns_ / count / 1e6 for name, count, ns_, _ in h.profiler.result_rows()}
    bb = bits_per_int8(k)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    da, _ = split_f64(l21.contiguous(), NS, bb, padded_k(k))
    db, _ = split_f64_cols(u12, NS, bb, padded_k(k))
    ms_rec = cuda_ms(lambda: recombine_cuda.recombine(da, db, NS, bb, k, b_kmajor=True), iters=3)
    pairs = NS * (NS + 1) // 2
    rec_bound = bound_ms(da.numel() + db.numel() + 12 * m * m, pairs * 2 * m * m * k,
                         INT8_OPS_PER_S)
    print(f"[time] {label}: the first HPL trailing update {m}x{m}x{k} {mode} alpha=-1 beta=1, c "
          f"the matrix's own window: {ms_update:.3f} ms unstaged; staged " + ", ".join(
              f"{name} {v:.3f} ms" for name, v in staged.items())
          + f"; peak device memory {peak:.2f} GiB ({peak_12:.2f} GiB under a 12 GiB budget)",
          flush=True)
    print(f"[time] {label}: recombine at that shape (plan: tile class "
          f"{recombine_cuda.launch_plan(m, m, k, NS, sms).tile}): kernel {ms_rec:.3f} ms, bound "
          f"{rec_bound[0]:.3f} ms ({rec_bound[1]}), {pairs * 2 * m * m * k / ms_rec / 1e9:.1f} "
          f"int8 TOPS", flush=True)
    del ops, l21, u12, c22, da, db
    torch.cuda.empty_cache()

    # the device's busy share over one resident factorization
    a = bench_cli._hpl_matrix(8192, 1, False, torch.device("cuda"))
    linalg.lu_factor(a, mode=mode, block=1024, panel="device")  # warm
    torch.cuda.synchronize()
    events = traced_events(lambda: linalg.lu_factor(a, mode=mode, block=1024, panel="device"),
                           "traced_lu")
    busy, window = busy_in_window(events, "traced_lu")
    print(f"[trace] LU n=8192 block=1024 {mode} device panels: device busy {busy / 1e3:.3f} ms "
          f"of a {window / 1e3:.3f} ms window = busy share {busy / window:.4f}", flush=True)
    return counts


# -- 18. the distributed layer -------------------------------------------------
#
# The cases below run inside the rank processes that
# ``ozimmu_tpu_torch.parallel.local`` starts (each loads this file as the
# table's module); phase_parallel launches them and checks what they return.

PAR_N = 4096  # the global size of the 4-rank variants but SUMMA's
#: per-rank launches of each distributed path (split, recombine,
#: epilogue, fold; the exponent max launches once per split,
#: :func:`per_path`): a real variant splits its two operands, a complex
#: one four planes; SUMMA recombines once per pass, the ring, stream and k
#: variants sum int32 group totals through torch._int_mm and launch no
#: recombine kernel; every variant runs one epilogue (real) or one fold
#: (complex) on each rank's block
PAR_LAUNCHES = {"summa": (2, 1, 1, 0), "zsumma": (4, 4, 0, 1), "ring": (2, 0, 1, 0),
                "zring": (4, 0, 0, 1), "stream": (2, 0, 1, 0), "k": (2, 0, 1, 0),
                "auto": (2, 1, 1, 0), "summa_epilogue": (2, 1, 1, 0), "stream_1x4": (2, 0, 1, 0),
                "presharded_recheck": (2, 0, 1, 0)}
#: 512 x 4096 @ 4096 x 512 at ns = 9 on a 1 x 4 mesh: the chooser says "k"
#: (15.7 MB), which pre-sharded operands cannot use; summa needs 32.25 MB,
#: stream 30.0 MB, so under 31 MB the entry must re-check and stream
RECHECK = dict(shape=(512, 4096, 512), budget_mb=31)


def _par_operands(n: int, seed: int, cx: bool = False, k: int = None):
    from ozimmu_tpu_torch.testing import generate_input

    k = k or n
    return (generate_input("urand01", (n, k), seed=seed, complex_=cx),
            generate_input("urand01", (k, n), seed=seed + 1, complex_=cx))


def _par_call(call, want, gather=None) -> dict:
    """One distributed call on every rank, between barriers: its seconds
    and staged bytes, this rank's kernel launches, a digest of the global
    result it returns (through ``gather``, untimed, where it returns
    shards), and on rank 0 whether that equals ``want()`` (the one-device
    result) bit for bit.  The operands' set-up and the reference stay out
    of ``call_seconds``; the launcher's ``case_seconds`` has them."""
    import hashlib

    import torch.distributed as dist
    from ozimmu_tpu_torch.parallel import comm

    dist.barrier()
    reset_launches()
    comm.STAGED_BYTES = 0
    t0 = time.perf_counter()
    out = call()
    torch.cuda.synchronize()
    dist.barrier()
    seconds = time.perf_counter() - t0
    counts = read_launches()
    out = np.ascontiguousarray(gather(out) if gather else out)
    res = {"call_seconds": seconds, **counts, "call_staged_bytes": comm.STAGED_BYTES,
           "digest": hashlib.sha256(out.tobytes()).hexdigest()}
    if dist.get_rank() == 0:
        ref = np.ascontiguousarray(want())
        res["equal"] = bool(ref.shape == out.shape and np.array_equal(
            ref.view(np.uint64), out.view(np.uint64)) and np.isfinite(out).all())
    return res


def _one_device(a, b, **kw):
    import ozimmu_tpu_torch as ozt

    return lambda: ozt.gemm(a, b, mode=f"fp64_int8_{NS}", device="cuda", **kw)


def par_nccl_summa(mesh) -> dict:
    """(a) SUMMA 8192^3 on a 1 x 1 mesh over NCCL, on tensors on the card:
    bits against ``gemm``, launches, and both timed (CUDA events)."""
    import ozimmu_tpu_torch as ozt
    from ozimmu_tpu_torch import parallel as par

    a_np, b_np = _par_operands(N, 0)
    a, b = torch.from_numpy(a_np).cuda(), torch.from_numpy(b_np).cuda()
    mode = f"fp64_int8_{NS}"
    want = ozt.gemm(a, b, mode=mode)
    reset_launches()
    got = par.sharded_gemm(a, b, NS, mesh)
    counts = read_launches()
    res = {"equal": bits_equal(got, want) and bool(torch.isfinite(got).all()), **counts}
    del got, want
    res["ms_sharded"] = cuda_ms(lambda: par.sharded_gemm(a, b, NS, mesh), iters=3)
    res["ms_gemm"] = cuda_ms(lambda: ozt.gemm(a, b, mode=mode), iters=3)
    return res


def par_summa(mesh) -> dict:
    from ozimmu_tpu_torch import parallel as par

    a, b = _par_operands(N, 0)
    return _par_call(lambda: par.sharded_gemm(a, b, NS, mesh), _one_device(a, b))


def _par_variant(variant: str, cx: bool = False):
    def case(mesh) -> dict:
        from ozimmu_tpu_torch import parallel as par

        a, b = _par_operands(PAR_N, 10, cx)
        return _par_call(lambda: par.sharded_gemm(a, b, NS, mesh, variant=variant),
                         _one_device(a, b))
    return case


_MESHES = {}


def _mesh(shape: tuple, names: tuple):
    """A mesh of this rank process, made once, its groups connected by a
    barrier each before any timed call uses them."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    if shape not in _MESHES:
        mesh = init_device_mesh("cuda", shape, mesh_dim_names=names)
        for name in names:
            dist.barrier(group=mesh.get_group(name))
        _MESHES[shape] = mesh
    return _MESHES[shape]


def par_k(mesh) -> dict:
    from ozimmu_tpu_torch import parallel as par

    kmesh = _mesh((4,), ("k",))
    a, b = _par_operands(PAR_N, 10)
    return _par_call(lambda: par.sharded_gemm_k(a, b, NS, kmesh), _one_device(a, b))


def par_auto(mesh) -> dict:
    import ozimmu_tpu_torch as ozt
    from ozimmu_tpu_torch import parallel as par

    a, b = _par_operands(PAR_N, 10)
    res = _par_call(lambda: par.sharded_gemm_auto(a, b, "auto", mesh),
                    lambda: ozt.gemm(a, b, mode="fp64_int8_auto", device="cuda"))
    res["mode"] = par.sharded_auto_mode_select(a, b, mesh).value
    return res


def par_summa_epilogue(mesh) -> dict:
    from ozimmu_tpu_torch import parallel as par
    from ozimmu_tpu_torch.testing import generate_input

    a, b = _par_operands(PAR_N, 10)
    c = generate_input("urand01", (PAR_N, PAR_N), seed=12)
    kw = dict(alpha=2.0, beta=-0.5, c=c)
    return _par_call(lambda: par.sharded_gemm(a, b, NS, mesh, **kw), _one_device(a, b, **kw))


def par_stream_1x4(mesh) -> dict:
    from ozimmu_tpu_torch import parallel as par

    mesh = _mesh((1, 4), ("x", "y"))
    a, b = _par_operands(PAR_N, 10)
    return _par_call(lambda: par.sharded_gemm(a, b, NS, mesh, variant="stream"),
                     _one_device(a, b))


def par_presharded_recheck(mesh) -> dict:
    from ozimmu_tpu_torch import parallel as par
    from ozimmu_tpu_torch.parallel.gemm import _presharded_variant

    mesh = _mesh((1, 4), ("x", "y"))
    m, k, n = RECHECK["shape"]
    a, b = _par_operands(m, 20, k=k)
    sharded = [par.shard_local_f64x(x.shape, mesh, ("x", "y"), lambda i, x=x: x[i])
               for x in (a, b)]
    with hbm_budget_mb(RECHECK["budget_mb"]):
        chosen = par.select_variant(m, n, k, NS, mesh)
        variant = _presharded_variant(m, n, k, NS, mesh, "x", "y", False)
        res = _par_call(lambda: par.sharded_gemm_presharded(*sharded, NS, mesh),
                        _one_device(a, b), gather=par.allgather_f64x)
    res.update(select_variant=chosen, variant=variant)
    return res


PARALLEL_NCCL = {"summa": par_nccl_summa}
PARALLEL_GLOO = {
    "summa": par_summa,
    "ring": _par_variant("ring"),
    "stream": _par_variant("stream"),
    "k": par_k,
    "zsumma": _par_variant("summa", cx=True),
    "zring": _par_variant("ring", cx=True),
    "auto": par_auto,
    "summa_epilogue": par_summa_epilogue,
    "stream_1x4": par_stream_1x4,
    "presharded_recheck": par_presharded_recheck,
}


def _par_results(ranks: list, table: dict, what: str) -> dict:
    """Per case, rank 0's results; raises if a rank failed a case."""
    out = {}
    for name in table:
        for r, res in enumerate(ranks):
            if f"{name}/error" in res:
                raise AssertionError(f"{what} {name} failed on rank {r}:\n{res[f'{name}/error']}")
        out[name] = [{k.split("/", 1)[1]: v.item() if v.ndim == 0 else v
                      for k, v in res.items() if k.startswith(name + "/")} for res in ranks]
    return out


def phase_parallel(ozt, label) -> dict:
    """18. The distributed layer, each rank a process started by
    ``ozimmu_tpu_torch.parallel.local`` (killed if it fails or hangs):
    (a) world size 1 over NCCL, (b) four ranks sharing the card over gloo,
    every result bitwise equal to the one-device ``gemm`` and every rank's
    launches equal to the table; then (c) the 8192^3 GEMM's peak memory
    against the model."""
    from ozimmu_tpu_torch.parallel import local

    here = os.path.abspath(__file__)
    by_path = {}
    torch.cuda.empty_cache()

    # (a) one rank, NCCL
    t0 = time.perf_counter()
    ranks = local.run(f"{here}:PARALLEL_NCCL", "1x1", nproc=1, device="cuda", timeout=300)
    (res,) = _par_results(ranks, PARALLEL_NCCL, "NCCL 1x1")["summa"]
    by_path["parallel_nccl_summa"] = counts_of(res)
    if not res["equal"] or by_path["parallel_nccl_summa"] != per_path(*PAR_LAUNCHES["summa"]):
        raise AssertionError(f"NCCL 1x1 sharded_gemm {N}^3: {res}")
    print(f"[parallel] NCCL, world size 1, 1x1 mesh: sharded_gemm fp64_int8_{NS} {N}^3 == gemm "
          f"bitwise; launches split {res['split_digits']}, recombine {res['recombine']}, "
          f"epilogue {res['epilogue']} ({time.perf_counter() - t0:.1f} s with the process "
          f"start)", flush=True)
    print(f"[time] {label}: sharded_gemm {N}^3 on a 1x1 NCCL mesh: {res['ms_sharded']:.3f} ms; "
          f"gemm: {res['ms_gemm']:.3f} ms; the layer's overhead "
          f"{res['ms_sharded'] - res['ms_gemm']:+.3f} ms", flush=True)

    # (b) four ranks sharing the card, gloo
    t0 = time.perf_counter()
    ranks = local.run(f"{here}:PARALLEL_GLOO", "2x2", nproc=4, device="cuda", backend="gloo",
                      timeout=600)
    print(f"[parallel] 4 ranks over gloo on one card: {len(PARALLEL_GLOO)} cases in "
          f"{time.perf_counter() - t0:.1f} s with the process start", flush=True)
    results = _par_results(ranks, PARALLEL_GLOO, "gloo 4 ranks")
    for name, per_rank in results.items():
        r0 = per_rank[0]
        counts = [counts_of(r) for r in per_rank]
        digests = {r["digest"] for r in per_rank}
        if not r0["equal"] or any(c != per_path(*PAR_LAUNCHES[name]) for c in counts) \
                or len(digests) != 1:
            raise AssertionError(f"gloo {name}: equal {r0['equal']}, per-rank launches {counts} "
                                 f"(expected {per_path(*PAR_LAUNCHES[name])}), {len(digests)} "
                                 f"digests")
        by_path[f"parallel_gloo_{name}"] = counts[0]
        extra = ""
        if name == "auto":
            extra = f"; AUTO chose {r0['mode']}"
        if name == "presharded_recheck":
            if (r0["select_variant"], r0["variant"]) != ("k", "stream"):
                raise AssertionError(f"presharded re-check chose {r0['select_variant']} -> "
                                     f"{r0['variant']}, expected k -> stream")
            extra = (f"; {RECHECK['shape']} under {RECHECK['budget_mb']} MB: chooser "
                     f"{r0['select_variant']} -> pre-sharded {r0['variant']}")
        size = f"{N}^3" if name == "summa" else (
            "x".join(map(str, RECHECK["shape"])) if name == "presharded_recheck" else f"{PAR_N}^3")
        print(f"[parallel] gloo {name} {size}: == one-device gemm bitwise on rank 0, the same "
              f"result on all 4 ranks; per-rank launches split {r0['split_digits']}, recombine "
              f"{r0['recombine']}, epilogue {r0['epilogue']}, fold {r0['zfold']}{extra}",
              flush=True)
        print(f"[time] {label}: 4 ranks sharing one card, collectives through host memory, NOT a "
              f"scaling figure: {name} {size}: {max(r['call_seconds'] for r in per_rank):.3f} s "
              f"(one call, slowest rank; the whole case with its set-up and reference "
              f"{per_rank[0]['case_seconds']:.3f} s on rank 0); staged "
              f"{sum(r['call_staged_bytes'] for r in per_rank) / 2**20:.1f} MiB over the 4 ranks",
              flush=True)

    # (c) the main path's GEMM against the memory model
    a, b = (torch.from_numpy(x).cuda() for x in _par_operands(N, 0))
    memory_against_model(f"gemm {N}^3", lambda: ozt.gemm(a, b, mode=f"fp64_int8_{NS}"), a, b)
    return by_path


# -- 19. the row-sharded solvers -----------------------------------------------
#
# ``linalg.lu_factor`` / ``cholesky`` with ``mesh=``, in rank processes of
# ``ozimmu_tpu_torch.parallel.local`` as in phase 18: HPL at full size on a
# 1 x 1 NCCL mesh, and real LU, complex LU and Cholesky on four ranks
# sharing the card over gloo (rows over dim "x" of a 4 x 1 mesh).

MESH_HPL = (16384, 1024)  # n, block
MESH_GLOO = (4096, 512)


def sharded_launches(n: int, block: int, p: int, rank: int, kind: str) -> dict:
    """One rank's launches in a row-sharded factorization of an n x n
    matrix over p ranks (blocks of ceil(n / p) rows): in every step that
    has a trailing block, the step's root (the owner of its first row)
    runs the U12 GEMM of LU, and a rank that owns trailing rows runs their
    update (and for Cholesky, their panel solve first), each an engine
    GEMM (:func:`gemms`); at p = 1 this is :func:`step_launches`."""
    h = -(-n // p)
    hi = min((rank + 1) * h, n)
    count = 0
    for j in range(0, n - block, block):
        owns_trailing = hi > j + block
        count += 2 * owns_trailing if kind == "cholesky" else (j // h == rank) + owns_trailing
    return gemms(complex_=count) if kind == "zlu" else gemms(count)


def _timed(call):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = call()
    torch.cuda.synchronize()
    return time.perf_counter() - t0, out


def mesh_hpl_nccl(mesh) -> dict:
    """(a) HPL n = 16384, block 1024, on a 1 x 1 mesh over NCCL, device and
    host panels: the one-device and the sharded ``lu_factor`` of the same
    matrix in turns (one-device, sharded, sharded, one-device), every
    factor's bits and pivots against the first, the seconds of each and
    the sharded call's launches."""
    from ozimmu_tpu_torch import bench_cli, linalg

    mode = f"fp64_int8_{NS}"
    n, blk = MESH_HPL
    warm = bench_cli._hpl_matrix(2048, 1, False, torch.device("cuda"))
    for kw in ({}, {"mesh": mesh}):  # the engine's, cuSOLVER's and NCCL's set-up, untimed
        linalg.lu_factor(warm, mode=mode, block=512, panel="device", **kw)
    del warm
    a = bench_cli._hpl_matrix(n, 0, False, torch.device("cuda"))
    res = {}
    for panel in ("device", "host"):
        first, equal, seconds = None, True, {"one_device": [], "sharded": []}
        for which in ("one_device", "sharded", "sharded", "one_device"):
            kw = {"mesh": mesh, "mesh_axis": "x"} if which == "sharded" else {}
            reset_launches()
            t, (lu, piv) = _timed(lambda: linalg.lu_factor(a, mode=mode, block=blk, panel=panel,
                                                           **kw))
            seconds[which].append(t)
            if which == "sharded":
                res.update({f"{panel}_{k}": v for k, v in read_launches().items()})
                res[f"{panel}_residual"] = pa_lu_residual(a, lu, piv)
            if first is None:
                first = (lu, piv)
            else:
                equal = equal and bits_equal(lu, first[0]) and bool(np.array_equal(piv, first[1]))
            del lu
        res.update({f"{panel}_equal": equal, f"{panel}_seconds_one_device": seconds["one_device"],
                    f"{panel}_seconds_sharded": seconds["sharded"]})
        del first
        torch.cuda.empty_cache()
    return res


def _mesh_matrix(kind: str) -> torch.Tensor:
    """The 4-rank cases' matrix, made alike on every rank from a seed:
    uniform [-1, 1) (complex for "zlu"), for Cholesky made symmetric and
    strictly diagonally dominant (SPD)."""
    n = MESH_GLOO[0]
    rng = np.random.default_rng(130)
    a = rng.uniform(-1, 1, (n, n))
    if kind == "zlu":
        a = a + 1j * rng.uniform(-1, 1, (n, n))
    if kind == "cholesky":
        a = (a + a.T) / 2 + n * np.eye(n)
    return torch.from_numpy(a).cuda()


def mesh_step_kernel_checks() -> list:
    """Both kernels against their plain versions, bit for bit, on the
    engine products that the four ranks of (b) run in their first step
    (n = 4096, block 512, blocks of 1024 rows), with the solver's own
    operands (the cases' matrices, the first panel factored and swapped as
    the step does it): LU's U12 = L11inv @ A12 on the root and the
    trailing L21 @ U12 of rank 0's rows (512) and of rank 1's (1024), and
    the last step's one-block update (rank 3), real and complex;
    Cholesky's panel solve A21 @ inv(L11)^T and trailing L21 @ L21^T on
    the rows of ranks 0 and 1."""
    from ozimmu_tpu_torch import linalg

    n, blk = MESH_GLOO
    h = -(-n // 4)
    done = []
    for kind in ("lu", "zlu"):
        a = _mesh_matrix(kind)
        lu_p, p_loc, l11inv = linalg._factor_panel(a[:, :blk], 0, True, "host",
                                                   linalg._Clock(None, a.device))
        linalg._apply_panel_pivots(a, 0, p_loc, np.arange(n))
        a[:, :blk] = lu_p
        a12, l21 = a[:blk, blk:], a[blk:, :blk]
        u12 = linalg._engine(l11inv, a12, NS)
        done += products_equal_plain((
            (f"{kind} U12 = L11inv @ A12", l11inv, a12),
            (f"{kind} A22 -= L21 @ U12 rank 0", l21[:h - blk], u12),
            (f"{kind} A22 -= L21 @ U12 rank 1", l21[h - blk:2 * h - blk], u12),
            (f"{kind} last A22 -= L21 @ U12 rank 3", l21[-blk:], u12[:, -blk:])), kind == "zlu")
    a = _mesh_matrix("cholesky")
    _, inv_t = linalg._cholesky_diagonal(np.ascontiguousarray(a[:blk, :blk].cpu().numpy()), 0)
    inv_t = torch.from_numpy(inv_t).cuda()
    l21 = linalg.gemm_f64(a[blk:, :blk], inv_t, NS)
    done += products_equal_plain((
        ("cholesky L21 = A21 @ inv(L11)^T rank 0", a[blk:h, :blk], inv_t),
        ("cholesky L21 = A21 @ inv(L11)^T rank 1", a[h:2 * h, :blk], inv_t),
        ("cholesky A22 -= L21 @ L21^T rank 0", l21[:h - blk], l21.T),
        ("cholesky A22 -= L21 @ L21^T rank 1", l21[h - blk:2 * h - blk], l21.T)), False)
    return done


def _mesh_gloo_case(kind: str, panel: str = "host"):
    def case(mesh) -> dict:
        """(b) One factorization on four ranks sharing the card: this rank's
        seconds, staged bytes and launches, a digest of the factor, and
        on rank 0 its pivots, bits and relative difference against the
        one-device factor of the same matrix on the card, its residual and
        a solve's scaled residual through it."""
        import hashlib

        import torch.distributed as dist
        from ozimmu_tpu_torch import linalg
        from ozimmu_tpu_torch.parallel import comm

        mode, blk = f"fp64_int8_{NS}", MESH_GLOO[1]
        a = _mesh_matrix(kind)
        if kind == "cholesky":
            def factor(**kw):
                return linalg.cholesky(a, mode=mode, block=blk, **kw), None
        else:
            def factor(**kw):
                return linalg.lu_factor(a, mode=mode, block=blk, panel=panel, **kw)
        dist.barrier()
        reset_launches()
        comm.STAGED_BYTES = 0
        t0 = time.perf_counter()
        lu, piv = factor(mesh=mesh, mesh_axis="x")
        torch.cuda.synchronize()
        dist.barrier()
        res = {"call_seconds": time.perf_counter() - t0, "call_staged_bytes": comm.STAGED_BYTES,
               **read_launches()}
        flat = torch.view_as_real(lu) if lu.is_complex() else lu
        res["digest"] = hashlib.sha256(flat.cpu().numpy().tobytes() + (
            b"" if piv is None else np.asarray(piv).tobytes())).hexdigest()
        if dist.get_rank() == 0:
            want, want_piv = factor()
            res.update(same_piv=piv is None or bool(np.array_equal(piv, want_piv)),
                       same_bits=bits_equal(flat, torch.view_as_real(want) if want.is_complex()
                                            else want),
                       rel=float((lu - want).abs().max() / want.abs().max()))
            if kind == "cholesky":
                res["residual"] = float(torch.linalg.norm(a - lu @ lu.T) / torch.linalg.norm(a))
                x_true = torch.from_numpy(np.random.default_rng(131).standard_normal(a.shape[0]))
                b = a @ x_true.cuda()
                x = linalg.cho_solve(lu, b)
            else:
                res["residual"] = pa_lu_residual(a, lu, piv)
                x_true = torch.from_numpy(np.random.default_rng(131).standard_normal(a.shape[0]))
                b = a @ x_true.to(a.dtype).cuda()
                x = linalg.lu_solve((lu, piv), b)
            res["scaled_residual"] = float(torch.linalg.norm(b - a @ x) / (
                torch.linalg.norm(a) * torch.linalg.norm(x) + torch.linalg.norm(b)))
        return res
    return case


MESH_NCCL = {"hpl": mesh_hpl_nccl}
MESH_GLOO_CASES = {
    "lu": _mesh_gloo_case("lu"),
    "lu_device_panels": _mesh_gloo_case("lu", "device"),
    "zlu": _mesh_gloo_case("zlu"),
    "cholesky": _mesh_gloo_case("cholesky"),
}


def phase_mesh_solvers(ozt, label) -> dict:
    """19. The solvers' ``mesh=``: (a) HPL n = 16384 on a 1 x 1 mesh over
    NCCL, bitwise equal to the one-device factor with device and with host
    panels; (b) both kernels == plain bitwise on the engine products of
    the first step of the 4-rank cases, at each rank's shapes
    (:func:`mesh_step_kernel_checks`), then real LU (host and device
    panels), complex LU and Cholesky at n = 4096 on four ranks sharing
    the card over gloo, each held
    against the one-device factor on the card (host panels and Cholesky
    bitwise; device panels the same pivots and relative difference
    < 1e-13), a solve through each factor to a scaled residual < 1e-14,
    the same factor on every rank, every rank's launches equal to
    :func:`sharded_launches`."""
    from ozimmu_tpu_torch.parallel import local

    here = os.path.abspath(__file__)
    by_path = {}
    torch.cuda.empty_cache()

    # (a) HPL on one rank, NCCL
    t0 = time.perf_counter()
    ranks = local.run(f"{here}:MESH_NCCL", "1x1", nproc=1, device="cuda", timeout=600)
    (res,) = _par_results(ranks, MESH_NCCL, "NCCL 1x1")["hpl"]
    n, blk = MESH_HPL
    want = sharded_launches(n, blk, 1, 0, "lu")
    if want != step_launches(n, blk):
        raise AssertionError(f"sharded_launches at p = 1 {want} != step_launches")
    for panel in ("device", "host"):
        got = {k: res[f"{panel}_{k}"] for k in KERNEL_KEYS}
        if not res[f"{panel}_equal"] or got != want or not res[f"{panel}_residual"] < 1e-14:
            raise AssertionError(f"NCCL 1x1 HPL n={n} {panel} panels: equal "
                                 f"{res[f'{panel}_equal']}, launches {got} (expected {want}), "
                                 f"||PA-LU||/||A|| {res[f'{panel}_residual']:.3e}")
        by_path[f"mesh_nccl_hpl_{panel}_panels"] = got
        print(f"[mesh] NCCL, world size 1, 1x1 mesh: lu_factor(mesh=) HPL n={n} block={blk} "
              f"fp64_int8_{NS} {panel} panels == one-device lu_factor bitwise (factor and "
              f"pivots, both runs of each), ||PA-LU||/||A|| {res[f'{panel}_residual']:.3e}; "
              f"launches {got}", flush=True)
        sec = {k: list(res[f"{panel}_seconds_{k}"]) for k in ("one_device", "sharded")}
        print(f"[time] {label}: HPL n={n} block={blk} {panel} panels, factor seconds in turns "
              f"(one-device, sharded, sharded, one-device): one-device "
              + ", ".join(f"{t:.4f}" for t in sec["one_device"]) + " s; row-sharded on a 1x1 "
              "NCCL mesh " + ", ".join(f"{t:.4f}" for t in sec["sharded"]) + " s; sharded - "
              f"one-device {sum(sec['sharded']) / 2 - sum(sec['one_device']) / 2:+.4f} s on the "
              "means", flush=True)
    print(f"[mesh] NCCL phase {time.perf_counter() - t0:.1f} s with the process start", flush=True)

    # (b) four ranks sharing the card, gloo; first both kernels at their
    # products' shapes and data, against the plain versions
    done = mesh_step_kernel_checks()
    torch.cuda.empty_cache()
    print(f"[mesh] n={MESH_GLOO[0]} block={MESH_GLOO[1]} fp64_int8_{NS}, the 4-rank cases' "
          f"first step: split (both operands) and recombine kernels == plain bitwise on "
          f"{len(done)} products: " + "; ".join(done), flush=True)
    t0 = time.perf_counter()
    ranks = local.run(f"{here}:MESH_GLOO_CASES", "4x1", nproc=4, device="cuda", backend="gloo",
                      timeout=600)
    print(f"[mesh] 4 ranks over gloo on one card: {len(MESH_GLOO_CASES)} cases in "
          f"{time.perf_counter() - t0:.1f} s with the process start", flush=True)
    n, blk = MESH_GLOO
    for name, per_rank in _par_results(ranks, MESH_GLOO_CASES, "gloo 4 ranks").items():
        r0 = per_rank[0]
        kind = name.split("_")[0]
        wants = [sharded_launches(n, blk, 4, r, kind) for r in range(4)]
        gots = [counts_of(r) for r in per_rank]
        exact = name != "lu_device_panels"
        ok = (r0["same_piv"] and (r0["same_bits"] if exact else r0["rel"] < 1e-13)
              and r0["scaled_residual"] < 1e-14
              and len({r["digest"] for r in per_rank}) == 1 and gots == wants
              and min(g["recombine"] for g in gots) > 0)
        if not ok:
            raise AssertionError(f"gloo {name} n={n}: {r0}, per-rank launches {gots} (expected "
                                 f"{wants}), {len({r['digest'] for r in per_rank})} digests")
        by_path[f"mesh_gloo_{name}"] = gots[0]
        bits = "equal" if r0["same_bits"] else "differ"
        print(f"[mesh] gloo {name} n={n} block={blk}: "
              + ("== one-device factor on the card bitwise" if exact else
                 f"same pivots as the one-device factor, bits {bits}")
              + f", max rel diff {r0['rel']:.3e}, ||PA-LU||/||A|| (||A-LL^T||/||A||) "
              f"{r0['residual']:.3e}, a solve's scaled residual {r0['scaled_residual']:.3e} "
              f"(< 1e-14); the same factor on all 4 ranks; per-rank "
              f"launches (split, recombine, epilogue, fold) "
              + ", ".join(f"({g['split_digits']}, {g['recombine']}, {g['epilogue']}, {g['zfold']})"
                          for g in gots), flush=True)
        print(f"[time] {label}: 4 ranks sharing one card, collectives through host memory, NOT a "
              f"scaling figure: {name} n={n}: per-rank seconds "
              + ", ".join(f"{r['call_seconds']:.3f}" for r in per_rank)
              + "; staged MiB per rank " + ", ".join(
                  f"{r['call_staged_bytes'] / 2**20:.1f}" for r in per_rank), flush=True)
    return by_path


# -- 20. the examples ------------------------------------------------------------
#
# Each ``examples/torch_0*.py`` through its ``main(device="cuda")`` at the JAX
# example's own size (the distributed ones through their case tables), with
# the launch counts read around it; example 09 at the north-star operand size
# on a 1 x 1 NCCL mesh; and the split kernel and the card's ``gemm`` against
# ``hostref``, the numpy model that shares no code with either.

EXAMPLES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "examples")
NORTH_STAR = 16384  # m = n = k of example 09 on the card
SOLVE_GATE = 1e-14


def load_example(name: str):
    """``examples/<name>.py`` as a module (its ``__main__`` block does not run)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(f"_example_{name}",
                                                  os.path.join(EXAMPLES, f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def under_gate(what: str, value: float, gate: float) -> float:
    if not value < gate:
        raise AssertionError(f"{what}: {value:.3e} >= {gate}")
    return value


def hostref_checks(ozt) -> list:
    """The split kernel's planes against ``hostref.split_fp64``'s digits,
    bitwise (exp_rand-3 at 1000 x 1234 with a zero row and a subnormal, ns
    3, 9, 18, A by rows and B = its transpose by columns, in the natural
    layout and k-major, the latter read back as [ns, 1000, 1234] and zero
    beyond k; the exponents compared by meaning, the null-row sentinels
    being different numbers),
    and the card's ``gemm`` at 1025 x 777 x 513 within 2 ulp (rtol 5e-16)
    of ``hostref.gemm_fp64``."""
    from ozimmu_tpu_torch import hostref
    from ozimmu_tpu_torch.ops.recombine import padded_k
    from ozimmu_tpu_torch.ops.split import ZERO_ROW_PEXP, row_exponent, split_with_exp
    from ozimmu_tpu_torch.schedule import bits_per_int8
    from ozimmu_tpu_torch.testing import generate_input

    x = generate_input("exp_rand-3", (1000, 1234), seed=41)
    x[0, :] = 0.0
    x[3, 0] = 2.0**-1070
    b = bits_per_int8(1234)
    done = []
    kp = padded_k(1234)
    for axis, operand in ((1, x), (0, np.ascontiguousarray(x.T))):
        t = torch.from_numpy(operand).cuda()
        for ns in (3, 9, 18):
            dh, ph = hostref.split_fp64(x, ns, b)
            live = ph != hostref.ZERO_ROW_PEXP
            e = row_exponent(t, axis)  # the kernels
            planes, pexp = split_with_exp(t, e, ns, b, axis)
            # the engine's k-major planes ([ns, 1000, k_pad] for A and for
            # B = x^T by columns), read back in hostref's [ns, 1000, 1234]
            kmajor, _ = split_with_exp(t, e, ns, b, axis, kp)
            kmajor = kmajor.cpu().numpy()
            pexp = pexp.cpu().numpy().astype(np.int64)
            want = dh if axis == 1 else np.swapaxes(dh, 1, 2)
            if not (np.array_equal(planes.cpu().numpy(), want)
                    and np.array_equal(kmajor[..., :1234], dh) and not kmajor[..., 1234:].any()
                    and np.array_equal(pexp == ZERO_ROW_PEXP, ~live)
                    and np.array_equal(pexp[live], ph[live])):
                raise AssertionError(f"split kernel != hostref.split_fp64 (axis {axis}, ns {ns})")
            done.append(f"{'A by rows' if axis == 1 else 'B by columns'} ns={ns}, both layouts")
    m, n, k = 1025, 777, 513
    a = generate_input("normal01", (m, k), seed=42)
    bm = generate_input("normal01", (k, n), seed=43)
    got = ozt.gemm(a, bm, mode=f"fp64_int8_{NS}", device="cuda")
    want = hostref.gemm_fp64(a, bm, NS)
    rel = float(np.max(np.abs(got - want) / np.abs(want)))
    if not np.allclose(got, want, rtol=5e-16, atol=0):
        raise AssertionError(f"gemm {m}x{n}x{k} differs from hostref.gemm_fp64 by rel {rel:.3e}")
    done.append(f"gemm {m}x{n}x{k} fp64_int8_{NS} within rtol 5e-16 (max rel {rel:.3e})")
    return done


def _single_example_checks(name: str, r: dict) -> str:
    """The gates of what one single-process example returns: every
    "bitwise ==" / "ok" value true, every GEMM residual < 1e-15, every
    solve's < 1e-14 (example 08's unrefined fp64_int8_5 solve is the cheap
    factor's own, which refinement is there to fix, and its unscaled
    multi-RHS figure is the matrix's condition, ~7e3, times LAPACK's;
    both are printed, not gated)."""
    if name == "torch_01_basic_gemm":
        if not r["epilogue_ok"]:
            raise AssertionError("01: epilogue not ok")
        return f"residual {under_gate('01 residual', r['residual'], RESIDUAL_GATE):.3e}"
    if name == "torch_02_interception":
        if not r["small_native"]:
            raise AssertionError("02: the 64^3 product was not native")
        worst = max(r["eager_residual"], r["linear_residual"], r["env_residual"])
        return f"residuals <= {under_gate('02 residual', worst, RESIDUAL_GATE):.3e}"
    if name == "torch_04_profiling":
        if not any(f.endswith(".json") for f in r["trace_files"]) or not r["phases"]:
            raise AssertionError(f"04: phases {r['phases']}, trace files {r['trace_files']}")
        return (f"phases {r['phases']}, trace {r['trace_files']} "
                f"(traced {r['trace_attempts']} time(s))")
    if name == "torch_05_iterative_refinement":
        if not r["converged"]:
            raise AssertionError(f"05: not converged: {r['errors']}")
        under_gate("05 error", r["errors"][-1], SOLVE_GATE)
        return f"errors {[f'{e:.3e}' for e in r['errors']]}"
    if name == "torch_06_compiled":
        if not (r["bitwise"] and r["trace_ok"]):
            raise AssertionError(f"06: bitwise {r['bitwise']}, trace {r['trace_ok']}")
        return (f"compiled == host API bitwise; residual "
                f"{under_gate('06 residual', r['residual'], RESIDUAL_GATE):.3e}")
    if name == "torch_08_hpl_lu":
        gated = {"fp64_int8_9": r["residual_9"], "multi-rhs scaled": r["multi_rhs_scaled_residual"],
                 **{f"fp64_int8_5 + {k} refinement": v for k, v in r["residual_refined"].items()}}
        for what, v in gated.items():
            under_gate(f"08 {what}", v, SOLVE_GATE)
        return "scaled residuals " + ", ".join(f"{w} {v:.3e}" for w, v in gated.items())
    raise ValueError(name)


def example_kernel_checks(name: str, r: dict) -> list:
    """Both kernels against their plain versions, bit for bit, on the
    engine products of an example's path whose shapes no other check has,
    with the example's own operands: 05's first residual matvec A @ x
    (n = 1) and 08's first trailing update A22 -= L21 @ U12 of the host
    path (768 x 768 x 256, after the example's panel factor and U12
    solve) at fp64_int8_9 and fp64_int8_5."""
    from ozimmu_tpu_torch import linalg

    def cuda(x):
        return torch.from_numpy(np.ascontiguousarray(x)).cuda()

    if name == "torch_05_iterative_refinement":
        a32 = r["A"].astype(np.float32)
        x0 = np.linalg.solve(a32, r["b"].astype(np.float32)).astype(np.float64)
        return [kernels_equal_plain_on("05 r = b - A @ x", cuda(r["A"]), cuda(x0), NS)]
    if name == "torch_08_hpl_lu":
        a, blk = r["A"].copy(), 256
        linalg._panel_factor(a, 0, blk, np.arange(a.shape[0]))
        linalg._unit_lower_solve(a[:blk, :blk], a[:blk, blk:])
        l21, u12 = cuda(a[blk:, :blk]), cuda(a[:blk, blk:])
        return [kernels_equal_plain_on(f"08 A22 -= L21 @ U12 fp64_int8_{ns}", l21, u12, ns)
                for ns in (NS, 5)]
    return []


#: launches (split, recombine, epilogue, fold) of each single-process
#: example at its own size (the exponent max once per split,
#: :func:`per_path`): a real GEMM splits twice, recombines once and runs
#: one epilogue, a complex one splits and recombines four times each and
#: runs one fold.  01: matmul, the op_a=T gemm, a 512^2 ZGEMM (AUTO's two
#: queries run no kernel); 02: three routed products, the 64^3 one below
#: the threshold adds nothing; 04: two profiled gemms and the traced
#: matmul; 05: one residual per refinement step (one step converges);
#: 06: the compiled gemm and matmul, the host gemm, the second compiled
#: gemm, a batch of two matrices (one launch of each kernel); 08: three factorizations of n = 1024 in
#: blocks of 256, three trailing updates each (the refinement's residuals
#: are host matvecs)
EXAMPLE_LAUNCHES = {"torch_01_basic_gemm": (8, 6, 2, 1), "torch_02_interception": (6, 3, 3, 0),
                    "torch_04_profiling": (6, 3, 3, 0), "torch_05_iterative_refinement": (2, 1, 1, 0),
                    "torch_06_compiled": (10, 5, 5, 0), "torch_08_hpl_lu": (18, 9, 9, 0)}
#: per-rank launches of each case of example 03 on 4 ranks, the
#: one-device reference included (2, 1, 1 real; 4, 4 and a fold
#: complex): SUMMA and its epilogue 2 + 1 + 1, complex SUMMA 4 + 4 + a
#: fold, AUTO's choice (an int8 mode) by SUMMA 2 + 1 + 1; the ring and the
#: k-sharded complex product sum int32 group totals through torch._int_mm
#: and launch no recombine (2 + 0 + 1, 4 + 0 + a fold); the AUTO queries
#: none
EX03_LAUNCHES = {"summa": (4, 2, 2, 0), "epilogue": (4, 2, 2, 0), "zgemm": (8, 8, 0, 2),
                 "ring": (4, 1, 2, 0), "auto_select": (0, 0, 0, 0), "auto_gemm": (4, 2, 2, 0),
                 "tall_k": (8, 4, 0, 2)}
#: 07's body (SUMMA + ``gemm_f64``) and 09's run (pre-sharded + dense gemm)
EX_PAIR_LAUNCHES = (4, 2, 2, 0)


def ex09_north_star(mesh) -> dict:
    """Example 09 at m = n = k = 16384 on this rank: the example's own run
    (pre-sharded GEMM, dense-fed ``gemm``, the checks) with its launches;
    both calls' peak memory against the model and their times (CUDA
    events) beside ``torch.matmul`` float64; then both kernels against
    their plain versions on the dense operands (the int32 group split
    that k = 16384 makes, over many tiles per persistent block)."""
    import ozimmu_tpu_torch as ozt

    ex = load_example("torch_09_north_star_feeding")
    t0 = time.perf_counter()
    reset_launches()
    res, ops = ex.run(mesh, NORTH_STAR)
    res.update(read_launches())
    res["run_seconds"] = time.perf_counter() - t0
    del ops["out"]
    ax, bx, a, b = ops["ax"], ops["bx"], ops["a"], ops["b"]
    mode = f"fp64_int8_{NS}"
    pre = lambda: ex.sharded_gemm_presharded(ax, bx, NS, mesh)  # noqa: E731
    dense = lambda: ozt.gemm(a, b, mode=mode)  # noqa: E731
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        res["peak_presharded"] = memory_against_model(
            f"pre-sharded sharded_gemm_presharded on a {tuple(mesh.mesh.shape)} mesh", pre,
            ax.to_local(), bx.to_local())
        res["peak_dense"] = memory_against_model("dense-fed gemm", dense, a, b)
    res["memory_lines"] = buf.getvalue()
    res["ms_presharded"] = cuda_ms(pre, iters=3)
    res["ms_dense"] = cuda_ms(dense, iters=3)
    res["ms_matmul"] = cuda_ms(lambda: torch.matmul(a, b), iters=3)
    t0 = time.perf_counter()
    res["kernel_check"] = kernels_equal_plain_on(f"example 09 {NORTH_STAR}^3", a, b, NS)
    res["kernel_check_seconds"] = time.perf_counter() - t0
    res.pop("c", None)
    return res


EXAMPLES_NCCL = {"north_star": ex09_north_star}


def phase_examples(ozt, label) -> dict:
    """20. The examples on the card: (a) the six single-process ones
    through ``main(device="cuda")``, each counted on its own; (b) 03's case
    table on four gloo ranks sharing the card and 07 through its ``main``
    (2 "hosts" x 2 gloo ranks on the hybrid mesh); (c) 09 at 16384^3 on a
    1 x 1 NCCL mesh; (d) the split kernel and ``gemm`` against
    ``hostref``.  Both kernels are also held against their plain versions
    on 05's and 08's engine products and on 09's operands."""
    from ozimmu_tpu_torch.parallel import local

    here = os.path.abspath(__file__)
    by_path = {}
    torch.cuda.empty_cache()

    # (a) single process, at the JAX examples' sizes
    for name in EXAMPLE_LAUNCHES:
        ex = load_example(name)
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory(prefix="oz_ex_") as tmp:
            kw = {"trace_dir": tmp} if name == "torch_04_profiling" else {}
            reset_launches()
            r = ex.main(device="cuda", **kw)
            counts = read_launches()
            checked = _single_example_checks(name, r)
            r_attempts = r.get("trace_attempts", 1)
        kernels = example_kernel_checks(name, r)
        del r
        expected = EXAMPLE_LAUNCHES[name]
        if name == "torch_04_profiling":  # one traced matmul more for each lost trace
            expected = tuple(x + (r_attempts - 1) * y for x, y in zip(expected, (2, 1, 1, 0)))
        if counts != per_path(*expected):
            raise AssertionError(f"{name}: launches {counts}, expected {expected}")
        by_path[f"examples/{name}"] = counts
        print(f"[examples] {name} on cuda: launches {counts}; {checked} "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)
        if kernels:
            print(f"[examples] {name}: both kernels == plain bitwise on " + "; ".join(kernels),
                  flush=True)
        torch.cuda.empty_cache()

    # (b) the distributed examples on four ranks sharing the card, gloo
    ex03 = load_example("torch_03_distributed")
    t0 = time.perf_counter()
    ranks = local.run(f"{ex03.HERE}:CASES", "2x2", nproc=4, device="cuda", backend="gloo",
                      timeout=300)
    results = _par_results(ranks, ex03.CASES, "example 03")
    for name, per_rank in results.items():
        r0 = per_rank[0]
        counts = [counts_of(r, "case_launches_") for r in per_rank]
        ok = r0["same"] if name == "auto_select" else (r0["bitwise"] and r0.get("ran", True))
        if not ok or any(c != per_path(*EX03_LAUNCHES[name]) for c in counts):
            raise AssertionError(f"example 03 {name}: {r0}, per-rank launches {counts}, expected "
                                 f"{per_path(*EX03_LAUNCHES[name])}")
        by_path[f"examples/torch_03_distributed/{name}"] = counts[0]
        what = (f"AUTO chose {r0['mode']} == single-device {r0['single_device_mode']}"
                if name == "auto_select" else "bitwise == one-device gemm")
        print(f"[examples] torch_03_distributed {name}, 4 gloo ranks on one card: {what}; "
              f"launches {counts[0]} on every rank (the case with its one-device reference)",
              flush=True)
    print(f"[examples] torch_03_distributed: {len(results)} cases in "
          f"{time.perf_counter() - t0:.1f} s with the process start", flush=True)

    t0 = time.perf_counter()
    res = load_example("torch_07_multiprocess").main(device="cuda", backend="gloo")
    counts = [counts_of(r, "case_launches_") for r in res["results"]]
    if any(c != per_path(*EX_PAIR_LAUNCHES) for c in counts) or not all(
            ln.endswith("bitwise == single-device") for ln in res["lines"]):
        raise AssertionError(f"example 07: {res['lines']}, per-rank launches {counts}")
    by_path["examples/torch_07_multiprocess"] = counts[0]
    print(f"[examples] torch_07_multiprocess, 2 hosts x 2 gloo ranks on the hybrid mesh: "
          f"bitwise == gemm_f64 on every rank; per-rank launches {counts[0]} "
          f"(SUMMA body and the one-device reference) ({time.perf_counter() - t0:.1f} s with "
          "the process start)", flush=True)

    # (c) example 09 at the north-star operand size, world size 1, NCCL
    t0 = time.perf_counter()
    ranks = local.run(f"{here}:EXAMPLES_NCCL", "1x1", nproc=1, device="cuda", timeout=420)
    (r,) = _par_results(ranks, EXAMPLES_NCCL, "example 09")["north_star"]
    counts = counts_of(r)
    if not r["bitwise"] or counts != per_path(*EX_PAIR_LAUNCHES):
        raise AssertionError(f"example 09 at {NORTH_STAR}^3: {r}")
    # the full-matrix reference is torch.matmul float64 summed over k-panels
    # of 1024: one call's own accumulation over k = 16384 is off by ~3e-15
    # (reported beside it, with its oracle block)
    under_gate("example 09 residual against torch.matmul over k-panels", r["residual"],
               RESIDUAL_GATE)
    under_gate("example 09 sampled oracle block", r["oracle_residual"], RESIDUAL_GATE)
    by_path["examples/torch_09_north_star_feeding"] = counts
    ns3 = f"{NORTH_STAR}^3"
    print(f"[examples] torch_09_north_star_feeding {ns3} on a 1x1 NCCL mesh: pre-sharded == "
          f"dense-fed gemm bitwise; residual against torch.matmul float64 summed over k-panels "
          f"of 1024 {r['residual']:.3e} (against one torch.matmul call "
          f"{r['residual_one_matmul']:.3e}); sampled 256x256 block against the long-double "
          f"oracle {r['oracle_residual']:.3e} (one torch.matmul call: "
          f"{r['one_matmul_oracle_residual']:.3e}); launches {counts} (both calls); the "
          f"example's run {r['run_seconds']:.1f} s, the phase {time.perf_counter() - t0:.1f} s "
          "with the process start", flush=True)
    print(f"[examples] torch_09_north_star_feeding: both kernels == plain bitwise on "
          f"{r['kernel_check']} ({r['kernel_check_seconds']:.1f} s)", flush=True)
    for line in r["memory_lines"].splitlines():
        print(line, flush=True)
    print(f"[time] {label}: {ns3} fp64_int8_{NS}: sharded_gemm_presharded on a 1x1 NCCL mesh "
          f"{r['ms_presharded']:.3f} ms ({2 * NORTH_STAR**3 / r['ms_presharded'] / 1e9:.3f} "
          f"effective FP64 TFLOPS); dense-fed gemm {r['ms_dense']:.3f} ms "
          f"({2 * NORTH_STAR**3 / r['ms_dense'] / 1e9:.3f}); torch.matmul float64 "
          f"{r['ms_matmul']:.3f} ms ({2 * NORTH_STAR**3 / r['ms_matmul'] / 1e9:.3f} TFLOPS); "
          f"peak {r['peak_presharded'] / 2**30:.3f} / {r['peak_dense'] / 2**30:.3f} GiB",
          flush=True)

    # (d) the kernels against the numpy model
    done = hostref_checks(ozt)
    print("[examples] hostref: split kernel == hostref.split_fp64 bitwise (exp_rand-3 "
          "1000x1234, a zero row and a subnormal): " + ", ".join(done), flush=True)
    return by_path


if __name__ == "__main__":
    sys.exit(main())
