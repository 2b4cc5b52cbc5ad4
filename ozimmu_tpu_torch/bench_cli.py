"""Benchmark/evaluation CLI — the reference ``main.test`` harness surface.

Port of ``ozimmu_tpu.bench_cli``: the reference CLI semantics
(test/main_test.cu:550-568) and its CSV schema (main_test.cu:143-151)::

    python -m ozimmu_tpu_torch.bench_cli urand01 dgemm fp64_int8_9 seq 1024 4096 1024
    python -m ozimmu_tpu_torch.bench_cli exp_rand-2 zgemm fp64_int8_8,fp64_int8_12 \\
        exp2 1024 8192 2 --test-count 10
    python -m ozimmu_tpu_torch.bench_cli ci_test [--seeds crc32]
    python -m ozimmu_tpu_torch.bench_cli power dgemm fp64_int8_9 8192 --min-seconds 10
    python -m ozimmu_tpu_torch.bench_cli matfile a.npy b.npy fp64_int8_9,fp64_int8_12
    python -m ozimmu_tpu_torch.bench_cli matfile_raw a.bin b.bin 1000 800 600 --dtype fp64
    python -m ozimmu_tpu_torch.bench_cli hpl fp64_int8_9 16384 --block 1024 --warmup --profile
    python -m ozimmu_tpu_torch.bench_cli hpl fp64_int8_9 8192 --dtype z --block 1024

CSV columns: device,gemm,input,mode,opA,opB,m,n,k,residual,max_relative,tflops
(the reference's ``gpu`` column is ``device``: ``torch.cuda.get_device_name``
with ``,`` replaced by ``;``, or ``cpu``; TFLOPS is effective 2mnk/t, x4
complex — main_test.cu:134-141).  Every mode takes ``--device`` (default
``cuda``); without a GPU the default raises instead of moving to the CPU.

Residuals come from the long-double oracle (ozimmu_tpu_torch.oracle, built
with g++ at first use).  Above 2^31 multiply-adds (about 1290^3) it scores
a seeded 256 x 256 block of C instead of all of it: the oracle streams B by
columns, so a full pass at 8192^3 would read B once per row of C.

``hpl`` is the solver benchmark (blocked LU on the engine; ``--dtype z``
is ZHPL).  It prints one line ``hpl,<device>,<mode>,n=..,block=..,
factor_time=..s,gflops=..,refine=..,residual=..,resident=device|host,
panel=host|device`` (``zhpl`` and ``gflops_x4`` for z; ``--profile`` appends
the phases' seconds).  ``--resident auto|on|off`` is the JAX CLI's
``--device auto|on|off``; here ``--device`` names the torch device.
"""

from __future__ import annotations

import argparse
import collections
import ctypes
import itertools
import os
import sys
import time
import zlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from . import oracle
from .core.api import gemm
from .testing import effective_tflops, generate_input, sustained_run
from .utils.profiling import synchronize

CSV_HEADER = "device,gemm,input,mode,opA,opB,m,n,k,residual,max_relative,tflops"

#: above this many multiply-adds the oracle scores a sampled block of C
FULL_ORACLE_MAX_MACS = 2**31
SAMPLE = 256


def _device_name(device) -> str:
    dev = torch.device(device)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else dev.type
    return name.replace(",", ";")


def _op(x: np.ndarray, op: str) -> np.ndarray:
    """The logical operand op(x) as a contiguous array."""
    if op == "N":
        return np.ascontiguousarray(x)
    return np.ascontiguousarray(np.conj(x).T if op == "C" else x.T)


def sampled_block(m: int, n: int, k: int):
    """The rows and columns of C that the oracle scores: None (all of C) up
    to :data:`FULL_ORACLE_MAX_MACS`, else a seeded SAMPLE x SAMPLE block."""
    if m * n * k <= FULL_ORACLE_MAX_MACS:
        return None
    rng = np.random.default_rng(0)
    rows = np.sort(rng.choice(m, size=min(SAMPLE, m), replace=False))
    cols = np.sort(rng.choice(n, size=min(SAMPLE, n), replace=False))
    return rows, cols


def _scored(cs, a: np.ndarray, b: np.ndarray):
    """``(cs, a, b)`` as the oracle scores them (:func:`sampled_block`)."""
    block = sampled_block(a.shape[0], b.shape[1], a.shape[1])
    if block is None:
        return cs, a, b
    rows, cols = block
    return ([np.ascontiguousarray(c[rows][:, cols]) for c in cs], np.ascontiguousarray(a[rows]),
            np.ascontiguousarray(b[:, cols]))


def _tflops(a: np.ndarray, b: np.ndarray, mode: str, test_count: int, device) -> float:
    """Effective TFLOPS over ``test_count`` calls, or nan for a count of 0."""
    return effective_tflops(a, b, mode, test_count, device) if test_count > 0 else float("nan")


def _row(dev_name, complex_, input_mode, mode, op_a, op_b, m, n, k, err, tflops) -> str:
    return (
        f"{dev_name},{'Z' if complex_ else 'D'},{input_mode},{mode},"
        f"{op_a},{op_b},{m},{n},{k},{err['relative_residual']:e},"
        f"{err['max_relative_error']:e},{tflops:e}"
    )


def _run_case(
    gemm_kind: str,
    input_mode: str,
    mode: str,
    op_a: str,
    op_b: str,
    m: int,
    n: int,
    k: int,
    test_count: int,
    error_threshold: float = 0.0,
    device="cuda",
) -> int:
    complex_ = gemm_kind == "zgemm"
    a = generate_input(input_mode, (m, k) if op_a == "N" else (k, m), seed=0, complex_=complex_)
    b = generate_input(input_mode, (k, n) if op_b == "N" else (n, k), seed=1, complex_=complex_)

    c = gemm(a, b, mode=mode, op_a=op_a, op_b=op_b, device=device)
    ae, be = _op(a, op_a), _op(b, op_b)
    (cs, sa, sb) = _scored([c], ae, be)
    err = oracle.error_metrics(cs[0], sa, sb)

    tflops = _tflops(ae, be, mode, test_count, device)
    print(_row(_device_name(device), complex_, input_mode, mode, op_a, op_b, m, n, k, err, tflops),
          flush=True)
    if error_threshold and err["relative_residual"] >= error_threshold:
        print("^^^ FAILED ^^^^", flush=True)
        return 1
    return 0


def _size_list(kind: str, start: int, end: int, interval: int):
    if kind == "seq":
        return list(range(start, end + 1, interval))
    if kind == "exp2":
        out = []
        v = start
        while v <= end:
            out.append(v)
            v *= interval if interval > 1 else 2
        return out
    raise ValueError(f"unknown size mode {kind}")


#: the operand seeds of ``ci_test --seeds crc32``: those of the JAX
#: package's full-matrix runner (tools/ci_full_runner.py), whose logs are
#: the TPU's committed evidence (tests/artifacts/ci_full_*.log)
CRC32_SEED_SCHEME = ("zlib.crc32('{m}-{k}-{opA}') % 2**31 for A, "
                     "zlib.crc32('{k}-{n}-{opB}') % 2**31 for B")


def ci_seeds(seeds: str, m: int, n: int, k: int, op_a: str, op_b: str):
    """The (A, B) operand seeds of one ``ci_test`` case: 0 and 1 for
    ``"fixed"`` (the reference's and the JAX CLI's), or
    :data:`CRC32_SEED_SCHEME` for ``"crc32"``."""
    if seeds == "crc32":
        return (zlib.crc32(f"{m}-{k}-{op_a}".encode()) % 2**31,
                zlib.crc32(f"{k}-{n}-{op_b}".encode()) % 2**31)
    return 0, 1


def run_ci_test(sizes=(1023, 1024, 1025), device="cuda", seeds="fixed") -> int:
    """The reference 1944-case gate (main_test.cu:702-746): every (D|Z,
    opA, opB, m, n, k) over ``sizes`` at the nine modes fp64_int8_8..16,
    residual < 1e-15, ending ``NNNN / NNNN PASSED``.  ``seeds`` picks the
    operands (:func:`ci_seeds`); with ``"crc32"`` a first line ``# seeds
    crc32: ...`` names the scheme.

    One multi-C oracle call scores the nine modes of an operand set against
    one long-double accumulation.  The GEMMs run on ``device`` in order
    while the oracle calls run on a pool of host threads (one per CPU;
    ctypes releases the interpreter lock); rows print in case order.
    """
    modes = [f"fp64_int8_{ns}" for ns in range(8, 17)]
    dev = _device_name(device)
    cases = [
        (kind, op_a, op_b, m, n, k)
        for kind in ("dgemm", "zgemm")
        for op_a, op_b in itertools.product("NT", "NT")
        for m in sizes
        for n in sizes
        for k in sizes
    ]
    workers = len(os.sched_getaffinity(0))
    num_errors = total = 0
    if seeds not in ("fixed", "crc32"):
        raise ValueError(f"seeds must be 'fixed' or 'crc32', got {seeds!r}")
    if seeds == "crc32":
        print(f"# seeds crc32: {CRC32_SEED_SCHEME}", flush=True)

    def report(case, errs) -> None:
        nonlocal num_errors, total
        kind, op_a, op_b, m, n, k = case
        for mode, err in zip(modes, errs):
            total += 1
            print(_row(dev, kind == "zgemm", "urand01", mode, op_a, op_b, m, n, k, err,
                       float("nan")), flush=True)
            if err["relative_residual"] >= 1e-15:
                print("^^^ FAILED ^^^^", flush=True)
                num_errors += 1

    pending = collections.deque()
    with ThreadPoolExecutor(max_workers=workers) as pool:
        for case in cases:
            kind, op_a, op_b, m, n, k = case
            complex_ = kind == "zgemm"
            seed_a, seed_b = ci_seeds(seeds, m, n, k, op_a, op_b)
            a = generate_input("urand01", (m, k) if op_a == "N" else (k, m), seed=seed_a,
                               complex_=complex_)
            b = generate_input("urand01", (k, n) if op_b == "N" else (n, k), seed=seed_b,
                               complex_=complex_)
            cs = [gemm(a, b, mode=mode, op_a=op_a, op_b=op_b, device=device) for mode in modes]
            pending.append((case, pool.submit(oracle.error_metrics_multi,
                                              *_scored(cs, _op(a, op_a), _op(b, op_b)))))
            while len(pending) > 2 * workers:  # bounds the operand sets held
                case_done, fut = pending.popleft()
                report(case_done, fut.result())
        while pending:
            case_done, fut = pending.popleft()
            report(case_done, fut.result())
    print(f"{total - num_errors:5d} / {total:5d} PASSED", flush=True)
    return 1 if num_errors else 0


def run_matfile(path_a: str, path_b: str, modes, test_count: int, device="cuda") -> int:
    """Real-matrix replay (reference matfile mode, main_test.cu:273-406):
    load A and B from .npy files and evaluate each mode."""
    a = np.load(path_a)
    b = np.load(path_b)
    return _run_loaded(a, b, "matfile", modes, test_count, device)


def _run_loaded(a: np.ndarray, b: np.ndarray, input_name: str, modes, test_count: int,
                device) -> int:
    m, k = a.shape
    n = b.shape[1]
    complex_ = np.iscomplexobj(a) or np.iscomplexobj(b)
    print(CSV_HEADER)
    for mode in modes:
        c = gemm(a, b, mode=mode, device=device)
        (cs, sa, sb) = _scored([c], a, b)
        err = oracle.error_metrics(cs[0], sa, sb)
        tflops = _tflops(a, b, mode, test_count, device)
        print(_row(_device_name(device), complex_, input_name, mode, "N", "N", m, n, k, err,
                   tflops), flush=True)
    return 0


_RAW_DTYPES = {
    "fp32": np.float32,
    "fp64": np.float64,
    # x86-64 long double: 80-bit extended in 16 bytes — the same layout
    # the reference's fp128 matfiles hold (main_test.cu:273-302 loads
    # long double)
    "fp128": np.longdouble,
}


def load_raw_matrix(path: str, m: int, n: int, dtype: str, order: str = "F") -> np.ndarray:
    """Raw binary matrix loader (reference matfile replay parity,
    main_test.cu:273-302: fp32/fp64/fp128 dense files).

    The reference's ``mtk::matfile`` self-describing header comes from a
    submodule that is not checked out in the reference snapshot, so this
    loader takes dtype/shape explicitly (column-major by default, the BLAS
    convention the reference uses).  ``.npy`` files (run_matfile) remain
    the self-describing path.
    """
    if dtype not in _RAW_DTYPES:
        raise ValueError(f"dtype must be one of {sorted(_RAW_DTYPES)}, got {dtype!r}")
    raw = np.fromfile(path, dtype=_RAW_DTYPES[dtype])
    if raw.size != m * n:
        raise ValueError(
            f"{path}: expected {m}x{n} = {m*n} elements of {dtype}, found {raw.size}"
        )
    return np.asarray(raw.reshape((m, n), order=order), dtype=np.float64)


def run_matfile_raw(
    path_a: str, path_b: str, m: int, k: int, n: int, dtype: str, modes, test_count: int,
    device="cuda",
) -> int:
    """Evaluate modes on raw-binary operand dumps (fp32/fp64/fp128)."""
    a = load_raw_matrix(path_a, m, k, dtype)
    b = load_raw_matrix(path_b, k, n, dtype)
    return _run_loaded(a, b, f"matfile-{dtype}", modes, test_count, device)


class _PowerSampler:
    """Load-window power of one GPU through NVML (``libnvidia-ml.so.1``,
    ctypes); :meth:`stop` returns average watts, or None without NVML.

    The reference samples NVML during its run loops (main_test.cu:473-498).
    Here the total-energy counter (``nvmlDeviceGetTotalEnergyConsumption``,
    mJ) is read at start and stop where the card supports it: average watts
    = energy / elapsed.  Otherwise ``nvmlDeviceGetPowerUsage`` (mW) is
    sampled every 200 ms on a thread and averaged.  The card is the NVML
    device that ``torch.cuda._get_nvml_device_index`` maps ``device`` to
    (CUDA_VISIBLE_DEVICES taken into account).
    """

    def __init__(self, device):
        self._nvml = self._handle = None
        self._samples = []
        self._thread = self._stop = None
        self._e0 = self._t0 = None
        try:
            nvml = ctypes.CDLL("libnvidia-ml.so.1")
        except OSError:
            return  # no NVML on this machine: watts are n/a
        if nvml.nvmlInit_v2() != 0:
            return
        handle = ctypes.c_void_p()
        index = torch.cuda._get_nvml_device_index(torch.device(device))
        if nvml.nvmlDeviceGetHandleByIndex_v2(ctypes.c_uint(index), ctypes.byref(handle)) != 0:
            return
        self._nvml, self._handle = nvml, handle

    def _energy_mj(self):
        v = ctypes.c_ulonglong()
        if self._nvml.nvmlDeviceGetTotalEnergyConsumption(self._handle, ctypes.byref(v)) != 0:
            return None
        return v.value

    def _power_w(self):
        v = ctypes.c_uint()
        if self._nvml.nvmlDeviceGetPowerUsage(self._handle, ctypes.byref(v)) != 0:
            return None
        return v.value / 1e3

    def start(self):
        import threading

        self._t0 = time.perf_counter()
        if self._nvml is None:
            return
        self._e0 = self._energy_mj()
        if self._e0 is not None or self._power_w() is None:
            return  # the energy counter needs no sampler thread
        self._stop = threading.Event()

        def loop():
            while not self._stop.wait(0.2):
                w = self._power_w()
                if w is not None:
                    self._samples.append(w)

        self._thread = threading.Thread(target=loop, daemon=True)
        self._thread.start()

    def stop(self):
        """Average watts over the start..stop window, or None."""
        elapsed = time.perf_counter() - self._t0
        if self._thread is not None:
            self._stop.set()
            self._thread.join(timeout=2.0)
        if self._e0 is not None and elapsed > 0:
            e1 = self._energy_mj()
            if e1 is not None and e1 >= self._e0:
                return (e1 - self._e0) / 1e3 / elapsed  # mJ -> J -> W
        if self._samples:
            return sum(self._samples) / len(self._samples)
        return None


def run_power(gemm_kind: str, mode: str, size: int, min_seconds: float, device="cuda") -> int:
    """Sustained-throughput loop (reference power mode,
    main_test.cu:408-512: >=10 s NVML-sampled loops reporting TFLOPS, avg
    W and GFLOPS/W).  ``iters`` counts the GEMMs that ran in the window and
    ``avg_time`` is elapsed/iters (testing.sustained_run).  Watts are
    measured over the load window only; 'n/a' means no NVML (or a CPU
    device)."""
    complex_ = gemm_kind == "zgemm"
    a = generate_input("urand01", (size, size), seed=0, complex_=complex_)
    b = generate_input("urand01", (size, size), seed=1, complex_=complex_)
    sampler = _PowerSampler(device) if torch.device(device).type == "cuda" else None
    tflops, n_iter, avg_time = sustained_run(
        a, b, mode, min_seconds=min_seconds,
        on_measure_start=sampler.start if sampler is not None else None, device=device,
    )
    watts = sampler.stop() if sampler is not None else None
    if watts is not None:
        w_s = f"{watts:.1f}"
        eff_s = f"{tflops * 1e3 / watts:.2f}"
    else:
        w_s = eff_s = "n/a"
    print(
        f"power,{_device_name(device)},{mode},m=n=k={size},iters={n_iter},"
        f"avg_time={avg_time:.4e}s,tflops={tflops:.4g},watts={w_s},"
        f"gflops_per_w={eff_s}",
        flush=True,
    )
    return 0


def _hpl_matrix(size: int, seed: int, complex_: bool, device: torch.device) -> torch.Tensor:
    """The resident benchmark matrix, made on ``device`` from ``seed``:
    float32 uniform [0, 1) widened exactly to float64 (for ``z`` an
    imaginary part in [-0.5, 0.5) too), diagonal set to n (real) for a
    refinement-friendly condition number."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    a = torch.rand((size, size), dtype=torch.float32, device=device, generator=g).double()
    a.fill_diagonal_(float(size))
    if not complex_:
        return a
    im = (torch.rand((size, size), dtype=torch.float32, device=device, generator=g) - 0.5).double()
    im.fill_diagonal_(0.0)
    return torch.complex(a, im)


def run_hpl(
    mode: str,
    size: int,
    block: int,
    refine: int,
    resident: str = "auto",
    warmup: bool = False,
    profile: bool = False,
    panel: str = "auto",
    seed: int = 0,
    dtype: str = "d",
    device="cuda",
) -> int:
    """HPL-class solver benchmark: blocked LU factor + solve on the engine
    (the reference's motivating workload — its shim exists to accelerate
    HPL's dgemm calls, src/cublas.cu:280-295).  Reports factorization
    wall time, effective FP64 GFLOPS at the LU operation count (2/3 n^3;
    for ``dtype="z"``, ZHPL, x4 as the harness counts complex GEMMs,
    reference test/main_test.cu:140-141), and the final solve residual
    (scaled, HPL-style).  Returns 0 iff the residual is below 1e-14.

    ``resident`` = on|off|auto selects the resident factorization
    (linalg.lu_factor on a tensor: the matrix stays on ``device``; auto =
    on unless ``device`` is the CPU).  On that path the test matrix is
    generated on the device and the right-hand side and residual matvecs
    run through the engine — the matrix never crosses to the host.
    ``panel`` = host|device|auto picks where the resident path factors its
    panels (auto = device on a GPU, host on the CPU).  ``warmup`` runs the
    factorization once untimed first.  ``profile`` adds a per-phase
    breakdown from a second, instrumented pass (it waits for the device at
    the phase edges; the headline time is always measured unprofiled).
    """
    from . import linalg

    dev = torch.device(device)
    is_resident = resident == "on" or (resident == "auto" and dev.type != "cpu")
    if panel == "auto":
        panel = "device" if is_resident and dev.type != "cpu" else "host"
    complex_ = dtype == "z"
    rng_b = np.random.default_rng(99 + seed)
    x_true = rng_b.standard_normal(size)
    if complex_:
        x_true = x_true + 1j * rng_b.standard_normal(size)

    if is_resident:
        a = _hpl_matrix(size, seed, complex_, dev)
        norm_a = float(torch.linalg.norm(a))
        # b = A @ x_true through the engine (exact to one f64 rounding)
        b = linalg.engine_matvec(a, x_true)

        def factor(prof=None):
            return linalg.lu_factor(a, mode=mode, block=block, profile=prof, panel=panel)
    else:
        if complex_:
            rng_z = np.random.default_rng(7 + seed)
            a = rng_z.uniform(size=(size, size)) + 1j * (rng_z.uniform(size=(size, size)) - 0.5)
            a[np.arange(size), np.arange(size)] = size  # diag dominant
        else:
            a = generate_input("urand01", (size, size), seed=seed)
            a = a + size * np.eye(size)  # diagonally dominant
        norm_a = np.linalg.norm(a)
        b = a @ x_true

        def factor(prof=None):
            return linalg.lu_factor(a, mode=mode, block=block, device=dev)

    if warmup:
        factor()
    synchronize(dev)
    t0 = time.perf_counter()
    fac = factor()
    synchronize(dev)
    t_factor = time.perf_counter() - t0
    phases = {}
    if profile and is_resident:
        factor(phases)  # second, instrumented pass (waits per phase)

    x = linalg.solve(a, b, factor=fac, refine=refine)
    if is_resident:
        r_vec = linalg.engine_matvec(a, x, alpha=-1.0, beta=1.0, c=b)  # b - A @ x
    else:
        r_vec = b - a @ x
    resid = np.linalg.norm(r_vec) / (norm_a * np.linalg.norm(x) + np.linalg.norm(b))
    flops = (8.0 if complex_ else 2.0) / 3.0 * size**3
    extra = "".join(f",{k}={v:.4e}s" for k, v in sorted(phases.items()))
    print(
        f"{'zhpl' if complex_ else 'hpl'},{_device_name(dev)},{mode},n={size},block={block},"
        f"factor_time={t_factor:.4e}s,{'gflops_x4' if complex_ else 'gflops'}="
        f"{flops / t_factor / 1e9:.4g},"
        f"refine={refine},residual={resid:.4e},"
        f"resident={'device' if is_resident else 'host'},"
        f"panel={panel if is_resident else 'host'}{extra}",
        flush=True,
    )
    return 0 if resid < 1e-14 else 1


def main(argv=None) -> int:
    if argv is None:
        argv = sys.argv[1:]
    if argv and argv[0] == "matfile":
        q = argparse.ArgumentParser()
        q.add_argument("cmd")
        q.add_argument("a_npy")
        q.add_argument("b_npy")
        q.add_argument("modes", nargs="?", default="fp64_int8_9")
        q.add_argument("--test-count", type=int, default=1)
        q.add_argument("--device", default="cuda")
        ar = q.parse_args(argv)
        return run_matfile(ar.a_npy, ar.b_npy, ar.modes.split(","), ar.test_count, ar.device)
    if argv and argv[0] == "matfile_raw":
        q = argparse.ArgumentParser()
        q.add_argument("cmd")
        q.add_argument("a_bin")
        q.add_argument("b_bin")
        q.add_argument("m", type=int)
        q.add_argument("k", type=int)
        q.add_argument("n", type=int)
        q.add_argument("--dtype", default="fp64", choices=sorted(_RAW_DTYPES))
        q.add_argument("modes", nargs="?", default="fp64_int8_9")
        q.add_argument("--test-count", type=int, default=1)
        q.add_argument("--device", default="cuda")
        ar = q.parse_args(argv)
        return run_matfile_raw(
            ar.a_bin, ar.b_bin, ar.m, ar.k, ar.n, ar.dtype,
            ar.modes.split(","), ar.test_count, ar.device,
        )
    if argv and argv[0] == "hpl":
        q = argparse.ArgumentParser()
        q.add_argument("cmd")
        q.add_argument("mode", nargs="?", default="fp64_int8_9")
        q.add_argument("size", nargs="?", type=int, default=4096)
        q.add_argument("--block", type=int, default=1024)
        q.add_argument("--refine", type=int, default=0)
        q.add_argument("--resident", default="auto", choices=["auto", "on", "off"])
        q.add_argument("--panel", default="auto", choices=["auto", "host", "device"])
        q.add_argument("--warmup", action="store_true")
        q.add_argument("--profile", action="store_true")
        q.add_argument("--seed", type=int, default=0)
        q.add_argument("--dtype", default="d", choices=["d", "z"])
        q.add_argument("--device", default="cuda")
        ar = q.parse_args(argv)
        return run_hpl(
            ar.mode, ar.size, ar.block, ar.refine,
            resident=ar.resident, warmup=ar.warmup, profile=ar.profile,
            panel=ar.panel, seed=ar.seed, dtype=ar.dtype, device=ar.device,
        )
    if argv and argv[0] == "power":
        q = argparse.ArgumentParser()
        q.add_argument("cmd")
        q.add_argument("gemm", nargs="?", default="dgemm", choices=["dgemm", "zgemm"])
        q.add_argument("mode", nargs="?", default="fp64_int8_9")
        q.add_argument("size", nargs="?", type=int, default=4096)
        q.add_argument("--min-seconds", type=float, default=10.0)
        q.add_argument("--device", default="cuda")
        ar = q.parse_args(argv)
        return run_power(ar.gemm, ar.mode, ar.size, ar.min_seconds, ar.device)

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("input", help="urand01|normal01|exp_rand-<phi>|ci_test")
    p.add_argument("gemm", nargs="?", default="dgemm", choices=["dgemm", "zgemm"])
    p.add_argument("modes", nargs="?", default="fp64_int8_9",
                   help="comma-separated compute modes")
    p.add_argument("size_mode", nargs="?", default="seq", choices=["seq", "exp2"])
    p.add_argument("start", nargs="?", type=int, default=1024)
    p.add_argument("end", nargs="?", type=int, default=1024)
    p.add_argument("interval", nargs="?", type=int, default=1024)
    p.add_argument("--test-count", type=int, default=10)
    p.add_argument("--ops", default="NN", help="pairs like NN,NT,TN,TT")
    p.add_argument("--ci-sizes", default="1023,1024,1025")
    p.add_argument("--seeds", default="fixed", choices=["fixed", "crc32"],
                   help="ci_test operand seeds: 0 and 1, or the JAX runner's crc32 scheme")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    if args.input == "ci_test":
        sizes = tuple(int(s) for s in args.ci_sizes.split(","))
        return run_ci_test(sizes, args.device, args.seeds)

    print(CSV_HEADER)
    rc = 0
    for size in _size_list(args.size_mode, args.start, args.end, args.interval):
        for mode in args.modes.split(","):
            for ops in args.ops.split(","):
                rc |= _run_case(
                    args.gemm, args.input, mode, ops[0], ops[1],
                    size, size, size, args.test_count, device=args.device,
                )
    return rc


if __name__ == "__main__":
    sys.exit(main())
