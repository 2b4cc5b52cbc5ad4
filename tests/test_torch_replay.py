"""The engine's replay (``core/gemm.py``): a small 2-D product's kernel
chain captured once per call signature and replayed as one CUDA graph.

On the CPU: which products replay (the cut at its edges, the eager
cases), the signature's fields, the LRU cache under its byte cap, the
bytes an entry holds and the launch counters that a replay adds to.  The
``cuda`` tests hold replayed products bit for bit against the eager chain
on the card; run them on the GPU machine with
``python -m pytest --noconftest tests/test_torch_replay.py -m cuda``
(the suite's conftest imports jax, which that machine need not have)."""

import json
import os
import threading

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import ozimmu_tpu_torch as ozt  # noqa: E402
import ozimmu_tpu_torch.intercept as ozi  # noqa: E402
from ozimmu_tpu_torch import native  # noqa: E402
from ozimmu_tpu_torch.core import gemm as core  # noqa: E402
from ozimmu_tpu_torch.ops import epilogue_cuda, exponent_cuda, recombine_cuda, split_cuda  # noqa: E402
from ozimmu_tpu_torch.schedule import (  # noqa: E402
    REPLAY_BUDGET_SHARE, REPLAY_MAX_BYTES, REPLAY_MAX_WORK, hbm_budget_bytes, replay_bytes,
    replay_cache_bytes, schedule_flops, shared_device,
)
from ozimmu_tpu_torch.utils import profiling  # noqa: E402

# ---------------------------------------------------------------------------
# on the CPU: the decision, the signature, the cache
# ---------------------------------------------------------------------------


#: the longest column (n = k = 1) whose entry fits REPLAY_MAX_BYTES:
#: replay_bytes(m, 1, 1, 9) = 176 m + 156
_TALL = (REPLAY_MAX_BYTES - 156) // 176


@pytest.mark.parametrize("m,n,k,complex_,want", [
    (1024, 1024, 1024, False, True),  # the intercepted cell's product
    (512, 512, 512, False, True),
    (2048, 2048, 2048, False, True),  # the cut of int8 work itself
    (2048, 2048, 2049, False, False),  # and one more
    (2049, 2048, 2048, False, False),
    (1024, 1024, 1024, True, True),  # four passes: four times the work
    (1024, 1024, 2048, True, True),
    (1024, 1024, 2049, True, False),
    (_TALL, 1, 1, False, True),  # the cut of bytes itself
    (_TALL + 1, 1, 1, False, False),  # and one more
    (8192, 8192, 128, False, False),  # the work of 2048^3, bound by its bytes
    (4096, 4096, 512, False, True),
    (16384, 16384, 16384, False, False),  # the headline
    (8192, 8192, 8192, True, False),  # the ZGEMM cell
    (44032, 44032, 1024, False, False),  # HPL's first trailing update
    (1024, 44032, 1024, False, False),  # and its first U12 product
    (3072, 3072, 1024, False, False),  # HPL's trailing updates from 3072 up
    (2048, 2048, 1024, False, True),  # and those below
    (1024, 8192, 1024, False, True),  # its U12 products up to n = 8192
    (1024, 9216, 1024, False, False),
])
def test_replays_at_most_the_cuts_of_int8_work_and_bytes(m, n, k, complex_, want):
    assert replay_bytes(_TALL, 1, 1, 9) <= REPLAY_MAX_BYTES < replay_bytes(_TALL + 1, 1, 1, 9)
    fits = (schedule_flops(9, m, n, k, complex_) <= REPLAY_MAX_WORK
            and replay_bytes(m, n, k, 9, complex_) <= REPLAY_MAX_BYTES)
    assert fits == want
    assert core.replays(m, n, k, 9, complex_) == want


@pytest.mark.parametrize("why", ["batched", "panels", "profiled", "capturing", "cpu", "auto",
                                 "large"])
def test_batches_panels_profilers_callers_captures_and_the_cpu_stay_eager(why, monkeypatch):
    """Through :func:`_run` on the CPU, with the device taken for one that
    can capture (where the case is not the device): a small 2-D product in
    one panel asks for its replay, each case's product runs the eager
    chain without asking."""
    asked = []
    monkeypatch.setattr(core, "_replayed", lambda *args: asked.append(args))
    graphs = core._graphs
    monkeypatch.setattr(core, "_graphs", lambda dev: True)
    g = torch.Generator().manual_seed(0)
    m, n, k = 40, 24, 32
    shape = (2,) if why == "batched" else ()
    A = [torch.rand((*shape, m, k), dtype=torch.float64, generator=g)]
    B = [torch.rand((*shape, k, n), dtype=torch.float64, generator=g)]
    want = core._run(A, B, [None], 9, 1.0, 0.0) if why == "batched" else None
    core._run([A[0][0] if shape else A[0]], [B[0][0] if shape else B[0]], [None], 9, 1.0, 0.0)
    assert len(asked) == 1  # the 2-D product alone asks
    if want is None:
        want = core._run(A, B, [None], 9, 1.0, 0.0)
    asked.clear()
    kw = {}
    if why == "panels":
        kw = dict(n_chunks=2)
    elif why == "profiled":
        kw = dict(n_chunks=1, phase=lambda name: core._NO_PHASE)
    elif why == "capturing":
        monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: True)
        monkeypatch.setattr(core, "_graphs", lambda dev: graphs(torch.device("cuda")))
    elif why == "cpu":
        monkeypatch.setattr(core, "_graphs", graphs)
    elif why == "auto":  # auto-chunking splits it into column panels
        monkeypatch.setattr(core, "auto_n_chunks", lambda *args, **kw: 2)
    elif why == "large":  # over the cut of int8 work
        monkeypatch.setattr(core, "REPLAY_MAX_WORK", schedule_flops(9, m, n, k) - 1)
    got = core._run(A, B, [None], 9, 1.0, 0.0, **kw)
    assert not asked
    assert all(torch.equal(x, y) for x, y in zip(got, want))


@pytest.mark.parametrize("device,capturing,want", [
    ("cuda", False, True), ("cuda", True, False), ("cpu", False, False), ("cpu", True, False),
])
def test_only_a_card_whose_stream_is_not_capturing_takes_a_graph(monkeypatch, device, capturing,
                                                                 want):
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: capturing)
    assert core._graphs(torch.device(device)) == want


def test_cpu_products_never_reach_the_cache(monkeypatch):
    monkeypatch.setattr(core, "_CACHE", core.ReplayCache())
    counts = (core.CAPTURES, core.REPLAYS, core.EAGER_SMALL, core.CAPTURE_FAILURES)
    g = torch.Generator().manual_seed(0)
    a, b = (torch.rand((48, 48), dtype=torch.float64, generator=g) for _ in range(2))
    first = core.gemm_f64(a, b, 9)
    assert torch.equal(core.gemm_f64(a, b, 9), first)
    assert (core.CAPTURES, core.REPLAYS, core.EAGER_SMALL, core.CAPTURE_FAILURES) == counts
    assert not core._CACHE.states


_BASE = dict(parts=1, m=64, n=48, k=32, num_split=9, alpha=1.0, beta=0.0, c_given=(False,),
             device="cuda:0", stream=7)


@pytest.mark.parametrize("field,value", [
    ("parts", 2), ("m", 65), ("n", 49), ("k", 33), ("num_split", 8), ("alpha", 0.5),
    ("alpha", -1.0), ("beta", 1.0), ("beta", -0.0), ("c_given", (True,)), ("device", "cuda:1"),
    ("stream", 8), ("alpha", complex(1.0, 0.5)), ("interleaved", True),
])
def test_each_field_of_the_signature_tells_two_products_apart(field, value):
    assert core.replay_key(**_BASE) != core.replay_key(**{**_BASE, field: value})
    assert core.replay_key(**_BASE) == core.replay_key(**dict(_BASE))


@pytest.mark.parametrize("x,y,same", [
    (0.0, -0.0, False), (float("nan"), float("nan"), True), (1.0, complex(1.0, 0.0), True),
    (complex(0.0, 1.0), complex(0.0, -1.0), False), (1.0, 1.0 + 2**-52, False),
])
def test_alpha_and_beta_enter_the_signature_by_their_bits(x, y, same):
    keys = [core.replay_key(**{**_BASE, "alpha": v, "beta": v}) for v in (x, y)]
    assert (keys[0] == keys[1]) == same
    assert hash(keys[0]) == hash(core.replay_key(**{**_BASE, "alpha": x, "beta": x}))


class _Chain(core._Replay):
    """A captured chain's stand-in: its bytes only."""

    def __init__(self, nbytes):
        self.nbytes = nbytes


def _chains(cache):
    return [k for k, s in cache.states.items() if isinstance(s, core._Replay)]


def test_the_cache_drops_the_least_recently_used_under_its_byte_cap():
    cache = core.ReplayCache()
    for key in "ab":
        assert cache.state(key) is None
        cache.put(key, _Chain(40), 100)
    a = cache.states["a"]
    assert cache.state("a") is a  # a is now the most recently used
    assert cache.state("c") is None
    cache.put("c", _Chain(40), 100)
    assert _chains(cache) == ["a", "c"] and cache.nbytes == 80
    assert cache.state("b") is core._SEEN  # dropped back: its next call captures again
    cache.put("c", _Chain(60), 100)  # replaced in place
    assert _chains(cache) == ["a", "c"] and cache.nbytes == 100
    cache.state("d")
    cache.put("d", _Chain(40), 100)
    assert _chains(cache) == ["c", "d"] and cache.nbytes == 100
    cache.put("e", core._EAGER, 100)
    assert cache.states["e"] is core._EAGER and cache.nbytes == 100
    cache.put("f", _Chain(10), 50)  # a cap that shrank (a smaller budget, more sharers)
    assert _chains(cache) == ["d", "f"] and cache.nbytes == 50
    cache.clear()
    assert cache.nbytes == 0 and not cache.states


def test_a_signature_captures_at_its_second_call_and_the_oldest_seen_are_forgotten(monkeypatch):
    monkeypatch.setattr(core, "_SIGNATURES", 3)
    cache = core.ReplayCache()
    assert cache.state("a") is None and cache.state("a") is core._SEEN
    cache.put("a", _Chain(10), 100)
    for key in "bcd":
        assert cache.state(key) is None
    assert list(cache.states) == ["b", "c", "d"] and cache.nbytes == 0  # a's chain went with it
    assert cache.state("a") is None  # forgotten: one more eager call


@pytest.mark.parametrize("budget_mb,sharers", [(1200, 1), (96, 1), (96, 4), (None, 1), (None, 4)])
def test_the_cache_cap_follows_the_memory_budget(monkeypatch, budget_mb, sharers):
    if budget_mb is None:
        monkeypatch.delenv("OZIMMU_HBM_BUDGET_MB", raising=False)
    else:
        monkeypatch.setenv("OZIMMU_HBM_BUDGET_MB", str(budget_mb))
    with shared_device(sharers):
        cap = replay_cache_bytes("cpu")
        assert cap == int(hbm_budget_bytes("cpu") * REPLAY_BUDGET_SHARE) > 0
    if budget_mb is not None:
        assert cap == int(budget_mb * 2**20 * REPLAY_BUDGET_SHARE)
    else:
        with shared_device(1):
            assert cap == pytest.approx(replay_cache_bytes("cpu") / sharers, rel=1e-6)


@pytest.mark.parametrize("m,n,k,complex_,c_parts,want", [
    # inputs 16 MiB, planes 18 MiB, row and column scales, the output 8 MiB
    # and S 12 MiB: about 57 MB a 1024^3 entry
    (1024, 1024, 1024, False, 0, 16 * 2**20 + 9 * 2048 * 1024 + 4 * 2048 + 8 * 2**20 + 12 * 2**20),
    (1024, 1024, 1024, False, 1, 16 * 2**20 + 9 * 2048 * 1024 + 4 * 2048 + 16 * 2**20 + 12 * 2**20),
    (1000, 24, 1000, False, 0, 8 * 1000 * 1024 + 9 * 1024 * 1008 + 4 * 1024 + 8 * 24000 + 12 * 24000),
    (512, 512, 512, True, 2, 2 * (4 * 2**20 + 9 * 1024 * 512 + 4 * 1024 + 2 * 2**20) + 4 * 2**20
     + 4 * 12 * 2**18),
])
def test_an_entry_holds_its_static_buffers_planes_triples_and_output(m, n, k, complex_, c_parts,
                                                                     want):
    assert replay_bytes(m, n, k, 9, complex_, c_parts) == want


def test_a_replay_adds_what_its_capture_counted_to_each_wrappers_counter(monkeypatch):
    """The wrappers note each launch on the capturing thread's tape; a
    replay counts the tape once more, so that every counter keeps meaning
    launches on the card."""
    for mod, name in ((split_cuda, "LAUNCHES"), (exponent_cuda, "LAUNCHES"),
                      (recombine_cuda, "LAUNCHES"), (recombine_cuda, "LOCKSTEP_LAUNCHES"),
                      (epilogue_cuda, "LAUNCHES"), (epilogue_cuda, "ZFOLD_LAUNCHES")):
        monkeypatch.setattr(mod, name, 5)
    monkeypatch.setattr(recombine_cuda, "LAUNCHES_BY_TILE", [1, 2, 3])

    def counters():
        return (split_cuda.LAUNCHES, exponent_cuda.LAUNCHES, recombine_cuda.LAUNCHES,
                recombine_cuda.LOCKSTEP_LAUNCHES, epilogue_cuda.LAUNCHES,
                epilogue_cuda.ZFOLD_LAUNCHES, list(recombine_cuda.LAUNCHES_BY_TILE))

    before = counters()
    with native.recording() as tape:
        for mod, name, index in ((split_cuda, "LAUNCHES", None), (split_cuda, "LAUNCHES", None),
                                 (exponent_cuda, "LAUNCHES", None),
                                 (exponent_cuda, "LAUNCHES", None),
                                 (recombine_cuda, "LAUNCHES", None),
                                 (recombine_cuda, "LAUNCHES_BY_TILE", 2),
                                 (epilogue_cuda, "LAUNCHES", None)):
            native.counted(mod.__name__, name, index)
    assert len(tape) == 7 and counters() == before  # noted, not counted again
    native.count(tape, 3)
    assert counters() == (11, 11, 8, 5, 8, 5, [1, 2, 6])
    native.count(tape, -3)  # a capture that failed takes its launches off
    assert counters() == before


def test_another_threads_launches_stay_off_the_tape():
    """A launch of another thread while one thread captures is not the
    captured chain's."""
    with native.recording() as tape:
        other = threading.Thread(target=native.counted, args=(split_cuda.__name__, "LAUNCHES"))
        other.start()
        other.join()
        native.counted(exponent_cuda.__name__, "LAUNCHES")
    native.counted(recombine_cuda.__name__, "LAUNCHES")  # after the block
    assert tape == [(exponent_cuda.__name__, "LAUNCHES", None)]


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def dev(monkeypatch):
    """A CUDA device and a fresh cache for the test."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    monkeypatch.setattr(core, "_CACHE", core.ReplayCache())
    return torch.device("cuda")


def _eager(monkeypatch, fn):
    """``fn()`` with the cut below every product: the eager chain."""
    with monkeypatch.context() as m:
        m.setattr(core, "REPLAY_MAX_WORK", -1)
        return fn()


def _counts():
    return (core.CAPTURES, core.REPLAYS, core.EAGER_SMALL, core.CAPTURE_FAILURES)


def _moved(before):
    return tuple(x - y for x, y in zip(_counts(), before))


def _bits_equal(x, y) -> bool:
    if x.is_complex():
        return _bits_equal(x.real.contiguous(), y.real.contiguous()) and \
            _bits_equal(x.imag.contiguous(), y.imag.contiguous())
    return x.shape == y.shape and torch.equal(x.view(torch.int64), y.view(torch.int64))


def _rand(shape, g, dev, dtype=torch.float64):
    return torch.rand(shape, dtype=dtype, device=dev, generator=g) - 0.25


@pytest.mark.cuda
def test_intercepted_1024_products_replay_bit_for_bit_over_eight_pairs(dev, monkeypatch):
    g = torch.Generator(device=dev).manual_seed(1)
    pairs = [(_rand((1024, 1024), g, dev), _rand((1024, 1024), g, dev)) for _ in range(8)]
    with ozi.intercept(mode="fp64_int8_9"):
        want = [_eager(monkeypatch, lambda: a @ b) for a, b in pairs]
        before = _counts()
        got = [a @ b for _ in range(2) for a, b in pairs]
    assert _moved(before) == (1, 15, 1, 0)  # first call eager, the second captures
    assert all(_bits_equal(x, want[i % 8]) for i, x in enumerate(got))


@pytest.mark.cuda
@pytest.mark.parametrize("alpha,beta", [(0.75, -1.25), (-0.0, 1.0), (1.0, 0.0)])
def test_alpha_beta_and_a_strided_c_window_replay_bit_for_bit(dev, monkeypatch, alpha, beta):
    g = torch.Generator(device=dev).manual_seed(2)
    m, n, k = 1000, 777, 513
    a, b = _rand((m, k), g, dev), _rand((k, n), g, dev)
    big = _rand((m + 8, n + 16), g, dev)
    c = big[3:3 + m, 5:5 + n]

    def call():
        return ozt.gemm(a, b, mode="fp64_int8_9", alpha=alpha, beta=beta, c=c)

    want = _eager(monkeypatch, call)
    before = _counts()
    got = [call() for _ in range(4)]
    assert _moved(before) == (1, 3, 1, 0)
    assert all(_bits_equal(x, want) for x in got)


@pytest.mark.cuda
def test_a_complex_product_replays_bit_for_bit(dev, monkeypatch):
    g = torch.Generator(device=dev).manual_seed(3)
    m, n, k = 512, 384, 640
    a, b, c = (torch.complex(_rand(s, g, dev), _rand(s, g, dev))
               for s in ((m, k), (k, n), (m, n)))

    def call():
        return ozt.gemm(a, b, mode="fp64_int8_9", alpha=0.75 - 0.5j, beta=-0.25 + 0.5j, c=c)

    want = _eager(monkeypatch, call)
    before = _counts()
    got = [call() for _ in range(3)]
    assert _moved(before) == (1, 2, 1, 0)
    assert all(_bits_equal(x, want) for x in got)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.complex128])
def test_a_product_into_a_window_of_c_replays_bit_for_bit(dev, dtype):
    """``gemm_int8(..., c=w, out=w)``, w a window of a larger matrix (the
    solvers' last trailing updates), called three times beside the plane
    path (``gemm_f64`` / ``zgemm_f64``) on the same C0: each call's window
    equals the plane path's result, and nothing outside it moves.  A real
    product shares the plane path's signature (eager, captured, then four
    replays); a complex one into a complex128 output is a signature of its
    own, captured with the fold's interleaved output (each: eager,
    capture, replay)."""
    g = torch.Generator(device=dev).manual_seed(7)
    m, n, k = 512, 384, 640

    def rand(shape):
        x = _rand(shape, g, dev)
        return torch.complex(x, _rand(shape, g, dev)) if dtype == torch.complex128 else x

    a, b, big = rand((m, k)), rand((k, n)), rand((m + 3, n + 5))
    win = big[1:1 + m, 2:2 + n]
    alpha, beta = (-1.0, 1.0) if dtype == torch.float64 else (0.75 - 0.5j, -0.25 + 0.5j)
    before = _counts()
    for _ in range(3):
        c0, keep = win.clone(), big.clone()
        if dtype == torch.float64:
            want = core.gemm_f64(a, b, 9, alpha, beta, c0, 1)
        else:
            planes = [p for x in (a, b, c0) for p in (x.real.contiguous(), x.imag.contiguous())]
            want = torch.complex(*core.zgemm_f64(*planes[:4], 9, alpha, beta, *planes[4:],
                                                 n_chunks=1))
        assert core.gemm_int8(a, b, 9, alpha, beta, win, 1, out=win) is win
        assert _bits_equal(win, want)
        outside = torch.ones(big.shape, dtype=torch.bool, device=dev)
        outside[1:1 + m, 2:2 + n] = False
        assert _bits_equal(big[outside], keep[outside])
    assert _moved(before) == ((1, 5, 1, 0) if dtype == torch.float64 else (2, 4, 2, 0))


@pytest.mark.cuda
def test_an_earlier_result_survives_later_calls_and_edits_of_its_inputs(dev, monkeypatch):
    g = torch.Generator(device=dev).manual_seed(4)
    a, b = _rand((640, 512), g, dev), _rand((512, 768), g, dev)
    want = _eager(monkeypatch, lambda: ozt.gemm(a, b, mode="fp64_int8_9"))
    kept = [ozt.gemm(a, b, mode="fp64_int8_9") for _ in range(3)]  # eager, captured, replayed
    a.mul_(3.0)
    b.fill_(1.0)
    a2, b2 = _rand((640, 512), g, dev), _rand((512, 768), g, dev)
    later = [ozt.gemm(a2, b2, mode="fp64_int8_9") for _ in range(4)]  # replays over the output
    torch.cuda.synchronize()
    assert all(_bits_equal(x, want) for x in kept)
    assert all(_bits_equal(x, _eager(monkeypatch, lambda: ozt.gemm(a2, b2, mode="fp64_int8_9")))
               for x in later)


@pytest.mark.cuda
def test_a_callers_own_capture_takes_the_eager_chain(dev, monkeypatch):
    g = torch.Generator(device=dev).manual_seed(5)
    a, b = _rand((768, 768), g, dev), _rand((768, 768), g, dev)
    want = _eager(monkeypatch, lambda: ozt.gemm(a, b, mode="fp64_int8_9"))
    ozt.gemm(a, b, mode="fp64_int8_9")  # seen: the next call outside a capture would capture
    torch.cuda.synchronize()
    before = _counts()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = ozt.gemm(a, b, mode="fp64_int8_9")
    assert _moved(before) == (0, 0, 0, 0)
    graph.replay()
    torch.cuda.synchronize()
    assert _bits_equal(out, want)


def _launches():
    return (split_cuda.LAUNCHES, exponent_cuda.LAUNCHES, recombine_cuda.LAUNCHES,
            sum(recombine_cuda.LAUNCHES_BY_TILE), epilogue_cuda.LAUNCHES,
            epilogue_cuda.ZFOLD_LAUNCHES)


@pytest.mark.cuda
@pytest.mark.parametrize("complex_", [False, True])
def test_the_launch_counters_after_n_replayed_calls_equal_n_eager_calls(dev, complex_):
    g = torch.Generator(device=dev).manual_seed(6)
    dtype = torch.complex128 if complex_ else torch.float64
    a, b = _rand((384, 256), g, dev, dtype), _rand((256, 320), g, dev, dtype)
    calls = 6
    before, counted = _launches(), _counts()
    for _ in range(calls):
        ozt.gemm(a, b, mode="fp64_int8_9")
    per_call = (4, 4, 4, 4, 0, 1) if complex_ else (2, 2, 1, 1, 1, 0)
    assert tuple(x - y for x, y in zip(_launches(), before)) == tuple(calls * p for p in per_call)
    assert _moved(counted) == (1, calls - 1, 1, 0)


@pytest.mark.cuda
def test_a_replayed_calls_kernels_are_traced_inside_its_replay_span(dev, tmp_path):
    """The profiler sees each kernel of a replayed chain (the benchmark's
    engine check counts its recombine kernels), joined to the graph's
    launch inside ``oz.replay``, inside ``oz.engine``."""
    g = torch.Generator(device=dev).manual_seed(7)
    a, b = _rand((1024, 1024), g, dev), _rand((1024, 1024), g, dev)
    for _ in range(2):
        ozt.gemm(a, b, mode="fp64_int8_9")
    torch.cuda.synchronize()
    calls = 3
    with ozt.device_trace(str(tmp_path)):
        for _ in range(calls):
            ozt.gemm(a, b, mode="fp64_int8_9")
    (path,) = [os.path.join(tmp_path, f) for f in os.listdir(tmp_path)]
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    spans = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"]) for e in events
             if e.get("cat") == "user_annotation" and e.get("name", "").startswith("oz.")]
    assert sum(n == "oz.replay" for _, _, n in spans) == calls
    assert not {"oz.split", "oz.recombine", "oz.epilogue"} & {n for _, _, n in spans}
    launches = {e["args"]["correlation"]: float(e["ts"]) for e in events
                if e.get("cat") in ("cuda_runtime", "cuda_driver")
                and "correlation" in e.get("args", {})}
    kernels = [e for e in events if e.get("cat") == "kernel" and "recombine_kernel" in e["name"]]
    assert len(kernels) == calls
    for e in kernels:
        t = launches[e["args"]["correlation"]]
        assert any(s <= t <= end for s, end, n in spans if n == "oz.replay")
    assert sum(e.get("cat") == "kernel" and "epilogue_kernel" in e["name"]
               for e in events) == calls


@pytest.mark.cuda
def test_a_replayed_call_whose_kernels_the_trace_lost_is_caught(dev, tmp_path, monkeypatch):
    """A replayed call's kernels join its graph's launch: a trace that
    lost them raises, as it does for a kernel launched alone."""
    g = torch.Generator(device=dev).manual_seed(8)
    a, b = _rand((1024, 1024), g, dev), _rand((1024, 1024), g, dev)
    for _ in range(2):
        ozt.gemm(a, b, mode="fp64_int8_9")
    torch.cuda.synchronize()
    read, seen = profiling.launches_and_kernels, {}

    def lost(events, skip=0):
        seen["kept"] = read(events, skip)
        seen["graphs"] = sum(e.get("cat") == "cuda_runtime" and "GraphLaunch" in e.get("name", "")
                             for e in events)
        return read([e for e in events if e.get("cat") != "kernel"], skip)

    monkeypatch.setattr(profiling, "launches_and_kernels", lost)
    with pytest.raises(profiling.TraceLostError):
        with ozt.device_trace(str(tmp_path)):
            for _ in range(3):
                ozt.gemm(a, b, mode="fp64_int8_9")
    assert seen["graphs"] == 3
    assert seen["kept"][0] >= 3 and seen["kept"][0] == seen["kept"][1]


@pytest.mark.cuda
@pytest.mark.parametrize("why", ["batched", "panels", "profiled"])
def test_batched_paneled_and_profiled_products_on_the_card_stay_eager(dev, why):
    g = torch.Generator(device=dev).manual_seed(9)
    if why == "batched":
        a, b = _rand((3, 384, 256), g, dev), _rand((3, 256, 320), g, dev)

        def call():
            return ozt.gemm_batched(a, b, mode="fp64_int8_9")
    elif why == "panels":
        a, b = _rand((384, 256), g, dev), _rand((256, 320), g, dev)

        def call():
            return core.gemm_f64(a, b, 9, n_chunks=2)
    else:
        a, b = _rand((384, 256), g, dev), _rand((256, 320), g, dev)
        handle = ozt.create(device="cuda")
        handle.profiler.enable()

        def call():
            return ozt.gemm(a, b, mode="fp64_int8_9", handle=handle)
    before = _counts()
    got = [call() for _ in range(3)]
    assert _moved(before) == (0, 0, 0, 0)
    assert all(_bits_equal(x, got[0]) for x in got)


@pytest.mark.cuda
def test_a_chain_over_the_caches_cap_stays_eager(dev, monkeypatch):
    """Under ``OZIMMU_HBM_BUDGET_MB`` = 240 the cache may hold 20 MiB,
    less than a 1024^3 chain's 57 MB: the product stays eager, and the
    cache holds nothing."""
    monkeypatch.setenv("OZIMMU_HBM_BUDGET_MB", "240")
    g = torch.Generator(device=dev).manual_seed(10)
    a, b = _rand((1024, 1024), g, dev), _rand((1024, 1024), g, dev)
    before = _counts()
    got = [ozt.gemm(a, b, mode="fp64_int8_9") for _ in range(3)]
    assert _moved(before) == (0, 0, 3, 0)
    assert core._CACHE.nbytes == 0 and core._CACHE.states  # remembered as eager
    assert all(_bits_equal(x, got[0]) for x in got)


@pytest.mark.cuda
def test_an_entry_counts_the_bytes_the_allocator_holds_for_it(dev):
    """A chain's bytes are its static buffers and the growth of the
    reserved memory over its capture (the graph's pool), as the cache
    counts them."""
    g = torch.Generator(device=dev).manual_seed(11)
    a, b = _rand((1024, 1024), g, dev), _rand((1024, 1024), g, dev)
    for _ in range(2):
        ozt.gemm(a, b, mode="fp64_int8_9")
    (entry,) = [s for s in core._CACHE.states.values() if isinstance(s, core._Replay)]
    assert core._CACHE.nbytes == entry.nbytes
    static = 16 * 1024 * 1024
    assert entry.nbytes >= static
    print(f"1024^3 entry: {entry.nbytes} B held, {replay_bytes(1024, 1024, 1024, 9)} B estimated")

