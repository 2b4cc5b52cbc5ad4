"""The distributed layer's planning, without processes: mesh shapes, the
host-cut axis, the memory models and the variant chooser of
``ozimmu_tpu_torch.parallel`` against ``ozimmu_tpu.parallel``, the
pre-sharded chooser's budget re-check, and ``initialize`` turning
arguments and the environment into ``init_process_group`` arguments."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import torch.distributed as dist  # noqa: E402
import torch.distributed.device_mesh as device_mesh  # noqa: E402

from ozimmu_tpu.parallel import gemm as jpar  # noqa: E402
from ozimmu_tpu.parallel import launch as jlaunch  # noqa: E402
from ozimmu_tpu_torch import schedule  # noqa: E402
from ozimmu_tpu_torch.parallel import gemm as tpar  # noqa: E402
from ozimmu_tpu_torch.parallel import launch as tlaunch  # noqa: E402


class _Mesh:
    """What the chooser reads of a DeviceMesh: named dim sizes."""

    device_type = "cpu"

    def __init__(self, xs, ys):
        self.mesh_dim_names = ("x", "y")
        self._sizes = (xs, ys)

    def size(self, dim):
        return self._sizes[dim]


class _JaxMesh:
    """What the JAX package's chooser reads of a Mesh."""

    def __init__(self, xs, ys):
        self.shape = {"x": xs, "y": ys}


MESHES = [(2, 2), (1, 4), (4, 1), (3, 3), (2, 4), (4, 2), (1, 1)]


@pytest.mark.parametrize("n", range(1, 9))
def test_make_mesh_2d_shape(monkeypatch, n):
    made = {}

    def fake_init(device_type, shape, mesh_dim_names):
        made.update(device_type=device_type, shape=shape, names=mesh_dim_names)
        return "mesh"

    monkeypatch.setattr(dist, "get_world_size", lambda group=None: n)
    monkeypatch.setattr(device_mesh, "init_device_mesh", fake_init)
    assert tpar.make_mesh_2d() == "mesh"
    assert made == dict(device_type="cuda", shape=jpar.make_mesh_2d(n).devices.shape,
                        names=("x", "y"))
    tpar.make_mesh_2d(n, axis_x="r", axis_y="c", device_type="cpu")
    assert made["device_type"] == "cpu" and made["names"] == ("r", "c")
    with pytest.raises(ValueError, match="spans every rank"):
        tpar.make_mesh_2d(n + 1)


def test_dcn_axis_for():
    for m, n in [(4096, 1024), (1024, 4096), (2048, 2048), (1, 2), (3, 1)]:
        for names in (("x", "y"), ("rows", "cols")):
            assert tlaunch.dcn_axis_for(m, n, 2048, 9, *names) == jlaunch.dcn_axis_for(
                m, n, 2048, 9, *names)


def test_hybrid_grid_puts_hosts_outer_on_the_dcn_axis():
    """8 ranks on 2 hosts (ranks 0-3 and 4-7), as the JAX package's hybrid
    mesh lays out 2 slices of 4 devices: a 2x2 block per host, stacked
    along the dcn axis."""
    host = lambda grid: (grid // 4).numpy()  # noqa: E731
    on_x = tlaunch._hybrid_grid(8, 2, dcn_on_x=True)
    assert tuple(on_x.shape) == (4, 2)
    assert (host(on_x)[:2] == 0).all() and (host(on_x)[2:] == 1).all()
    on_y = tlaunch._hybrid_grid(8, 2, dcn_on_x=False)
    assert tuple(on_y.shape) == (2, 4)
    assert (host(on_y)[:, :2] == 0).all() and (host(on_y)[:, 2:] == 1).all()
    for grid in (on_x, on_y):
        assert sorted(grid.flatten().tolist()) == list(range(8))


def test_hybrid_mesh_on_one_host_is_the_2d_mesh(monkeypatch):
    monkeypatch.setattr(dist, "get_world_size", lambda group=None: 4)
    monkeypatch.delenv("LOCAL_WORLD_SIZE", raising=False)
    monkeypatch.setattr(tpar, "make_mesh_2d", lambda **kw: ("2d", kw))
    assert tlaunch.make_mesh_2d_hybrid() == ("2d", dict(axis_x="x", axis_y="y",
                                                        device_type="cuda"))


def test_bytes_per_output_element_is_shared():
    """One named term, 28 B, in the one-device working set and in every
    distributed model: the triple, its exponent, an int32 total and the
    f64 result, the JAX package's (8 + 16 + 4)."""
    E = schedule.BYTES_PER_OUTPUT_ELEMENT
    assert E == 12 + 4 + 4 + 8 == 28
    m, n = 48, 80
    assert tpar.summa_device_bytes(m, n, 0, 9, 1, 1) == E * m * n
    assert tpar.ring_device_bytes(m, n, 0, 9, 1) == E * m * n
    assert tpar.stream_device_bytes(m, n, 0, 9, 1, 1) == E * m * n
    assert schedule.working_set_bytes_chunked(m, n, 0, 9, 1) == (8 + E) * m * n
    assert schedule.EPILOGUE_BLOCK_BYTES == 4 << 30


def test_epilogue_block_takes_what_the_budget_leaves(monkeypatch):
    """The epilogue's row blocks may hold what the budget leaves beside
    what the device holds now, and never less than EPILOGUE_BLOCK_BYTES."""
    floor = schedule.EPILOGUE_BLOCK_BYTES
    monkeypatch.setattr(torch.cuda, "memory_allocated", lambda device=None: 3 << 30)
    monkeypatch.setenv("OZIMMU_HBM_BUDGET_MB", str(40 << 10))
    assert schedule.epilogue_block_bytes("cuda") == (40 << 30) - (3 << 30)
    assert schedule.epilogue_block_bytes("cpu") == 40 << 30
    monkeypatch.setenv("OZIMMU_HBM_BUDGET_MB", str(6 << 10))
    assert schedule.epilogue_block_bytes("cuda") == floor
    assert schedule.epilogue_block_bytes(torch.device("cpu")) == 6 << 30


def test_device_bytes_equal_the_jax_models():
    rng = np.random.default_rng(1)
    for _ in range(300):
        m, n, k = (int(v) for v in rng.integers(1, 70000, 3))
        ns = int(rng.integers(3, 19))
        xs, ys = MESHES[int(rng.integers(len(MESHES)))]
        for cx in (False, True):
            assert tpar.summa_device_bytes(m, n, k, ns, xs, ys, cx) == jpar.summa_device_bytes(
                m, n, k, ns, xs, ys, cx)
            assert tpar.ring_device_bytes(m, n, k, ns, xs, cx) == jpar.ring_device_bytes(
                m, n, k, ns, xs, cx)
            assert tpar.stream_device_bytes(m, n, k, ns, xs, ys, cx) == jpar.stream_device_bytes(
                m, n, k, ns, xs, ys, cx)


def _choice(select, *args, **kw):
    try:
        return select(*args, **kw)
    except ValueError as e:
        assert "no distributed variant fits" in str(e)
        return "raise"


@pytest.mark.parametrize("xs,ys", MESHES)
def test_select_variant_equals_jax(xs, ys):
    rng = np.random.default_rng(xs * 10 + ys)
    seen = set()
    cases = [(64, 64, 65536, 9, False, 60 << 30), (64, 64, 65536, 9, True, 60 << 30),
             (4096, 4096, 1 << 20, 9, False, 1 << 20), (256, 256, 256, 9, False, 1 << 30)]
    for _ in range(200):
        cases.append((int(rng.integers(1, 9)) * 4096, int(rng.integers(1, 9)) * 4096,
                      int(rng.integers(1, 17)) * 4096, int(rng.integers(3, 19)),
                      bool(rng.integers(0, 2)), int(rng.integers(1, 64)) << 27))
    for m, n, k, ns, cx, budget in cases:
        got = _choice(tpar.select_variant, m, n, k, ns, _Mesh(xs, ys), complex_=cx,
                      hbm_bytes=budget)
        assert got == _choice(jpar.select_variant, m, n, k, ns, _JaxMesh(xs, ys), complex_=cx,
                              hbm_bytes=budget), (m, n, k, ns, cx, budget)
        seen.add(got)
    assert {"summa", "raise"} <= seen


def test_select_variant_takes_ring_then_stream():
    """Over summa's budget a square mesh (q >= 3: at q = 2 the ring's two
    half-k panels equal summa's slab) takes the ring; a rectangular one
    the stream."""
    budget = tpar.ring_device_bytes(4096, 4096, 4096, 9, 3)
    assert tpar.summa_device_bytes(4096, 4096, 4096, 9, 3, 3) > budget
    assert tpar.select_variant(4096, 4096, 4096, 9, _Mesh(3, 3), hbm_bytes=budget) == "ring"
    budget = tpar.stream_device_bytes(4096, 4096, 4096, 9, 2, 4)
    assert tpar.summa_device_bytes(4096, 4096, 4096, 9, 2, 4) > budget
    assert tpar.select_variant(4096, 4096, 4096, 9, _Mesh(2, 4), hbm_bytes=budget) == "stream"


@pytest.mark.parametrize("cx", [False, True])
def test_auto_wrapper_counts_the_result_it_assembles_on_the_device(monkeypatch, cx):
    """``sharded_gemm_auto`` chooses its variant with the device's budget
    less the global result where that lands on the mesh's device (tensor
    operands: 8 B per element, 16 complex); numpy operands get a result
    assembled in host memory, so the budget is the device's own."""
    seen = []

    def record(*args):
        seen.append(args[-1])
        raise RuntimeError("chosen")

    monkeypatch.setattr(tpar, "select_variant", record)
    monkeypatch.setenv("OZIMMU_HBM_BUDGET_MB", "1000")
    m, k, n = 48, 32, 80
    rng = np.random.default_rng(5)
    a, b = rng.standard_normal((m, k)), rng.standard_normal((k, n))
    if cx:
        a, b = a + 1j * rng.standard_normal((m, k)), b + 1j * rng.standard_normal((k, n))
    for ops in ((a, b), (torch.from_numpy(a), torch.from_numpy(b))):
        with pytest.raises(RuntimeError, match="chosen"):
            tpar.sharded_gemm_auto(*ops, 9, _Mesh(2, 2))
    assert tpar._result_device_bytes(m, n, cx) == (16 if cx else 8) * m * n
    assert seen == [1000 << 20, (1000 << 20) - (16 if cx else 8) * m * n]


def test_presharded_chooser_rechecks_the_budget():
    """Where the chooser says "k", the JAX package's pre-sharded entries
    run "summa" without checking its budget (parallel/gemm.py:1143-1144,
    1199-1200).  The port takes the first 2-D variant that fits, or
    raises; it never returns a plan over the budget."""
    m, k, n = 256, 4096, 256
    mesh, jmesh = _Mesh(1, 4), _JaxMesh(1, 4)
    budget = 15 << 20
    assert jpar.select_variant(m, n, k, 9, jmesh, hbm_bytes=budget) == "k"
    assert jpar.summa_device_bytes(m, n, k, 9, 1, 4) > budget
    assert tpar._presharded_variant(m, n, k, 9, mesh, "x", "y", False, budget) == "stream"
    budget = 10 << 20  # "k" still fits, no 2-D variant does
    assert jpar.select_variant(m, n, k, 9, jmesh, hbm_bytes=budget) == "k"
    with pytest.raises(ValueError, match="no 2-D distributed variant fits"):
        tpar._presharded_variant(m, n, k, 9, mesh, "x", "y", False, budget)
    rng = np.random.default_rng(3)
    rechecked = 0
    for _ in range(400):
        m, n = (int(v) * 256 for v in rng.integers(1, 9, 2))
        k = int(rng.integers(1, 65)) * 1024
        ns, cx = int(rng.integers(3, 19)), bool(rng.integers(0, 2))
        xs, ys = MESHES[int(rng.integers(len(MESHES)))]
        budget = int(rng.integers(1, 512)) << 20
        args = (m, n, k, ns)
        try:
            v = tpar._presharded_variant(*args, _Mesh(xs, ys), "x", "y", cx, budget)
        except ValueError:
            v = "raise"
        models = {"summa": tpar.summa_device_bytes(*args, xs, ys, cx),
                  "ring": tpar.ring_device_bytes(*args, xs, cx),
                  "stream": tpar.stream_device_bytes(*args, xs, ys, cx)}
        assert v == "raise" or models[v] <= budget
        if _choice(jpar.select_variant, *args, _JaxMesh(xs, ys), complex_=cx,
                   hbm_bytes=budget) == "k":
            rechecked += models["summa"] > budget
    assert rechecked > 0


@pytest.fixture
def captured(monkeypatch):
    calls = []
    monkeypatch.setattr(dist, "init_process_group", lambda *a, **kw: calls.append((a, kw)))
    for name in ("OZIMMU_COORDINATOR", "OZIMMU_NUM_PROCS", "OZIMMU_PROC_ID", "MASTER_ADDR",
                 "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(name, raising=False)
    return calls


def _expect(calls, backend, coord, world, rank):
    assert calls[-1] == ((backend,), dict(init_method=f"tcp://{coord}", world_size=world,
                                          rank=rank))


def test_initialize_from_ozimmu_env(monkeypatch, captured):
    monkeypatch.setenv("OZIMMU_COORDINATOR", "10.0.0.1:1234")
    monkeypatch.setenv("OZIMMU_NUM_PROCS", "4")
    monkeypatch.setenv("OZIMMU_PROC_ID", "2")
    tlaunch.initialize(device="cpu")
    _expect(captured, "gloo", "10.0.0.1:1234", 4, 2)
    tlaunch.initialize("host:9", 8, 5, device="cpu")  # arguments win
    _expect(captured, "gloo", "host:9", 8, 5)


def test_initialize_from_torchrun_env(monkeypatch, captured):
    set_to = []
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "set_device", set_to.append)
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("MASTER_PORT", "29555")
    monkeypatch.setenv("WORLD_SIZE", "4")
    monkeypatch.setenv("RANK", "3")
    tlaunch.initialize()  # CUDA by default: NCCL, card = rank % cards
    _expect(captured, "nccl", "127.0.0.1:29555", 4, 3)
    assert set_to == [0]
    monkeypatch.setenv("LOCAL_RANK", "1")
    tlaunch.initialize(backend="gloo")  # several ranks sharing cards: an explicit choice
    _expect(captured, "gloo", "127.0.0.1:29555", 4, 3)
    assert set_to == [0, 1]


def test_initialize_without_a_coordinator_raises(captured):
    with pytest.raises(ValueError, match="coordinator address"):
        tlaunch.initialize(num_processes=2, process_id=0, device="cpu")
    assert captured == []
