"""ozimmu_tpu_torch.schedule against ozimmu_tpu.schedule: every schedule
function, ns 3..18, over a sweep of contraction lengths."""

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from ozimmu_tpu import schedule as ref  # noqa: E402
from ozimmu_tpu.ops.recombine import acc_shift as ref_acc_shift  # noqa: E402
from ozimmu_tpu_torch import schedule as port  # noqa: E402
from ozimmu_tpu_torch.ops.recombine import acc_shift  # noqa: E402

NS = list(range(3, 19))
KS = [1, 2, 3, 7, 8, 9, 65, 127, 128, 640, 777, 1024, 4096, 8192, 16384, 65536, 2**20, 2**22]


def _groups(gs):
    return [(g.t, g.pairs) for g in gs]


def test_bits_per_int8():
    for k in list(range(0, 3000)) + KS + [2**24, 2**30, 2**31]:
        assert port.bits_per_int8(k) == ref.bits_per_int8(k), k


@pytest.mark.parametrize("ns", NS)
def test_pair_and_group_schedule(ns):
    assert port.pair_schedule(ns) == ref.pair_schedule(ns)
    for k in KS:
        assert _groups(port.group_schedule(ns, k)) == _groups(ref.group_schedule(ns, k))
        for b in (5, 7):
            assert _groups(port.group_schedule(ns, k, b)) == _groups(ref.group_schedule(ns, k, b))
            g = port.group_schedule(ns, k, b)[0]
            assert g.weight_log2(b) == ref.group_schedule(ns, k, b)[0].weight_log2(b)
        assert acc_shift(ns, port.bits_per_int8(k)) == ref_acc_shift(ns, ref.bits_per_int8(k))


def test_max_safe_pairs_per_group():
    for k in [0] + KS:
        for b in range(0, 8):
            assert port.max_safe_pairs_per_group(k, b) == ref.max_safe_pairs_per_group(k, b)


@pytest.mark.parametrize("ns", [3, 9, 18])
def test_flops_and_working_sets(ns):
    for m, n, k in [(1, 1, 1), (33, 65, 47), (8192, 8192, 8192), (16384, 16384, 16384)]:
        for cx in (False, True):
            assert port.schedule_flops(ns, m, n, k, cx) == ref.schedule_flops(ns, m, n, k, cx)
            assert port.effective_flops(m, n, k, cx) == ref.effective_flops(m, n, k, cx)
            assert port.working_set_bytes(m, n, k, ns, cx) == ref.working_set_bytes(m, n, k, ns, cx)
            for c in (1, 2, 3, 8, 64):
                assert port.working_set_bytes_chunked(m, n, k, ns, c, cx) == (
                    ref.working_set_bytes_chunked(m, n, k, ns, c, cx)
                )


@pytest.mark.parametrize("budget_mb", ["64", "1024", "10240", "90000"])
def test_auto_n_chunks_under_an_explicit_budget(monkeypatch, budget_mb):
    monkeypatch.setenv("OZIMMU_HBM_BUDGET_MB", budget_mb)
    assert port.hbm_budget_bytes("cpu") == ref.hbm_budget_bytes()
    for m, n, k in [(33, 65, 47), (4096, 4096, 4096), (16384, 16384, 16384), (8192, 3, 8192)]:
        for ns in (3, 9, 18):
            assert port.auto_n_chunks(m, n, k, ns, device="cpu") == ref.auto_n_chunks(m, n, k, ns)


@pytest.mark.parametrize("complex_", [False, True])
def test_auto_n_chunks_reports_its_cap(monkeypatch, capsys, complex_):
    """At the min(n, 64) cap with the working set still over the budget,
    the same count comes back and the error log names the sizes."""
    monkeypatch.setenv("OZIMMU_HBM_BUDGET_MB", "1")
    monkeypatch.delenv("OZIMMU_ERROR", raising=False)
    m, n, k, ns = 4096, 300, 4096, 9
    got = port.auto_n_chunks(m, n, k, ns, complex_=complex_, device="cpu")
    assert got == ref.auto_n_chunks(m, n, k, ns, complex_=complex_) == 64
    need = port.working_set_bytes_chunked(m, n, k, ns, 64, complex_)
    out = capsys.readouterr().out
    assert "[ozIMMU ERROR] auto_n_chunks" in out
    for part in (f"m={m}", f"n={n}", f"k={k}", f"ns={ns}", f"{need} B", f"budget {1 << 20} B"):
        assert part in out, (part, out)
    # under the budget, or off the cap, nothing is reported
    assert port.auto_n_chunks(33, 65, 47, ns, complex_=complex_, device="cpu") == 1
    monkeypatch.setenv("OZIMMU_HBM_BUDGET_MB", "90000")
    assert port.auto_n_chunks(m, n, k, ns, complex_=complex_, device="cpu") == 1
    assert capsys.readouterr().out == ""


def test_default_budget_reads_the_device(monkeypatch):
    import os

    monkeypatch.delenv("OZIMMU_HBM_BUDGET_MB", raising=False)
    host = os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")
    budget = port.hbm_budget_bytes("cpu")
    assert 0 < budget < host
    assert port.auto_n_chunks(64, 64, 64, 9, device="cpu") == 1
