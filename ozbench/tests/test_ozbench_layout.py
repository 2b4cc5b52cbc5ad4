"""The benchmark is driven by data: a cell's configuration, traffic, driver,
kind of operand, limits and metrics are files found by the names in
BENCHMARK.json, so a new one is added as new files alone.  And
BENCHMARK.json keeps to the benchmark's contract."""

import hashlib
import json
import os
import re
import types

import pytest

from conftest import BENCH_DIR, ROOT, copy_benchmark, run_small

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _digests(top):
    out = {}
    for d, _, files in os.walk(top):
        for f in files:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, top)] = hashlib.sha256(fh.read()).hexdigest()
    return out


def _write(path, obj):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        if isinstance(obj, str):
            f.write(obj)
        else:
            json.dump(obj, f)


SIGNED_UNIT = '''"""float64 uniform in [-1, 1)."""

import torch


def make(shape, g, device):
    return torch.rand(shape, dtype=torch.float64, generator=g, device=device).mul_(2).sub_(1)
'''

TWICE = '''"""The gemm driver, each unit issuing its product twice."""

import os

from harness import spec

gemm = spec.load("drivers", "gemm", os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


class Driver(gemm.Driver):
    def unit(self, i):
        super().unit(i)
        return super().unit(i)

    def work(self):
        return 2 * super().work()
'''


def test_a_new_cell_driver_operand_kind_and_metrics_are_new_files_only(tmp_path):
    root = copy_benchmark(str(tmp_path))
    ozb = os.path.join(root, "ozbench")
    before = _digests(ozb)
    _write(os.path.join(ozb, "configs", "tiny-dgemm-ns6.json"),
           {"mode": "fp64_int8_6", "operands": "signed_unit", "reference": "gemm",
            "limits": {"entry_err": 1e-9, "rowsum_err": 1e-9}, "reduced": []})
    _write(os.path.join(ozb, "operands", "signed_unit.py"), SIGNED_UNIT)
    _write(os.path.join(ozb, "drivers", "twice.py"), TWICE)
    _write(os.path.join(ozb, "traffic", "tiny-square.json"),
           {"driver": "twice", "m": 48, "n": 40, "k": 56, "inflight": 2, "soak_s": 0.05,
            "trace_units": 3, "sample_entries": 64})
    _write(os.path.join(ozb, "limits", "tiny-cell.json"), {"rowsum_err": 2e-9})
    _write(os.path.join(ozb, "end_to_end", "calls_per_s.py"),
           '"""Calls a second."""\n\n\ndef read(ctx):\n'
           '    return 2 * ctx.window.units / ctx.window.seconds\n')
    _write(os.path.join(ozb, "metrics", "units_traced.py"),
           '"""Units in the traced window."""\n\n\ndef read(ctx):\n    return ctx.units\n')
    bench = json.load(open(os.path.join(root, "BENCHMARK.json")))
    bench["configs"].append({"name": "tiny-dgemm-ns6", "source": "https://example.org/tiny",
                             "file": "ozbench/configs/tiny-dgemm-ns6.json", "reduced": [],
                             "why": "a test's configuration"})
    bench["workloads"].append({"name": "tiny-cell", "config": "tiny-dgemm-ns6",
                               "traffic": "tiny-square", "chips": 1, "why": "a test's cell"})
    bench["end_to_end"].append({"name": "calls_per_s.tiny", "unit": "1/s", "better": "higher",
                                "bound": 0.05, "source": "host_clock", "workloads": ["tiny-cell"]})
    bench["per_layer"].append({"name": "units_traced.tiny", "unit": "units", "better": "higher",
                               "source": "program_counter", "layer": "harness",
                               "moves": "calls_per_s.tiny", "workloads": ["tiny-cell"]})
    _write(os.path.join(root, "BENCHMARK.json"), bench)

    r = run_small(root, "tiny-cell")
    assert r["correct"] and set(r["metrics"]) == {"calls_per_s.tiny", "setup_s"}
    assert r["metrics"]["calls_per_s.tiny"]["value"] > 0
    r = run_small(root, "tiny-cell", trace=True)
    assert r["correct"] and r["metrics"] == {"units_traced.tiny": {"value": 3.0, "unit": "units"}}
    assert r["checks"]["entry_err"]["limit"] == 1e-9 and r["checks"]["rowsum_err"]["limit"] == 2e-9
    after = _digests(ozb)
    assert {k: v for k, v in after.items() if k in before} == before
    assert set(after) - set(before) == {
        "configs/tiny-dgemm-ns6.json", "operands/signed_unit.py", "drivers/twice.py",
        "traffic/tiny-square.json", "limits/tiny-cell.json", "end_to_end/calls_per_s.py",
        "metrics/units_traced.py"}


def test_the_new_operand_kind_and_driver_are_the_ones_run(tmp_path):
    """The files added above are what the run uses: the operands are signed
    and each unit issues two products."""
    import torch

    import ozimmu_tpu_torch as ozt
    from harness import driver, spec

    root = copy_benchmark(str(tmp_path))
    ozb = os.path.join(root, "ozbench")
    _write(os.path.join(ozb, "operands", "signed_unit.py"), SIGNED_UNIT)
    _write(os.path.join(ozb, "drivers", "twice.py"), TWICE)
    calls = []

    def gemm(a, b, **kw):
        calls.append(1)
        return ozt.gemm(a, b, **kw)

    prog = types.SimpleNamespace(gemm=gemm)
    cfg = {"mode": "fp64_int8_6", "operands": "signed_unit", "reference": "gemm"}
    tr = {"driver": "twice", "m": 16, "n": 8, "k": 24, "sample_entries": 8}
    drv = driver.make(cfg, tr, 5, torch.device("cpu"), prog, ozb)
    drv.prepare()
    assert len(calls) == 2 and drv.a.min() < 0
    assert drv.work() == 2 * 2 * 16 * 8 * 24
    assert spec.path_of("drivers", "twice", ozb).endswith("drivers/twice.py")


def test_a_metric_name_falls_back_to_its_part_before_the_dot():
    from harness import spec

    assert spec.path_of("metrics", "device_idle_share.hpl").endswith("metrics/device_idle_share.py")
    assert spec.path_of("end_to_end", "gemm_tflops.batched").endswith("end_to_end/gemm_tflops.py")
    with pytest.raises(FileNotFoundError):
        spec.path_of("metrics", "no_such_metric.gemm")


BENCH = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))


def test_benchmark_json_has_the_contracts_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["ozbench"] and BENCH["command"] == ["python3", "ozbench/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in BENCH[k]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("ozbench/") and os.path.exists(os.path.join(ROOT, c["file"]))
        assert 1 <= len(c["why"]) <= 200 and 1 <= len(c["source"]) <= 200
        cfg = json.load(open(os.path.join(ROOT, c["file"])))
        assert cfg["reduced"] == c["reduced"]
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and 1 <= len(w["why"]) <= 200
        assert NAME.match(w["traffic"]) and NAME.match(w["config"])
        assert os.path.exists(os.path.join(BENCH_DIR, "traffic", f"{w['traffic']}.json"))
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    from harness import spec

    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
        if m["name"] != "setup_s":
            assert os.path.exists(spec.path_of("end_to_end", m["name"]))
    for m in BENCH["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert os.path.exists(spec.path_of("metrics", m["name"]))


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_reports_setup_another_end_to_end_and_a_per_layer_metric(cell):
    from harness import spec

    c = spec.find_cell(cell)
    e2e = [m["name"] for m in c.end_to_end]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert c.per_layer and all(m["moves"] in e2e for m in c.per_layer)
    assert set(c.limits) and all(v > 0 for v in c.limits.values())
