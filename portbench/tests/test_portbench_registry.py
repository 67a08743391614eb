"""The harness finds cells and metrics by name; the run path needs a
card; the trace reader."""

import json
import os
import subprocess
import sys
from pathlib import Path

from portbench import harness, registry, trace

REPO = Path(__file__).resolve().parents[2]


def test_an_added_cell_and_metric_are_found_by_name(tiny_root):
    before = {p: p.read_bytes() for p in tiny_root.rglob("*")
              if p.is_file()}
    # a later change adds files only: a traffic file, a cell file, a metric
    # module and its entry in BENCHMARK.json
    tr = json.loads((tiny_root / "traffic" / "k8.json").read_text())
    (tiny_root / "traffic" / "k4.json").write_text(
        json.dumps(dict(tr, fuse_iters=4)))
    cell = json.loads((tiny_root / "workloads"
                       / "combustor_tiny_k1.json").read_text())
    (tiny_root / "workloads" / "combustor_tiny_k4.json").write_text(
        json.dumps(dict(cell, traffic="k4")))
    (tiny_root / "metrics" / "cycles_per_s.py").write_text(
        "def read(record):\n"
        "    return record['iters'] / 20 / record['window_s']\n")
    bench = tiny_root.parent / "BENCHMARK.json"
    b = json.loads(bench.read_text())
    b["end_to_end"].append({"name": "cycles_per_s", "unit": "1/s",
                            "better": "higher", "bound": 0.05,
                            "source": "host_clock"})
    bench.write_text(json.dumps(b))
    c = registry.cell("combustor_tiny_k4", tiny_root)
    assert c["traffic"]["fuse_iters"] == 4
    assert c["config"]["name"] == "combustor_tiny"
    assert "cycles_per_s" in registry.metrics_of("end_to_end", tiny_root)
    r = harness.run("combustor_tiny_k4", 3, 0.2, False, device="cpu",
                    root=tiny_root)
    assert r["correct"], r["checks"]
    assert set(r["metrics"]) == {"gcups", "setup_s", "cycles_per_s"}
    assert list(r)[-1] == "checks"
    for p, data in before.items():
        assert p.read_bytes() == data, p


def test_a_reader_with_nothing_to_read_leaves_its_metric_out(tiny_root):
    (tiny_root / "metrics" / "never.py").write_text(
        "def read(record):\n    return None\n")
    bench = tiny_root.parent / "BENCHMARK.json"
    b = json.loads(bench.read_text())
    b["end_to_end"].append({"name": "never", "unit": "s", "better": "lower",
                            "bound": 0.05, "source": "host_clock"})
    bench.write_text(json.dumps(b))
    r = harness.run("combustor_tiny_k1", 3, 0.2, False, device="cpu",
                    root=tiny_root)
    assert set(r["metrics"]) == {"gcups", "setup_s"}


def test_every_benchmark_entry_has_its_files():
    b = registry.benchmark()
    for w in b["workloads"]:
        c = registry.cell(w["name"])
        assert (c["config"]["name"], c["traffic"]["name"], c["chips"]) == \
            (w["config"], w["traffic"], w["chips"])
        assert c["why"] == w["why"]
    for kind in ("end_to_end", "per_layer"):
        for m in b[kind]:
            assert (registry.ROOT / "metrics" / f"{m['name']}.py").exists()
    for cfg in b["configs"]:
        assert (REPO / cfg["file"]).exists()


def test_the_run_path_needs_a_card():
    out = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload",
         "combustor_k8", "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=REPO, capture_output=True, text=True, timeout=120,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA" in out.stderr


def test_trace_reader():
    def ev(name, cat, ts, dur):
        return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}
    t = {"traceEvents": [
        ev(trace.SLICE, "user_annotation", 100.0, 100.0),
        ev("aten::copy_", "cpu_op", 150.0, 20.0),
        ev("void gfc_kernel<0>(Consts, float const*)", "kernel", 90.0, 30.0),
        ev("step_spec_kernel", "kernel", 120.0, 25.0),
        ev("void at::native::reduce_kernel<512, 1>", "kernel", 175.0, 2.0),
        ev("void at_cuda_detail::cub::DeviceReduceKernel<int>", "kernel",
           177.0, 3.0),
        ev("Memcpy DtoH (Device -> Pageable)", "gpu_memcpy", 185.0, 10.0)]}
    pats = trace.torch_patterns(registry.ROOT)
    r = trace.read(t, pats)
    assert abs(r["window_s"] - 100e-6) < 1e-12
    # busy: 100-145, 175-180, 185-195 (the first kernel clipped at 100)
    assert abs(r["busy_s"] - 60e-6) < 1e-12
    assert abs(r["port_s"] - 45e-6) < 1e-12
    assert abs(r["other_s"] - 15e-6) < 1e-12
    assert r["port_names"] == ["step_spec_kernel",
                               "void gfc_kernel<0>(Consts, float const*)"]
    assert r["device_ops"][0][0] == "step_spec_kernel"
    gap, secs = r["idle_gaps"][0]
    assert (gap, round(secs * 1e6, 6)) == ("aten::copy_", 30.0)
