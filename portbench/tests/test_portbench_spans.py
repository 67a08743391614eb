"""The span metrics (``portbench/spans.py``): the attribution of a slice by
the program's spans on a synthetic trace with known gaps and correlations,
the five readers on records of known spans, and one run on the CPU."""

import pytest

from portbench import harness, registry, spans, trace


def ev(name, cat, ts, dur, corr=None):
    e = {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


# the program's spans as the profiler's annotations: two cycles, the
# second clipped by the slice's end
SPANS = [("solver.cycle", 1000.0, 900.0), ("solver.chunk", 1000.0, 500.0),
         ("chunk.block", 1100.0, 300.0), ("solver.fetch", 1500.0, 350.0),
         ("solver.cycle", 1920.0, 180.0), ("solver.chunk", 1930.0, 170.0)]
NAMES = {n for n, _, _ in SPANS}


def synthetic_trace():
    """The slice 1000-2000 µs.  Device: the port's step_spec_kernel
    1050-1350 (launched in chunk.block), a reduction 1400-1450 (in
    solver.chunk), a copy 1600-1700 (in solver.fetch), a cub kernel
    1960-1980 (launched in the second solver.cycle, before its chunk), a
    port kernel 1990-2020 with no launch in the trace (clipped at 2000).
    Idle: 1000-1050, 1450-1500, 1930-1960 and 1980-1990 in solver.chunk,
    1350-1400 in chunk.block, 1500-1600 and 1700-1850 in solver.fetch,
    1850-1900 and 1920-1930 in solver.cycle, 1900-1920 outside.  The host
    runs aten::copy_ over 1500-1600; an annotation that is no program span
    covers everything."""
    evs = [ev(trace.SLICE, "user_annotation", 1000.0, 1000.0),
           ev("other.mark", "user_annotation", 900.0, 2000.0),
           ev("step_spec_kernel", "kernel", 1050.0, 300.0, 1),
           ev("cudaLaunchKernel", "cuda_runtime", 1150.0, 5.0, 1),
           ev("void at::native::reduce_kernel<512, 1>", "kernel", 1400.0,
              50.0, 2),
           ev("cudaLaunchKernel", "cuda_runtime", 1450.0, 5.0, 2),
           ev("Memcpy DtoH (Device -> Pageable)", "gpu_memcpy", 1600.0,
              100.0, 3),
           ev("cudaMemcpyAsync", "cuda_runtime", 1550.0, 150.0, 3),
           ev("void at_cuda_detail::cub::DeviceReduceKernel<int>", "kernel",
              1960.0, 20.0, 4),
           ev("cuLaunchKernel", "cuda_driver", 1925.0, 5.0, 4),
           ev("void gfc_kernel<0>(Consts, float const*)", "kernel", 1990.0,
              30.0, 5),
           ev("aten::copy_", "cpu_op", 1500.0, 100.0)]
    evs += [ev(n, "user_annotation", ts, dur) for n, ts, dur in SPANS]
    return {"baseTimeNanoseconds": 10 ** 18, "traceEvents": evs}


def close(got: dict, want: dict):
    assert set(got) == set(want), (got, want)
    for k, v in want.items():
        assert got[k] == pytest.approx(v * 1e-6, abs=1e-12), k


def test_attribution_by_span():
    pats = trace.torch_patterns(registry.ROOT)
    tr = synthetic_trace()
    by = spans.attribute(tr, NAMES, pats)
    close(by["idle"], {"solver.chunk": 140, "chunk.block": 50,
                       "solver.fetch": 250, "solver.cycle": 60,
                       "outside": 20})
    close(by["glue"], {"solver.chunk": 50, "solver.fetch": 100,
                       "solver.cycle": 20})
    close(by["port"], {"chunk.block": 300, "unmatched": 10})
    assert by["cycles"] == 2
    # from the second cycle's start (1920) on
    close(by["idle_later"], {"solver.cycle": 10, "solver.chunk": 40})
    assert by["later_s"] == pytest.approx(80e-6)
    assert by["window_s"] == pytest.approx(1000e-6)
    # the longest: 1700-1960 (its middle in solver.fetch, under no
    # operation), then 1450-1600 (in solver.fetch, under aten::copy_);
    # the shortest 1980-1990, in the second cycle's chunk
    assert [g[:3] for g in by["gaps"][:2]] == [
        ["solver.fetch", 0, "none"], ["solver.fetch", 0, "aten::copy_"]]
    assert [g[3] for g in by["gaps"][:2]] == pytest.approx([260e-6, 150e-6])
    assert by["gaps"][-1][:2] == ["solver.chunk", 1]
    # together they account for the slice's idle time and device time
    sl = trace.read(tr, pats)
    assert sum(by["idle"].values()) == pytest.approx(
        sl["window_s"] - sl["busy_s"], abs=1e-12)
    assert sum(by["glue"].values()) == pytest.approx(sl["other_s"])
    assert sum(by["port"].values()) == pytest.approx(sl["port_s"])
    ms = spans.per_cycle_ms(by)
    assert list(ms["idle_by_span"])[0] == "solver.fetch"
    assert ms["idle_by_span"]["solver.fetch"] == pytest.approx(0.125)
    assert list(ms["idle_later_by_span"])[0] == "solver.chunk"
    assert ms["idle_later_by_span"]["solver.chunk"] == pytest.approx(0.04)
    # with no program span in the trace, every idle interval is outside
    assert set(spans.attribute(tr, set(), pats)["idle"]) == {"outside"}


def reader(name):
    return registry._module(registry.ROOT / "metrics" / f"{name}.py",
                            f"test_{name}")


def test_readers():
    s = 10 ** 9
    recs = [{"name": "case.wall_distance", "id": 1, "parent": None,
             "start_ns": 0, "end_ns": 2 * s, "traced": False},
            {"name": "solver.init", "id": 3, "parent": None,
             "start_ns": 3 * s, "end_ns": 4 * s + s // 2, "traced": False},
            {"name": "kernels.load", "id": 5, "parent": 4,
             "start_ns": 5 * s, "end_ns": 5 * s + s // 2, "traced": False},
            {"name": "solver.chunk", "id": 4, "parent": None,
             "start_ns": 5 * s, "end_ns": 6 * s, "traced": False,
             "attrs": {"iters": 100}},
            {"name": "solver.chunk", "id": 6, "parent": None,
             "start_ns": 7 * s, "end_ns": 7 * s + 10 ** 6, "traced": True,
             "attrs": {"iters": 100}},
            {"name": "solver.chunk", "id": 7, "parent": None,
             "start_ns": 8 * s, "end_ns": 8 * s + 10 ** 7, "traced": False,
             "attrs": {"iters": 100}},
            {"name": "solver.chunk", "id": 8, "parent": None,
             "start_ns": 9 * s, "end_ns": 9 * s + 12 * 10 ** 6,
             "traced": False, "attrs": {"iters": 100}}]
    record = {"spans": recs, "launches": 300, "iters": 100,
              "trace": {"window_s": 2e-3, "by_span": {
                  "idle_later": {"solver.fetch": 4e-4, "chunk.block": 1e-4,
                                 "outside": 2e-4}, "later_s": 1e-3,
                  "cycles": 2}}}
    assert reader("wall_distance_s").read(record) == pytest.approx(2.0)
    assert reader("solver_init_s").read(record) == pytest.approx(2.0)
    # a load inside solver.init counts once
    inner = dict(recs[2], parent=3)
    assert reader("solver_init_s").read(
        dict(record, spans=recs[:2] + [inner])) == pytest.approx(1.5)
    # the chunks after the last traced span: (10 + 12) ms / 200 iterations
    assert reader("chunk_host_ms_per_iter").read(record) == \
        pytest.approx(0.11)
    assert reader("program_idle_pct").read(record) == pytest.approx(50.0)
    assert reader("launches_per_iter").read(record) == pytest.approx(3.0)
    # with nothing to read, each leaves its metric out
    for name in spans.SPAN_METRICS:
        assert reader(name).read({"iters": 100, "trace": {
            "window_s": 1e-3}}) is None, name
        assert reader(name).read({"spans": [], "launches": None,
                                  "iters": 100}) is None, name


def test_the_traced_run_reads_the_span_metrics_on_the_cpu(tiny_root):
    window, read = harness.window, trace.read
    r = spans.run("combustor_tiny_k8", 2 ** 31 + 7, 0.3, device="cpu",
                  root=tiny_root)
    assert (harness.window, trace.read) == (window, read)
    assert r["correct"], r["checks"]
    assert list(r)[-1] == "checks"
    got = set(r["metrics"])
    assert set(spans.SPAN_METRICS) <= got
    # no kernel launches on CPU tensors: the plain versions run
    assert r["metrics"]["launches_per_iter"]["value"] == 0
    assert r["metrics"]["wall_distance_s"]["value"] < \
        r["metrics"]["build_case_s"]["value"]
    assert r["by_span"]["idle_by_span"]
    host = r["by_span"]["host_by_span"]
    assert list(host)[0] == "solver.cycle"
    assert host["solver.chunk"] <= host["solver.cycle"]
    assert r["gcups_after_slice"] > 0
