"""The port's spans (``openhyperflow2d_torch.spans``) on the CPU.

* Off (the default), ``span`` hands back one shared null context and a
  solver's cycle records nothing.
* On, one ``run_cycle`` of the kernel path (its plain versions on CPU
  tensors) at K = 1, 2, 4 records the tree ``solver.cycle`` >
  ``solver.chunk`` > ``chunk.prologue``, one ``chunk.scan_dt`` /
  ``chunk.block`` / ``chunk.combine`` a block of ``fuse_blocks``, then
  ``chunk.epilogue``; ``solver.fetch`` and ``solver.y_plus`` (the
  combustor is an NS deck with walls); every span carries the cycle's id.
* ``build_case`` records ``case.wall_distance``, ``Solver`` records
  ``solver.init``, the first ``load_kernels`` of a process records
  ``kernels.load`` (whether nvcc built the library or it was loaded).
* The state after a cycle is the same, bit for bit, with spans on and off.
* The ring keeps the newest ``CAPACITY`` spans and counts the dropped.
* Under a CPU ``torch.profiler`` each span is one ``user_annotation`` of
  the trace, inside the span's own interval and nested as the spans are.
"""

import json

import pytest
import torch

from openhyperflow2d_torch import spans
from openhyperflow2d_torch.examples import combustor_deck
from openhyperflow2d_torch.ops import build
from openhyperflow2d_torch.ops.fused_step import fuse_blocks
from openhyperflow2d_torch.solver.init import build_case
from openhyperflow2d_torch.solver.runner import Solver

NSTEP = 6
CHUNK = ("chunk.scan_dt", "chunk.block", "chunk.combine")


@pytest.fixture(autouse=True)
def spans_off():
    spans.disable()
    spans.reset()
    yield
    spans.disable()
    spans.reset()


def small_case():
    d = combustor_deck(32, 64)
    d.data.update(Nmax=str(NSTEP), NOutStep=str(NSTEP - 1))
    case = build_case(d, dtype="float32")
    assert case.Nstep == NSTEP and len(case.wall_nodes)
    return case


def solver(K=2, case=None):
    return Solver(case or small_case(), device="cpu", use_kernels=True,
                  fuse_iters=K)


def children(recs, parent):
    return sorted((r for r in recs if r["parent"] == parent["id"]),
                  key=lambda r: r["start_ns"])


def test_off_records_nothing():
    assert not spans.enabled()
    assert spans.span("a") is spans.span("b", block=1) is spans.NULL
    s = solver()
    s.run_cycle()
    assert spans.records() == [] and spans.dropped() == 0


@pytest.mark.parametrize("K", [1, 2, 4])
def test_cycle_tree(K):
    s = solver(K)
    spans.enable()
    for cycle in (0, NSTEP):
        spans.reset()
        s.run_cycle()
        recs = spans.records()
        (top,) = [r for r in recs if r["parent"] is None]
        assert top["name"] == "solver.cycle"
        assert top["attrs"] == {"iters": NSTEP}
        assert {r["cycle"] for r in recs} == {cycle}
        assert [r["name"] for r in children(recs, top)] == [
            "solver.chunk", "solver.fetch", "solver.y_plus"]
        chunk = children(recs, top)[0]
        blocks = fuse_blocks(NSTEP, K)
        got = children(recs, chunk)
        assert [r["name"] for r in got] == (["chunk.prologue"]
                                            + list(CHUNK) * len(blocks)
                                            + ["chunk.epilogue"])
        for j, (_, kk) in enumerate(blocks):
            scan, block, comb = got[1 + 3 * j: 4 + 3 * j]
            assert scan["attrs"] == comb["attrs"] == {"block": j}
            assert block["attrs"] == {"block": j, "iters": kk}
        for r in recs:
            assert r["start_ns"] <= r["end_ns"] and not r["traced"]
            if r["parent"] is not None:
                (up,) = [u for u in recs if u["id"] == r["parent"]]
                assert up["start_ns"] <= r["start_ns"] <= r["end_ns"] \
                    <= up["end_ns"]


def test_build_case_records_wall_distance():
    spans.enable()
    case = small_case()
    (wall,) = spans.records()
    assert wall["name"] == "case.wall_distance"
    assert wall["parent"] is None and wall["cycle"] is None
    assert wall["attrs"] == {"wall_nodes": len(case.wall_nodes)}


def test_solver_records_init():
    case = small_case()
    spans.enable()
    solver(case=case)
    (rec,) = spans.records()
    assert rec["name"] == "solver.init" and rec["cycle"] is None


@pytest.mark.parametrize("secs", [0.0, 2.5])
def test_first_load_kernels_records_the_build(monkeypatch, secs):
    lib = build.KernelLib(None, None, secs, "")
    monkeypatch.setattr(build, "_LOADED", None)
    monkeypatch.setattr(build, "load_library", lambda: lib)
    spans.enable()
    assert build.load_kernels() is lib
    assert build.load_kernels() is lib
    (rec,) = spans.records()
    assert rec["name"] == "kernels.load"
    assert rec["attrs"] == {} and rec["cycle"] is None


def test_state_is_the_same_with_spans_on():
    case = small_case()
    off, on = solver(case=case), solver(case=case)
    d_off, _ = off.run_cycle()
    spans.enable()
    d_on, _ = on.run_cycle()
    assert spans.records()
    for f, v in off.state.__dict__.items():
        assert torch.equal(v, getattr(on.state, f)), f
    for k, v in d_off.items():
        assert (v == d_on[k]).all(), k


def test_ring_drops_the_oldest():
    spans.enable()
    extra = 5
    for i in range(spans.CAPACITY + extra):
        with spans.span("s", i=i):
            pass
    recs = spans.records()
    assert len(recs) == spans.CAPACITY
    assert spans.dropped() == extra
    assert recs[0]["attrs"] == {"i": extra}
    assert recs[-1]["attrs"] == {"i": spans.CAPACITY + extra - 1}
    spans.reset()
    assert spans.records() == [] and spans.dropped() == 0


def test_spans_are_profiler_annotations_on_its_clock(tmp_path):
    s = solver()
    spans.enable()
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        s.run_cycle()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    trace = json.loads(path.read_text())
    recs = sorted(spans.records(), key=lambda r: r["start_ns"])
    assert recs and all(r["traced"] for r in recs)
    names = {r["name"] for r in recs}
    marks = sorted((float(e["ts"]), -float(e["dur"]), e["name"])
                   for e in trace["traceEvents"]
                   if e.get("cat") == "user_annotation"
                   and e.get("name") in names)
    assert [m[2] for m in marks] == [r["name"] for r in recs]
    at = {r["id"]: (ts, ts - dur) for r, (ts, dur, _) in zip(recs, marks)}
    for r in recs:
        start, end = at[r["id"]]
        # the annotation opens after the span's start and closes before
        # its end (a microsecond for the two clocks' rounding)
        assert end - start <= (r["end_ns"] - r["start_ns"]) / 1e3 + 1.0
        if r["parent"] is not None:
            up_start, up_end = at[r["parent"]]
            assert up_start <= start <= end <= up_end, r["name"]
