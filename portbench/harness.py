"""One run of a cell: set-up, the measured window, the traced slice, the
comparison that decides ``correct``, and the result line.

Set-up: the frozen deck through the port's ``load_deck`` and
``build_case``, the config's ``fast_math``, the seed's perturbation
(``inputs``), ``Solver`` on the kernel path, one warm-up ``run_cycle``.
The window: whole ``Solver.run_cycle`` calls until ``seconds`` have passed;
each ends in the diagnostics' copy to the host, so the host clock at the
last one's end closes the window.  With ``trace``, ``torch.profiler`` runs
over a fixed slice of whole cycles at the window's start, and the window's
seconds count from the slice's end (``window``)."""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

from . import check, registry, trace
from .inputs import perturb

BANNED = ("jax", "jaxlib", "flax", "openhyperflow2d_tpu")


def loaded_banned() -> list:
    """Top-level names of ``BANNED`` modules that this process holds."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(BANNED))


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def build(cell: dict, seed: int, device):
    """Set-up up to the solver: (solver, seconds ``build_case`` took)."""
    from openhyperflow2d_torch.config.deck import load_deck
    from openhyperflow2d_torch.solver.init import build_case
    cfg = cell["config"]
    deck = load_deck(cfg["deck_path"])
    t0 = time.perf_counter()
    case = build_case(deck, dtype=cfg["dtype"])
    build_s = time.perf_counter() - t0
    return make_solver(case, cell, seed, device), build_s


def make_solver(case, cell: dict, seed: int, device):
    """The cell's solver on a copy of ``case`` with the seed's data."""
    import copy

    from openhyperflow2d_torch.solver.runner import Solver
    cfg, tr = cell["config"], cell["traffic"]
    case = copy.copy(case)
    case.grid = copy.deepcopy(case.grid)
    case.params = dataclasses.replace(case.params,
                                      fast_math=bool(cfg["fast_math"]))
    perturb(case.grid, seed, cfg["perturbation"])
    return Solver(case, device=device, use_kernels=True,
                  dispatch=tr["dispatch"], fuse_iters=int(tr["fuse_iters"]))


def window(solver, seconds: float, trace_slice=None, device="cuda"):
    """Whole cycles until ``seconds`` have passed.  With ``trace_slice`` =
    (cycles before it, cycles in it) the profiler runs over that slice, and
    the ``seconds`` count from the slice's end: the profiler's start and
    stop stay out of them, and the comparison after the window reads the
    flow as far on as a run without the trace does.  Returns (cycles,
    seconds since the count started, cycles that failed, profiler or
    None)."""
    prof = None
    cycles = failed = 0
    t0 = time.perf_counter()
    while True:
        if trace_slice and cycles == trace_slice[0]:
            prof = torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA])
            prof.start()
            mark = torch.profiler.record_function(trace.SLICE)
            mark.__enter__()
        diags, _ = solver.run_cycle()
        cycles += 1
        if solver.stats.unstable or not all(
                bool(torch.isfinite(torch.as_tensor(v)).all())
                for k, v in diags.items() if k in ("RMS", "dt_used")):
            failed += 1
        if trace_slice and cycles == sum(trace_slice):
            mark.__exit__(None, None, None)
            sync(device)
            prof.stop()
            t0 = time.perf_counter()
        if (time.perf_counter() - t0 >= seconds
                and (not trace_slice or cycles > sum(trace_slice))):
            return cycles, time.perf_counter() - t0, failed, prof


def finite_state(solver) -> bool:
    st = solver.state
    return all(bool(torch.isfinite(getattr(st, f)).all())
               for f in check.PLANES)


def nvidia_smi() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,clocks.sm,clocks.max.sm,"
             "power.draw,power.limit,temperature.gpu",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi failed: {e}"


def run(cell_name: str, seed: int, seconds: float, trace_on: bool,
        device="cuda", root: Path = registry.ROOT, log=sys.stderr) -> dict:
    """One run of the cell; returns the result dict (the last key,
    ``checks``, holds each compared number with its limit)."""
    t_start = time.perf_counter()
    cell = registry.cell(cell_name, root)
    tr = cell["traffic"]
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    solver, build_s = build(cell, seed, device)
    t0 = time.perf_counter()
    init = check.snapshot(solver.state)
    snap_s = time.perf_counter() - t0
    solver.run_cycle()
    sync(device)
    setup_s = time.perf_counter() - t_start - snap_s
    print(f"portbench: {cell_name} seed {seed}: set-up {setup_s:.3f} s "
          f"(build_case {build_s:.3f} s)", file=log)

    trace_slice = (int(tr["trace_after_cycles"]), int(tr["trace_cycles"])) \
        if trace_on else None
    cycles, win_s, failed, prof = window(solver, seconds, trace_slice,
                                         device)
    if not finite_state(solver):
        failed += 1
    mem = torch.cuda.max_memory_allocated(device) if cuda else 0
    p = solver.params
    nodes = p.MaxX * p.MaxY
    iters = cycles * solver.case.Nstep
    if cuda:
        print(json.dumps({"nvidia_smi": nvidia_smi(),
                          "max_memory_allocated": mem}), flush=True)

    # the comparison, after the window: the program's last call, then
    # the program's state freed before the reference runs
    t0 = time.perf_counter()
    prog = check.collect(solver, int(tr["check_iters"]), init)
    K = solver.fuse_iters
    del solver
    if cuda:
        torch.cuda.empty_cache()
    ref_case = check.reference_case(cell, seed, device)
    ref = check.Plain(ref_case, check.REFERENCE, device)
    got = check.numbers(prog, ref, K=K)
    del prog, ref
    print(f"portbench: window {win_s:.3f} s, {cycles} cycles; comparison "
          f"{time.perf_counter() - t0:.3f} s", file=log)
    limits = cell["limits"]
    checks = {k: {"value": got.get(k), "limit": v}
              for k, v in limits.items()}
    correct = check.judge(got, limits, failed)

    record = {"gcups": nodes * iters / win_s / 1e9, "setup_s": setup_s,
              "build_case_s": build_s, "iters": iters, "window_s": win_s}
    result = {"correct": correct, "attempted": cycles, "failed": failed}
    device_info = {"platform": "gpu" if cuda else "cpu",
                   "kind": torch.cuda.get_device_name(device) if cuda
                   else "cpu", "count": 1, "memory_peak_bytes": mem}
    if trace_on:
        sl = trace.read(trace.export(prof), trace.torch_patterns(root))
        sl["iters"] = int(tr["trace_cycles"]) * ref_case.Nstep
        sl["work_bytes"] = work_bytes(ref_case, root)
        print(json.dumps({"port_kernels": sl["port_names"],
                          "work_bytes": sl["work_bytes"]}), file=log)
        sl["peaks"] = registry.load_json(Path(root) / "peaks.json")
        record.update(trace=sl)
        device_info.update(busy_s=sl["busy_s"], window_s=sl["window_s"])
    kind = "per_layer" if trace_on else "end_to_end"
    metrics = {}
    for name, (entry, reader) in registry.metrics_of(kind, root).items():
        v = reader.read(record)
        if v is not None:
            metrics[name] = {"value": v, "unit": entry["unit"]}
    result.update(metrics=metrics, device=device_info)
    if trace_on:
        result["breakdown"] = {"device_ops": record["trace"]["device_ops"],
                               "idle_gaps": record["trace"]["idle_gaps"]}
    result["checks"] = checks
    return result


def work_bytes(case, root: Path = registry.ROOT):
    """{class: bytes one iteration's work moves at its nodes} of the
    case, by ``work/<class>.py``; None where the classes of the flow
    nodes (those without ``ADDS``) do not count every flow node once: the
    work of this deck's physics is not counted yet."""
    from .inputs import flow_nodes
    out, counted = {}, 0
    for name, mod in registry.work_classes(root).items():
        n = mod.nodes(case.grid, case.params)
        if n is None:
            continue
        out[name] = mod.BYTES_PER_NODE * n
        if not getattr(mod, "ADDS", False):
            counted += n
    return out if counted == int(flow_nodes(case.grid).sum()) else None
