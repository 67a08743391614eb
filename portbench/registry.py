"""Finds the benchmark's data by name: cells, configurations, traffic,
metric readers and work classes.  ``root`` is a ``portbench`` directory
(this one by default); ``BENCHMARK.json`` sits beside it."""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parent


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> dict:
    return load_json(Path(root).parent / "BENCHMARK.json")


def cell(name: str, root: Path = ROOT) -> dict:
    """The cell ``name``: its workload file, with ``config`` and
    ``traffic`` replaced by their files' contents (each with its
    ``name``), the deck's path under ``config["deck_path"]``."""
    root = Path(root)
    c = load_json(root / "workloads" / f"{name}.json")
    cfg_dir = root / "configs" / c["config"]
    cfg = load_json(cfg_dir / "config.json")
    cfg["name"] = c["config"]
    cfg["deck_path"] = str(cfg_dir / cfg["deck"])
    tr = load_json(root / "traffic" / f"{c['traffic']}.json")
    tr["name"] = c["traffic"]
    return {**c, "name": name, "config": cfg, "traffic": tr}


def _module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metrics_of(kind: str, root: Path = ROOT) -> dict:
    """{metric: (its BENCHMARK.json entry, its reader module)} of every
    ``kind`` ("end_to_end" or "per_layer") metric; a reader that finds
    nothing to read in a cell returns None there."""
    return {m["name"]: (m, _module(Path(root) / "metrics" / f"{m['name']}.py",
                                   f"portbench_metric_{m['name']}"))
            for m in benchmark(root)[kind]}


def work_classes(root: Path = ROOT) -> dict:
    """{class: module} of every ``work/<class>.py``."""
    return {p.stem: _module(p, f"portbench_work_{p.stem}")
            for p in sorted((Path(root) / "work").glob("*.py"))}
