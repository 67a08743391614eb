"""Port parity: the reference's ``.hf2d`` swap file (io_out/swapfile) and
its PreloadFlag resume (``build_case(use_swap=True)``), and
``profile_solver``.

The counterparts of tests/test_swapfile.py::test_swap_roundtrip and
tests/test_swap_resume.py's fast tests:

* for the same state the port's write_swap_file writes the bytes of the
  JAX package's (the same numpy arrays handed to both writers);
* the round trip: the file holds the solver's state, and
  ``state_from_swap`` restores it bit for bit;
* the run continued through the swap (``build_case(use_swap=True)``, dt
  and last_iter restored as JAX's test restores them) is bit for bit the
  uninterrupted run, on the eager path (float64) and on the kernel path's
  plain versions (float32, K = 2; float32 passes through the file's
  float64 exactly), and onto 2 X strips of the kernel path;
* no preload without a file or with a file of the wrong size;
* the CLI (``--swap``, the default) resumes from the swap a first run
  wrote, with "PreloadFlag=1" and GlobalTime continued;
* profile_solver writes a Chrome trace with the solver's spans.
"""

import json
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from test_torch_cli import CPU, run_cli

from openhyperflow2d_torch import spans
from openhyperflow2d_torch.cli import main
from openhyperflow2d_torch.config.deck import deck_to_text
from openhyperflow2d_torch.examples import channel_deck, combustor_deck
from openhyperflow2d_torch.io_out.swapfile import (NODE_SIZE, read_swap_file,
                                                   state_from_swap,
                                                   write_swap_file)
from openhyperflow2d_torch.parallel.comm import LocalComm
from openhyperflow2d_torch.solver.init import build_case
from openhyperflow2d_torch.solver.runner import Solver, profile_solver

# the fields a resumed run is held to: all but y_plus, which build_case
# recomputes from the swap's gradients (recalc_y_plus), as the reference's
# resume does; no closure of these decks reads it
SKIP = ("y_plus",)


def test_swap_bytes_match_jax(tmp_path):
    """The port's writer and the JAX package's write the same bytes for
    the same state: the port's host_state() after a few iterations of the
    combustor, with its grid and global time, handed to both."""
    from openhyperflow2d_tpu.io_out.swapfile import \
        write_swap_file as jax_write
    case = build_case(combustor_deck(32, 48))
    s = Solver(case, device="cpu")
    s.run_iters(4)
    s.global_time = 2.5e-6
    st = s.host_state()
    ours, theirs = tmp_path / "port.hf2d", tmp_path / "jax.hf2d"
    write_swap_file(str(ours), s, case.grid, st=st)
    jax_write(str(theirs), SimpleNamespace(params=s.params,
                                           global_time=s.global_time),
              case.grid, st=SimpleNamespace(**st))
    assert ours.stat().st_size == 32 * 48 * NODE_SIZE
    assert ours.read_bytes() == theirs.read_bytes()


def test_swap_roundtrip(tmp_path):
    case = build_case(channel_deck(nx=32, ny=24))
    s = Solver(case, device="cpu")
    s.run_iters(10)
    s.global_time = 3.3e-6
    path = str(tmp_path / "x.hf2d")
    write_swap_file(path, s, case.grid)
    assert os.path.getsize(path) == 32 * 24 * NODE_SIZE
    d = read_swap_file(path, 32, 24)
    st = s.host_state()
    for f in ("S", "beta", "U", "A"):
        np.testing.assert_array_equal(d[f], st[f])
    np.testing.assert_array_equal(d["Y"], st["Yc"])
    np.testing.assert_array_equal(d["CT"], case.grid.CT.astype(np.uint64))
    assert d["time"][0, 0] == pytest.approx(3.3e-6)
    # loading it back reproduces the state bit for bit (dt: the solver's)
    s2 = Solver(build_case(channel_deck(nx=32, ny=24)), device="cpu")
    state_from_swap(path, s2)
    got = s2.host_state()
    for f in st:
        if f != "dt":
            np.testing.assert_array_equal(got[f], st[f], err_msg=f)
    assert s2.global_time == pytest.approx(3.3e-6)


def resume(deck_fn, tmp_path, dtype="float64", use_kernels=False,
           fuse_iters=1, comm=None, n=6):
    """(the uninterrupted run's host state, the resumed run's) after n +
    n iterations, the swap written after the first n."""
    ref = Solver(build_case(deck_fn(), dtype=dtype), device="cpu",
                 use_kernels=use_kernels, fuse_iters=fuse_iters)
    ref.run_iters(n)
    ref.global_time = 1.25e-5
    dt_mid = ref.state.dt.clone()
    deck = deck_fn()
    # a resume that keeps the turbulence: build_case's ScanArea reset runs
    # on a preloaded case too (zeroing k, eps and mu_t), as the
    # reference's does
    deck.data["isTurbulenceReset"] = "0"
    swap = tmp_path / (deck.get_str("ProjectName") + ".hf2d")
    write_swap_file(str(swap), ref, ref.case.grid)
    ref.run_iters(n)

    case = build_case(deck, dtype=dtype, use_swap=True,
                      swap_dir=str(tmp_path))
    assert case.preloaded and case.swap_path == str(swap)
    res = Solver(case, device=None if comm else "cpu",
                 use_kernels=use_kernels, fuse_iters=fuse_iters, comm=comm)
    assert res.global_time == pytest.approx(1.25e-5)
    if comm is None:
        res.state = res.state.replace(dt=dt_mid)
    else:
        res.state = type(res.state)([st.replace(dt=dt_mid)
                                     for st in res.state.strips])
    res.last_iter = n          # scenario / turb-start indexing continues
    res.run_iters(n)
    return ref.host_state(), res.host_state()


def assert_same(want, got):
    for f in want:
        if f not in SKIP:
            assert np.array_equal(want[f], got[f]), f


@pytest.mark.parametrize("path", ["eager", "kernel"])
def test_preload_exact_continuation(tmp_path, path):
    """The combustor (NS k-eps, walls) continued through the swap is bit
    for bit the uninterrupted run: eager in float64, the kernel path's
    plain versions in float32 at K = 2."""
    def deck():
        return combustor_deck(32, 48)
    if path == "eager":
        want, got = resume(deck, tmp_path)
    else:
        want, got = resume(deck, tmp_path, "float32", True, 2)
    assert_same(want, got)


def test_preload_onto_strips(tmp_path):
    """The preloaded case onto 2 X strips of the kernel path (the plain
    versions, float32): bit for bit the uninterrupted single domain."""
    want, got = resume(lambda: combustor_deck(32, 48), tmp_path, "float32",
                       True, 1, LocalComm(2, "cpu"))
    assert_same(want, got)


def test_no_preload_without_swap_file(tmp_path):
    deck = channel_deck(nx=32, ny=24)
    deck.data["ProjectName"] = "nothere"
    case = build_case(deck, use_swap=True, swap_dir=str(tmp_path))
    assert not case.preloaded          # fresh start; bounds force-reset


def test_preload_rejects_wrong_size(tmp_path, capsys):
    """A swap file of another size is not preloaded, and the run says so:
    the path, its size, the size expected and that a write replaces it."""
    deck = channel_deck(nx=32, ny=24)
    deck.data["ProjectName"] = "bad"
    path = tmp_path / "bad.hf2d"
    path.write_bytes(b"\0" * 1000)
    case = build_case(deck, use_swap=True, swap_dir=str(tmp_path))
    assert not case.preloaded
    said = capsys.readouterr().out
    assert (f"Swap file {str(path)!r} holds 1000 bytes, not the "
            f"{32 * 24 * NODE_SIZE} of a 32x24 grid: not preloaded "
            f"(PreloadFlag=0); a swap write overwrites it") in said, said
    # a file of another grid's size is not half-loaded either
    path.write_bytes(b"\0" * (16 * 24 * NODE_SIZE))
    assert not build_case(deck, use_swap=True,
                          swap_dir=str(tmp_path)).preloaded
    assert f"holds {16 * 24 * NODE_SIZE} bytes" in capsys.readouterr().out
    # no file: nothing to say
    path.unlink()
    assert not build_case(deck, use_swap=True,
                          swap_dir=str(tmp_path)).preloaded
    assert "Swap file" not in capsys.readouterr().out


def test_cli_auto_resume(tmp_path):
    """A second CLI run in the same directory resumes from the swap the
    first synced (--swap, the default), continuing GlobalTime."""
    deck = channel_deck(nx=16, ny=16, nmax=5)
    deck.data["ProjectName"] = "chan"
    deck_file = tmp_path / "chan.dat"
    deck_file.write_text(deck_to_text(deck))
    argv = [str(deck_file), "--outdir", str(tmp_path), "--max-cycles", "2",
            *CPU]
    rc, out1 = run_cli(main, argv)
    assert rc == 0 and "PreloadFlag" not in out1
    t1 = float(out1.split("t=")[-1].split("s")[0])
    assert os.path.getsize(tmp_path / "chan.hf2d") == 16 * 16 * NODE_SIZE
    rc, out2 = run_cli(main, argv)
    assert rc == 0
    assert "Mapping computation area from" in out2
    assert "PreloadFlag=1" in out2
    t2 = float(out2.split("t=")[-1].split("s")[0])
    assert t2 > t1 * 1.5               # GlobalTime continued, not reset


def test_profile_solver_writes_a_trace(tmp_path):
    s = Solver(build_case(channel_deck(nx=16, ny=16)), device="cpu")
    path = profile_solver(s, n_iters=3, trace_dir=str(tmp_path / "trace"))
    assert os.path.dirname(path) == str(tmp_path / "trace")
    trace = json.loads(open(path).read())
    assert trace["traceEvents"]
    # the solver's spans are annotations of the trace, on for its call only
    assert "solver.chunk" in {e.get("name") for e in trace["traceEvents"]
                              if e.get("cat") == "user_annotation"}
    assert not spans.enabled()
    assert s.last_iter == 5
    assert torch.isfinite(s.state.S).all()
