"""Port parity: the deck-driven CLI, ``python -m openhyperflow2d_torch.cli``.

* Against the JAX CLI (``--no-swap --devices 1``): the port's (``--device cpu
  --no-pallas``, float64) runs ``deck_to_text(channel_deck(32, 24,
  nmax=...))`` with two monitor points for 2 cycles into its own
  directory.  Both write the same
  files, with the same names and header lines, and the same printed
  lines but the step rates (and the JAX CLI's step-path line, which the
  port prints only when it chooses the path).  At nmax=5 (NOutStep=5: 2
  cycles of 6 iterations) the numeric columns of each file and the
  checkpoint's arrays agree to 1e-10 of their column's (array's) scale,
  beta where its
  equation is not at float noise (``beta_err``, BETA_FLOOR as in
  tests/test_torch_euler_kernel.py).  At nmax=30 (2 cycles of 30) the
  files, their headers, row counts and printed lines are compared, and
  the numbers are finite, but the numbers are not held to each other: on
  this deck float noise grows about tenfold every 5 iterations past the
  15th, and after 60 iterations JAX's compiled run parts from JAX run op
  by op by 3.2e-3 of a field's scale (the port from the compiled run by
  2.4e-3; B, the y-flux, by 2.9e-2).
* The counterparts of tests/test_output_and_checkpoint.py's CLI tests:
  a run end to end, the heat-flux deck keys (Cp_Flow_Index, y_max/y_min),
  the output-file suffix keys.
* ``--restore`` of cycle 1's checkpoint then one cycle gives the bits of
  the uninterrupted second cycle; ``--devices 2`` runs two X strips, and
  under torchrun's environment one strip a rank (two gloo ranks, spawned,
  meeting at a localhost port), the primary writing the files; ``--swap``
  (the default) writes ``<Project>.hf2d``, one 1248-byte node record a
  grid node, and a second run in the same directory resumes from it
  (tests/test_torch_swap.py); the auto path selection prints its reason.
"""

import contextlib
import io
import os
import re

import numpy as np
import pytest
from torch_parity import beta_err

from openhyperflow2d_torch.cli import main
from openhyperflow2d_torch.config.deck import deck_to_text, parse_deck
from openhyperflow2d_torch.examples import channel_deck
from openhyperflow2d_torch.io_out.host import host_view
from openhyperflow2d_torch.io_out.tecplot import read_tecplot_zone
from openhyperflow2d_torch.solver.checkpoint import load_checkpoint
from openhyperflow2d_torch.solver.init import build_case
from openhyperflow2d_torch.solver.runner import Solver

CPU = ["--device", "cpu"]
BETA_FLOOR = 1e-4
# printed numbers that differ between two runs of the same deck
RATE = re.compile(r"\(\d+(\.\d+)? step/sec\)|\(.*step/sec\)")


def run_cli(fn, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = fn(argv)
    return rc, buf.getvalue()


def numeric_rows(path):
    """(header lines, float rows) of a text output file."""
    heads, rows = [], []
    for line in path.read_text().splitlines():
        vals = line.split()
        try:
            rows.append([float(v) for v in vals])
        except ValueError:
            heads.append(line)
    return heads, rows


def column_errors(a_path, b_path):
    """Largest |a - b| of each numeric column over its largest |a|."""
    ha, ra = numeric_rows(a_path)
    hb, rb = numeric_rows(b_path)
    assert ha == hb, (a_path.name, ha, hb)
    ra = [r for r in ra if r]
    rb = [r for r in rb if r]
    assert [len(r) for r in ra] == [len(r) for r in rb], a_path.name
    a, b = np.array(ra), np.array(rb)
    scale = np.abs(a).max(0)
    return np.abs(a - b).max(0) / np.where(scale > 0, scale, 1.0)


@pytest.mark.parametrize("nmax,tol", [(5, 1e-10), (30, None)])
def test_cli_matches_the_jax_cli(tmp_path, nmax, tol):
    from openhyperflow2d_tpu.cli import main as jax_main
    deck = tmp_path / "Channel.dat"
    d = channel_deck(32, 24, nmax=nmax)
    if nmax < 10:
        d.data["NOutStep"] = str(nmax)
    # two monitor points: the Monitors file (the eager chunk's probes)
    d.data.update({"NumMonitorPoints": "2", "Point-1.X": "0.1",
                   "Point-1.Y": "0.05", "Point-2.X": "0.25",
                   "Point-2.Y": "0.2"})
    deck.write_text(deck_to_text(d))
    rc_j, out_j = run_cli(jax_main, [str(deck), "--max-cycles", "2",
                                     "--outdir", str(tmp_path / "jax"),
                                     "--no-swap", "--devices", "1"])
    rc_t, out_t = run_cli(main, [str(deck), "--max-cycles", "2",
                                 "--outdir", str(tmp_path / "torch"),
                                 "--no-pallas", "--no-swap", *CPU])
    assert rc_j == rc_t == 0
    files = sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert files == sorted(p.name for p in (tmp_path / "torch").iterdir())
    assert files == ["Channel.ckpt.npz", "Channel.plt", "Monitors-Channel",
                     "RMS-Channel", "tp-Channel.plt"]

    def lines(out, outdir):
        return [RATE.sub("", ln).replace(str(tmp_path / outdir), "OUT")
                for ln in out.splitlines()
                if not ln.startswith(("step path:", "Cycle "))]

    assert lines(out_t, "torch") == lines(out_j, "jax")
    cycles = [ln for ln in out_t.splitlines() if ln.startswith("Cycle ")]
    assert [c.split(" maxRMS")[0] for c in cycles] == [
        c.split(" maxRMS")[0] for c in out_j.splitlines()
        if c.startswith("Cycle ")]
    for f in files:
        a, b = tmp_path / "jax" / f, tmp_path / "torch" / f
        if f.endswith(".npz"):
            with np.load(a) as za, np.load(b) as zb:
                assert sorted(za.files) == sorted(zb.files)
                want, got = dict(za), dict(zb)
            assert all(np.isfinite(v).all() for v in got.values())
            if tol is None:
                continue
            assert beta_err(want, got, floor=BETA_FLOOR) < 1.0
            for k in want:
                if k == "beta":
                    continue
                x, y = want[k].astype(float), got[k].astype(float)
                s = np.abs(x).max() if x.size else 0.0
                assert np.abs(x - y).max(initial=0.0) <= tol * max(
                    s, 1e-300), k
            continue
        err = column_errors(a, b)
        assert np.isfinite(err).all(), f
        assert tol is None or err.max() < tol, (f, err)


def test_cli_end_to_end(tmp_path):
    deck = tmp_path / "Channel.dat"
    deck.write_text(deck_to_text(channel_deck(nx=32, ny=24, nmax=30)))
    rc, out = run_cli(main, [str(deck), "--max-cycles", "2", "--outdir",
                             str(tmp_path), *CPU])
    assert rc == 0
    assert "Ready. Computation finished." in out
    assert "step path: eager (device is 'cpu'" in out
    for f in ("Channel.plt", "RMS-Channel", "Channel.ckpt.npz",
              "tp-Channel.plt"):
        assert (tmp_path / f).exists(), f
    g = read_tecplot_zone(str(tmp_path / "Channel.plt"), 32, 24)
    assert np.isfinite(g["p"]).all()


def test_cli_heatflux_x_flow_index_and_window(tmp_path):
    from openhyperflow2d_torch.examples import reacting_rans_deck
    from openhyperflow2d_torch.postproc.outcfd import save_x_heat_flux
    d = reacting_rans_deck(32, 24, wall_bottom=True, adiabatic=False,
                           with_step=True)
    d.data["isOutHeatFluxX"] = "1"
    d.data["Cp_Flow_Index"] = "2"
    d.data["y_min"] = "0"
    d.data["y_max"] = "4"
    d.data["Nmax"] = "6"
    deck = tmp_path / "HF.dat"
    deck.write_text(deck_to_text(d))
    rc, _ = run_cli(main, [str(deck), "--max-cycles", "1", "--outdir",
                           str(tmp_path), *CPU])
    assert rc == 0
    hf_path = tmp_path / "HeatFlux-X-Channel"
    assert hf_path.exists()
    case = build_case(parse_deck(deck_to_text(d)))
    s = Solver(case, device="cpu")
    load_checkpoint(str(tmp_path / "Channel.ckpt.npz"), s)
    st = host_view(s.host_state())
    hp = case.heatflux_params
    assert hp == {"Cp_Flow_index": 2, "y_max": 4, "y_min": 0}
    exp_path = tmp_path / "expected"
    save_x_heat_flux(str(exp_path), case.grid, st,
                     case.flow2d_list[hp["Cp_Flow_index"] - 1],
                     case.params.Ts0, hp["y_max"], hp["y_min"])
    assert hf_path.read_bytes() == exp_path.read_bytes()
    fl2 = case.flow2d_list[1]
    q2 = 0.5 * fl2.ROG() * fl2.Wg() ** 2
    rows = [ln.split() for ln in hf_path.read_text().splitlines()[1:]]
    cp_file = float(rows[3][3])
    assert cp_file == pytest.approx((float(st.p[3, 0]) - fl2.Pg()) / q2,
                                    rel=2e-6)
    old_path = tmp_path / "old_hardcoded"
    save_x_heat_flux(str(old_path), case.grid, st, case.flow2d_list[0],
                     case.params.Ts0, case.params.MaxY, 0)
    assert hf_path.read_bytes() != old_path.read_bytes()


def test_cli_output_file_suffix_keys(tmp_path):
    d = channel_deck(nx=32, ny=24, nmax=30)
    d.data["OutputFile"] = ".dat.plt"
    d.data["ErrorFile"] = ".failed.plt"
    deck = tmp_path / "Channel.dat"
    deck.write_text(deck_to_text(d))
    rc, _ = run_cli(main, [str(deck), "--max-cycles", "1", "--outdir",
                           str(tmp_path), *CPU])
    assert rc == 0
    assert (tmp_path / "Channel.dat.plt").exists()
    assert (tmp_path / "tp-Channel.dat.plt").exists()
    assert not (tmp_path / "Channel.plt").exists()
    case = build_case(channel_deck(nx=8, ny=8))
    assert (case.output_suffix, case.error_suffix) == (".plt", "-err.plt")


@pytest.mark.parametrize("path", [["--no-pallas"],
                                  ["--pallas", "--dtype", "float32"]])
def test_restore_continues_with_the_same_bits(tmp_path, path):
    """Eager in float64, and the kernel path's plain versions at K = 8 in
    float32: --restore of cycle 1's checkpoint, then one cycle, equals the
    uninterrupted second cycle bit for bit."""
    deck = tmp_path / "Channel.dat"
    deck.write_text(deck_to_text(channel_deck(32, 24, nmax=10)))
    for out, extra in (("two", ["--max-cycles", "2"]),
                       ("one", ["--max-cycles", "1"])):
        rc, _ = run_cli(main, [str(deck), "--outdir", str(tmp_path / out),
                               *extra, *path, *CPU])
        assert rc == 0
    rc, out = run_cli(main, [str(deck), "--outdir", str(tmp_path / "more"),
                             "--max-cycles", "1", "--restore",
                             str(tmp_path / "one" / "Channel.ckpt.npz"),
                             *path, *CPU])
    assert rc == 0 and "restored from" in out
    with np.load(tmp_path / "two" / "Channel.ckpt.npz") as a, \
            np.load(tmp_path / "more" / "Channel.ckpt.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].tobytes() == b[k].tobytes(), k


def test_devices_runs_strips(tmp_path):
    deck = tmp_path / "Channel.dat"
    deck.write_text(deck_to_text(channel_deck(32, 24, nmax=10)))
    outs = {}
    for n in (1, 2):
        rc, out = run_cli(main, [str(deck), "--outdir", str(tmp_path / str(n)),
                                 "--max-cycles", "1", "--devices", str(n),
                                 *CPU])
        assert rc == 0
        outs[n] = out
    assert "2 X strips (LocalComm)" in outs[2]
    with np.load(tmp_path / "1" / "Channel.ckpt.npz") as a, \
            np.load(tmp_path / "2" / "Channel.ckpt.npz") as b:
        for k in ("S", "U", "V", "p", "Tg"):
            np.testing.assert_allclose(b[k], a[k], rtol=1e-12, atol=1e-9,
                                       err_msg=k)


def test_swap_raises_naming_the_swap_file(tmp_path):
    """``--swap`` (the JAX CLI's default, now ported) writes the swap file
    ``<Project>.hf2d`` of MaxX MaxY 1248-byte node records into --outdir
    every outer cycle; ``--no-swap`` writes none."""
    deck = tmp_path / "Channel.dat"
    deck.write_text(deck_to_text(channel_deck(16, 16, nmax=5)))
    rc, out = run_cli(main, [str(deck), "--swap", "--max-cycles", "1",
                             "--outdir", str(tmp_path / "on"), *CPU])
    assert rc == 0 and "PreloadFlag" not in out
    assert (tmp_path / "on" / "Channel.hf2d").stat().st_size == 16 * 16 * 1248
    rc, _ = run_cli(main, [str(deck), "--no-swap", "--max-cycles", "1",
                           "--outdir", str(tmp_path / "off"), *CPU])
    assert rc == 0 and not (tmp_path / "off" / "Channel.hf2d").exists()


RANK_TIMEOUT = 120


def cli_rank(rank, world, port, argv, out):
    """One rank of a torchrun-like launch: the environment torchrun sets,
    then the CLI, its exit code into ``out``."""
    import torch
    torch.set_num_threads(1)
    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank),
                      WORLD_SIZE=str(world), MASTER_ADDR="127.0.0.1",
                      MASTER_PORT=str(port))
    rc, _ = run_cli(main, argv)
    with open(out, "w") as f:
        f.write(str(rc))
    import torch.distributed as dist
    dist.destroy_process_group()


def test_cli_over_two_gloo_ranks(tmp_path):
    """Under torchrun's environment (WORLD_SIZE=2) the CLI runs one strip a
    rank over DistComm (gloo on the CPU), the kernel path's plain versions
    with the Euler lam_t plane extended across ranks; rank 0 writes the
    files, and its checkpoint has the bits of --devices 2 in one
    process."""
    import multiprocessing
    import socket
    import time
    deck = tmp_path / "Channel.dat"
    deck.write_text(deck_to_text(channel_deck(32, 24, nmax=10)))
    argv = [str(deck), "--max-cycles", "2", "--pallas", "--fuse", "2",
            *CPU]
    rc, _ = run_cli(main, argv + ["--outdir", str(tmp_path / "local"),
                                  "--devices", "2"])
    assert rc == 0
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=cli_rank, args=(
        r, 2, port, argv + ["--outdir", str(tmp_path / f"rank{r}")],
        str(tmp_path / f"rc{r}"))) for r in range(2)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + RANK_TIMEOUT
    for p in procs:
        p.join(max(deadline - time.monotonic(), 0))
    hung = [p.pid for p in procs if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    assert not hung, f"ranks {hung} did not finish in {RANK_TIMEOUT} s"
    assert [(tmp_path / f"rc{r}").read_text() for r in range(2)] == ["0"] * 2
    assert sorted(p.name for p in (tmp_path / "rank1").iterdir()) == []
    assert sorted(p.name for p in (tmp_path / "rank0").iterdir()) == sorted(
        p.name for p in (tmp_path / "local").iterdir())
    with np.load(tmp_path / "local" / "Channel.ckpt.npz") as a, \
            np.load(tmp_path / "rank0" / "Channel.ckpt.npz") as b:
        for k in a.files:
            assert a[k].tobytes() == b[k].tobytes(), k
