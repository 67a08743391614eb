"""Axisymmetric cases built and driven: ``build_case`` with FlowType=1,
``Solver.set_sources`` and the CLI's sources.

* ``build_case`` of combustor_deck(64, 64) with FlowType=1 differs from
  the flat deck's case in ``params.ft`` and ``grid.ft`` alone, field by
  field, and the flat case with ``params.ft`` replaced runs the fresh
  axisymmetric case's bits (eager, 3 iterations): chip_smoke.py runs its
  2048^2 axisymmetric combustor so, without a second host build.
* ``Solver.set_sources`` against JAX's (runner.py:169-182), eager,
  float64, on scramjet_deck(64, 48): a doubled source field set between
  two chunks of 3 iterations reaches the next chunk, both packages agree
  to 1e-10 of each plane's scale, and the run parts from one without it.
* The port's CLI (``--device cpu --no-pallas``, float64) against JAX's
  (``--no-swap --devices 1``) on scramjet_deck(64, 48) with its source's
  StartIter at 6, so that the cycle loop's re-application switches it on
  for the second of 2 cycles of 6 iterations (apply_sources, then
  set_sources, as cli.py:208-212 of the JAX package): the same files,
  header lines and printed lines but the step rates, the numeric columns
  and the checkpoint's arrays to CLI_TOL of their scale (beta by
  beta_err).  CLI_TOL is 1e-8: after the 12 iterations JAX against
  itself, with S perturbed by 1e-15 of its value at the start, parts by
  1.02e-9 of the y-flux B's (and F's) scale, and the port parts from JAX
  by the same 1.02e-9 (S, U, V, p and Tg by 6e-11 at most).
"""

import dataclasses

import numpy as np
import torch
from test_torch_cli import BETA_FLOOR, CPU, RATE, column_errors, run_cli
from test_torch_turbulence import _same
from torch_parity import beta_err, np_copy, port_case, scaled_err

from openhyperflow2d_torch.cli import main
from openhyperflow2d_torch.config.deck import deck_to_text
from openhyperflow2d_torch.core import flags as fl
from openhyperflow2d_torch.examples import combustor_deck, scramjet_deck
from openhyperflow2d_torch.solver.init import build_case
from openhyperflow2d_torch.solver.runner import Solver

CLI_TOL = 1e-8

def test_axisymmetric_case_differs_from_flat_in_ft_alone():
    flat = build_case(combustor_deck(64, 64))
    deck = combustor_deck(64, 64)
    deck.data["FlowType"] = "1"
    fresh = build_case(deck)
    assert fresh.params.ft == fl.FT_AXISYMMETRIC
    assert fresh.grid.ft == fl.FT_AXISYMMETRIC
    reused = dataclasses.replace(flat, params=dataclasses.replace(
        flat.params, ft=fl.FT_AXISYMMETRIC))
    for f in dataclasses.fields(fresh):
        if f.name == "deck":   # the decks differ in FlowType alone
            a, b = fresh.deck.data, flat.deck.data
            assert {k for k in a.keys() | b.keys()
                    if a.get(k) != b.get(k)} == {"FlowType"}
            continue
        if f.name == "grid":
            assert flat.grid.ft == fl.FT_FLAT
            _same({**vars(fresh.grid), "ft": fl.FT_FLAT}, vars(flat.grid),
                  "grid")
            continue
        _same(getattr(fresh, f.name), getattr(reused, f.name), f.name)
    states = []
    for c in (fresh, reused):
        s = Solver(c, device="cpu", use_kernels=False)
        s.run_iters(3)
        states.append(s.state)
    for f in ("S", "beta", "U", "V", "p", "Tg", "F", "A", "B"):
        assert torch.equal(getattr(states[0], f), getattr(states[1], f)), f


def test_set_sources_matches_jax():
    from openhyperflow2d_tpu.solver import init as jinit
    from openhyperflow2d_tpu.examples import scramjet_deck as jax_scramjet
    from openhyperflow2d_tpu.solver.runner import Solver as JSolver
    jc = jinit.build_case(jax_scramjet(64, 48))
    src = np.asarray(jc.grid.Src) * 2.0
    js = JSolver(jc)
    ts = Solver(port_case(jc), device="cpu", use_kernels=False)
    unset = Solver(port_case(jc), device="cpu", use_kernels=False)
    for s in (js, ts, unset):
        s.run_iters(3)
    js.set_sources(src)
    ts.set_sources(src)
    for s in (js, ts, unset):
        s.run_iters(3)
    want, got = np_copy(js.state), ts.host_state()
    fields = ("S", "U", "V", "p", "Tg", "Yc", "mu_t", "F", "Src")
    errs = {f: scaled_err(want, got, f) for f in fields}
    assert max(errs.values()) < 1e-10, errs
    assert scaled_err(unset.host_state(), got, "S") > 1e-6


def test_cli_sources_match_the_jax_cli(tmp_path):
    from openhyperflow2d_tpu.cli import main as jax_main
    deck = tmp_path / "Scramjet.dat"
    d = scramjet_deck(64, 48)
    d.data.update({"Nmax": "5", "NOutStep": "5", "Src1.StartIter": "6"})
    deck.write_text(deck_to_text(d))
    rc_j, out_j = run_cli(jax_main, [str(deck), "--max-cycles", "2",
                                     "--outdir", str(tmp_path / "jax"),
                                     "--no-swap", "--devices", "1"])
    rc_t, out_t = run_cli(main, [str(deck), "--max-cycles", "2",
                                 "--outdir", str(tmp_path / "torch"),
                                 "--no-pallas", "--no-swap", *CPU])
    assert rc_j == rc_t == 0

    def lines(out, outdir):
        return [RATE.sub("", ln).replace(str(tmp_path / outdir), "OUT")
                for ln in out.splitlines()
                if not ln.startswith(("step path:", "Cycle "))]

    assert lines(out_t, "torch") == lines(out_j, "jax")
    files = sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert files == sorted(p.name for p in (tmp_path / "torch").iterdir())
    for f in files:
        a, b = tmp_path / "jax" / f, tmp_path / "torch" / f
        if f.endswith(".npz"):
            with np.load(a) as za, np.load(b) as zb:
                want, got = dict(za), dict(zb)
            assert sorted(want) == sorted(got)
            assert beta_err(want, got, floor=BETA_FLOOR) < 1.0
            for k in want:
                if k == "beta":
                    continue
                x, y = want[k].astype(float), got[k].astype(float)
                s = np.abs(x).max() if x.size else 0.0
                assert np.abs(x - y).max(initial=0.0) <= CLI_TOL * max(
                    s, 1e-300), k
            # the source, off in the first cycle, is on after it
            assert np.abs(got["Src"][0]).max() > 0
            continue
        err = column_errors(a, b)
        assert np.isfinite(err).all() and err.max() < CLI_TOL, (f, err)
