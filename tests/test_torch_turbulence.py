"""Port parity: the k-eps variants on the eager path, and the case reuse
of the 2048^2 closure run.

* Eager, float64, against JAX's XLA path (torch_parity.eager_closure_runs)
  on the 48x40 wall channel of tests/test_turbulence_models.py with
  TurbulenceModel 4 and TurbExtModel Chien, JL, LSY, RNG, and Realisable,
  which no branch of _turb_mod_rans names (the standard constants): the
  initial fill and a 5-iteration chunk (Chien's after 2 iterations and
  recalc_y_plus, so that y+ and mu_t are positive), every field to 1e-10
  of its plane's scale, beta by beta_err, RMS and dt_used to rtol 1e-10.
  ``check_supported`` accepts each case.
* A TurbExtModel no branch names runs the standard closure bit for bit.
* ``build_case`` of combustor_deck(64, 64) with TurbExtModel = Chien or
  RNG equals the standard deck's case with ``params.tem`` replaced, field
  by field (chip_smoke.py runs its 2048^2 k-eps variant so, without a
  second host build).
"""

import dataclasses

import numpy as np
import pytest
import torch
from torch_parity import (TURB_CLOSURES, check_eager_chunk,
                          check_eager_init, jax_wall_channel, port_case)

from openhyperflow2d_tpu.solver import init as jinit
from openhyperflow2d_torch.core import flags as fl
from openhyperflow2d_torch.examples import combustor_deck, wall_channel_deck
from openhyperflow2d_torch.solver.init import build_case
from openhyperflow2d_torch.solver.runner import Solver, check_supported

VARIANTS = ("chien", "jl", "lsy", "rng", "realisable")


@pytest.mark.parametrize("name", VARIANTS)
def test_init_fill_matches_jax(name):
    check_eager_init(name)


@pytest.mark.parametrize("name", VARIANTS)
def test_chunk_matches_jax(name):
    check_eager_chunk(name)


@pytest.mark.parametrize("name", VARIANTS)
def test_check_supported_accepts(name):
    p = port_case(jinit.build_case(jax_wall_channel(name))).params
    assert p.models == ("keps",) and p.tem == getattr(
        fl, TURB_CLOSURES[name][1])
    check_supported(p)


def test_unnamed_tem_runs_the_standard_closure():
    """TurbExtModel 9 (Realisable) takes the standard k-eps constants: the
    eager chunk gives TurbExtModel 4's bits."""
    out = []
    for tem in (fl.TEM_k_eps_Std, fl.TEM_k_eps_Realisable):
        s = Solver(build_case(wall_channel_deck(32, 24, 4, tem)),
                   device="cpu", use_kernels=False)
        s.run_iters(4)
        out.append(s.state)
    for f in ("S", "beta", "U", "V", "p", "Tg", "mu_t", "A", "B"):
        assert torch.equal(getattr(out[0], f), getattr(out[1], f)), f


def _same(a, b, what):
    """Field by field equality of two host values (arrays, dataclasses,
    lists and dicts of them)."""
    if dataclasses.is_dataclass(a):
        for f in dataclasses.fields(a):
            _same(getattr(a, f.name), getattr(b, f.name), f"{what}.{f.name}")
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), what
        for k in a:
            _same(a[k], b[k], f"{what}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), what
        for k, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{what}[{k}]")
    elif isinstance(a, np.ndarray):
        np.testing.assert_array_equal(a, b, what)
    elif hasattr(a, "__dict__"):      # Flow2D, Table, HostGrid, ...
        assert type(a) is type(b), what
        _same(vars(a), vars(b), what)
    else:
        assert a == b, what


@pytest.mark.parametrize("tem", [fl.TEM_k_eps_Chien, fl.TEM_k_eps_RNG])
def test_case_with_a_new_tem_equals_a_fresh_build(tem):
    base = build_case(combustor_deck(64, 64))
    deck = combustor_deck(64, 64)
    deck.data["TurbExtModel"] = str(tem)
    fresh = build_case(deck)
    reused = dataclasses.replace(base, params=dataclasses.replace(
        base.params, tem=tem))
    for f in dataclasses.fields(fresh):
        if f.name == "deck":   # the decks differ in TurbExtModel alone
            a, b = fresh.deck.data, base.deck.data
            assert {k for k in a.keys() | b.keys()
                    if a.get(k) != b.get(k)} == {"TurbExtModel"}
            continue
        _same(getattr(fresh, f.name), getattr(reused, f.name), f.name)
