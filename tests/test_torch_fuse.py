"""Port parity: the kernel path's K-iteration blocks (``fuse_iters = K``).

The port's single-domain kernel path at ``fuse_iters=K`` against JAX's
``Solver(use_pallas=True, pallas_fuse=K, pallas_tile=(16, 128))``, the
Pallas kernel in interpret mode, in float64.  On CPU tensors the port's
wrappers run the kernels' plain versions.  Both freeze dt at a block's
entry and hold it over the block's K iterations (pallas_step.py:925-1030),
and both cut a chunk's n - 1 kernel iterations into ``divmod(n - 1, K)``
blocks and a remainder block with its own dt (:1099-1113).

* ``combustor_deck(64, 256)``, K = 2 and 4, over two 6-iteration cycles:
  each cycle is whole blocks and a remainder block.  Tolerances as
  tests/test_torch_kernel_path.py at K = 1: fields to 1e-10 of each
  plane's scale, beta by ``beta_err``, RMS and dt_used to rtol 1e-10,
  DD_max to 1e-8 where the equation is not at float noise, and the
  unstable and dt_overrun rows exactly.  The second cycle starts from
  JAX's state after the first.  Carried on from the port's own state, it
  parts from JAX by 4e-7 of S's scale at K = 4 (6e-11 at K = 2): with dt
  frozen over K iterations the impulsive start overruns the CFL limit in
  most iterations (dt_overrun), and differences at float noise grow
  there.  JAX against itself with S perturbed by 1e-15 parts by 3.6e-9
  after the same cycle, and from one state both packages' blocks agree
  to 3e-15; beta, which is noise over noise where an equation is at
  float noise (``beta_err``), carries the first cycle's differences into
  the second.
* ``reacting_rans_deck(48, 40)`` at K = 8 over 17 iterations
  (tests/test_pallas.py:301-315): the frozen dt of the impulsive start
  trips the dt_overrun monitor, on the same rows as JAX's.
* ``local_dt`` gives the bits of its former formula, which copied the CFL
  constant to the device on each call, and now makes no such copy.
* ``fuse_iters > 1`` on the eager path raises.

Each JAX run is made once and shared by the tests that read it.
"""

import functools

import numpy as np
import pytest
import torch
from torch_parity import beta_err, np_fields, port_case, scaled_err

from openhyperflow2d_tpu.examples import combustor_deck, reacting_rans_deck
from openhyperflow2d_tpu.solver import init as jinit
from openhyperflow2d_tpu.solver.runner import Solver as JSolver
from openhyperflow2d_torch.core.state import state_from_numpy
from openhyperflow2d_torch.ops import fused_step
from openhyperflow2d_torch.ops.fused_step import (carry_views, fuse_blocks,
                                                  local_dt)
from openhyperflow2d_torch.solver.runner import Solver

FIELDS = ["S", "U", "V", "p", "Tg", "Yc", "R", "CP", "lam", "mu", "mu_t",
          "dt", "y_plus"]
NOT_NOISE = [e for e in range(9) if e != 2]   # DD_max of rhoV: see beta_err
CYCLE = 6


def rel(got, want):
    want = np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want) / np.maximum(np.abs(want),
                                                        1e-300)))


@functools.lru_cache(maxsize=None)
def jax_cycles(K):
    """(JAX case, [(fields, diags) after each of two cycles]) of JAX's
    Pallas path at fuse_iters=K."""
    jc = jinit.build_case(combustor_deck(64, 256))
    jc.Nstep = CYCLE
    js = JSolver(jc, use_pallas=True, pallas_fuse=K, pallas_tile=(16, 128))
    out = []
    for _ in range(2):
        wd, _ = js.run_cycle()
        out.append((np_fields(js.state),
                    {k: np.asarray(v) for k, v in wd.items()}))
    return jc, out


def count_calls(monkeypatch, module, name):
    """Count the calls of ``module.name`` (a list that grows by one a
    call)."""
    calls, fn = [], getattr(module, name)

    def spy(*a, **kw):
        calls.append(1)
        return fn(*a, **kw)

    monkeypatch.setattr(module, name, spy)
    return calls


@pytest.mark.parametrize("K", [2, 4])
def test_fused_blocks_match_pallas_f64(K, monkeypatch):
    jc, want_cycles = jax_cycles(K)
    ts = Solver(port_case(jc), device="cpu", use_kernels=True, fuse_iters=K)
    assert ts._chunk_fn.K == K and f"fuse_iters={K}" in ts.path_reason
    scans = count_calls(monkeypatch, fused_step, "scan_dt")
    for c, (want, wd) in enumerate(want_cycles):
        if c:
            ts.state = state_from_numpy(want_cycles[c - 1][0])
        gd, _ = ts.run_cycle()
        got = ts.host_state()
        errs = {f: scaled_err(want, got, f) for f in FIELDS}
        assert max(errs.values()) < 1e-10, errs
        assert beta_err(want, got) < 1.0
        assert rel(gd["RMS"], wd["RMS"]) < 1e-10
        assert rel(gd["dt_used"], wd["dt_used"]) < 1e-10
        assert rel(gd["DD_max"][:, NOT_NOISE], wd["DD_max"][:, NOT_NOISE]) \
            < 1e-8
        for key in ("unstable", "dt_overrun"):
            np.testing.assert_array_equal(gd[key], wd[key], key)
        # dt_used: the prologue's dt, then one frozen dt a block
        for b0, kk in fuse_blocks(CYCLE, K):
            assert (gd["dt_used"][1 + b0:1 + b0 + kk]
                    == gd["dt_used"][1 + b0]).all()
    assert len(scans) == 2 * len(fuse_blocks(CYCLE, K))
    assert not gd["unstable"].any()


def test_k8_dt_overrun_rows_match_pallas(monkeypatch):
    """The frozen-dt CFL monitor at K = 8 (tests/test_pallas.py:301-315):
    the reacting impulsive start trips it, on JAX's rows."""
    jc = jinit.build_case(reacting_rans_deck(48, 40))
    js = JSolver(jc, use_pallas=True, pallas_tile=(16, 16), pallas_fuse=8)
    wd = {k: np.asarray(v) for k, v in js.run_iters(17).items()}
    ts = Solver(port_case(jc), device="cpu", use_kernels=True, fuse_iters=8)
    scans = count_calls(monkeypatch, fused_step, "scan_dt")
    gd = ts.run_iters(17)
    assert len(scans) == 2                     # two blocks of 8
    assert gd["dt_overrun"].shape == (17,)
    np.testing.assert_array_equal(gd["dt_overrun"], wd["dt_overrun"])
    assert gd["dt_overrun"].any()
    np.testing.assert_array_equal(gd["unstable"], wd["unstable"])
    assert rel(gd["dt_used"], wd["dt_used"]) < 1e-10
    assert rel(gd["RMS"], wd["RMS"]) < 1e-8


@pytest.mark.parametrize("n_iters,K,blocks", [
    (97, 8, [(8 * j, 8) for j in range(12)]),
    (97, 1, [(j, 1) for j in range(96)]),
    (6, 4, [(0, 4), (4, 1)]),
    (7, 2, [(0, 2), (2, 2), (4, 2)]),
    (1, 8, []),
])
def test_fuse_blocks(n_iters, K, blocks):
    """The chunk's block layout is make_pallas_chunk's divmod."""
    assert fuse_blocks(n_iters, K) == blocks


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_local_dt_bits_and_no_device_copy(dtype, monkeypatch):
    """``local_dt`` against its former formula, bit for bit, with the
    scenario's CFL above, at and below the deck's; it builds no tensor
    from a host value (the former formula's blocking copy)."""
    from openhyperflow2d_torch.core.physics import _safe_div
    case = jinit.build_case(combustor_deck(32, 64))
    ts = Solver(port_case(case), device="cpu", use_kernels=True)
    ch = ts._chunk_fn
    tdt = getattr(torch, dtype)
    ca, _, _, _ = ch.prologue(ts.state, 2, 0)
    slim = carry_views(ca.to(tdt), ts.state.dt.to(tdt))
    p, active = ts.params, ch.step.ctx.active

    def former(cfl_scen):
        cfl_min = torch.minimum(torch.tensor(p.CFL, dtype=tdt), cfl_scen)
        k_new = _safe_div(slim.CP, slim.CP - slim.R, 2.0)
        aaa = torch.sqrt(torch.clamp_min(k_new * slim.R * slim.Tg, 0.0))
        dtn = cfl_min * torch.minimum(p.dx / (aaa + torch.abs(slim.U)),
                                      p.dy / (aaa + torch.abs(slim.V)))
        return torch.clamp_max(torch.where(active, dtn, 1.0).amin(), 1.0)

    scen = [torch.tensor(v, dtype=tdt) for v in
            (p.CFL * 0.5, p.CFL, p.CFL * 2.0, 0.1 + 1e-9)]
    want = [former(c) for c in scen]

    def no_tensor(*a, **kw):
        raise AssertionError("local_dt built a tensor from a host value")

    monkeypatch.setattr(torch, "tensor", no_tensor)
    for c, w in zip(scen, want):
        got = local_dt(slim, active, p, c)
        assert got.dtype == tdt
        assert got.view(-1).numpy().tobytes() == w.view(-1).numpy().tobytes()


def test_fuse_iters_on_the_eager_path_raises():
    """The eager path has one dt an iteration: fuse_iters > 1 there
    raises instead of running another dt schedule than the one asked
    for."""
    case = port_case(jinit.build_case(combustor_deck(32, 64)))
    with pytest.raises(ValueError, match="fuse_iters=2"):
        Solver(case, device="cpu", use_kernels=False, fuse_iters=2)
    # the CPU picks the eager path by itself
    with pytest.raises(ValueError, match="fuse_iters=4"):
        Solver(case, device="cpu", fuse_iters=4)
    with pytest.raises(ValueError, match="fuse_iters"):
        Solver(case, device="cpu", use_kernels=True, fuse_iters=0)
    assert Solver(case, device="cpu", use_kernels=False).fuse_iters == 1
