"""Decides ``correct``: what the timed path produced against the plain
reference (``reference/``), after the window.

The program's side (``collect``): its build (the meta planes that
``build_case`` derived and the step reads), its initial state (taken at
set-up, ``snapshot``), and one more ``Solver.run_iters`` call from the
state the window left, then ``Solver.recalc_y_plus`` where ``run_cycle``
calls it: the cell's own entry, kernels and sizes.

The reference's side (``Plain``): its own case from the frozen deck and the
seed (its own wall-distance search), its own initial state, and the kernel
path's schedule over the plain step from the same state the program's call
started from.  It follows the program step by step from the program's
state: the window's thousands of iterations amplify rounding at the shocks
and flame past any comparison, so the start and one call are checked.

The control is the reference computed in float32 with every carried state
stored in bfloat16 (``CONTROL``), judged by the same numbers.  A number
with a limit in the cell's workload file is compared; ``correct`` holds
when every such number is at most its limit (``judge``).  The others are
read for the calibration alone."""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

# the state planes of state_l1 and state_max; beta, whose sqrt(|residual|)
# amplifies rounding, has a number of its own (beta_l1)
PLANES = ("S", "U", "V", "p", "Tg", "Yc", "mu_t")
INT_META = ("CT", "TCT", "idXl", "idXr", "idYu", "idYd", "NGX", "NGY")


@dataclasses.dataclass(frozen=True)
class Side:
    """A precision of the plain computation: its dtype and what each
    carried state passes through."""
    name: str
    dtype: str
    store_dtype: torch.dtype = None

    def round(self, t: torch.Tensor) -> torch.Tensor:
        if self.store_dtype is None or not t.is_floating_point():
            return t
        return t.to(self.store_dtype).to(t.dtype)

    def store(self, st):
        """The dataclass ``st`` with its float planes through ``round``."""
        if self.store_dtype is None:
            return st
        return dataclasses.replace(st, **{
            k: self.round(v) for k, v in vars(st).items()
            if torch.is_tensor(v) and v.dim()})


REFERENCE = Side("reference", "float64")
CONTROL = Side("control", "float32", torch.bfloat16)


def planes(st, fields=PLANES) -> list:
    """The (X, Y) planes of ``fields`` of a state (object or dict)."""
    out = []
    for f in fields:
        v = st[f] if isinstance(st, dict) else getattr(st, f)
        v = torch.as_tensor(v)
        out.extend(v.unbind(0) if v.dim() == 3 else [v])
    return out


def gaps(got: list, ref: list) -> tuple:
    """(widest relative L1 gap, widest relative max gap) over the planes:
    sum|got - ref| / sum|ref| and max|got - ref| / max|ref| of each plane;
    a plane that is zero in the reference must be zero; a value that is not
    finite on either side reads infinite."""
    l1 = mx = 0.0
    for a, r in zip(got, ref):
        a = a.to(device=r.device, dtype=torch.float64)
        r = r.to(torch.float64)
        d = (a - r).abs()
        s, m, ds, dm = (x.item() for x in (r.abs().sum(), r.abs().max(),
                                           d.sum(), d.max()))
        if s == 0.0:
            g = (0.0, 0.0) if dm == 0.0 else (math.inf, math.inf)
        else:
            g = (ds / s, dm / m)
        g = tuple(x if math.isfinite(x) else math.inf for x in g)
        l1, mx = max(l1, g[0]), max(mx, g[1])
    return l1, mx


def snapshot(state) -> dict:
    """The compared planes of the program's initial state, on the host."""
    return {f: getattr(state, f).detach().cpu() for f in PLANES}


def collect(solver, n_iters: int, init: dict) -> dict:
    """The program's side after the window (see the module); ``init`` is
    ``snapshot`` of its initial state."""
    meta = solver.meta
    X0 = dataclasses.replace(solver.state, **{
        k: v.clone() for k, v in vars(solver.state).items()
        if torch.is_tensor(v)})
    it0 = solver.last_iter
    diags = solver.run_iters(n_iters)
    recalc = solver.params.sm == 1 and len(solver.case.wall_nodes) > 0
    if recalc:
        solver.recalc_y_plus()
    return {"X0": X0, "it0": it0, "n": n_iters, "init": init,
            "diags": {k: torch.as_tensor(v) for k, v in diags.items()},
            "X1": solver.state, "recalc": recalc,
            "meta": {k: getattr(meta, k)
                     for k in INT_META + ("l_min", "i_wall", "j_wall")}}


class Plain:
    """The plain computation of one side on ``device``: its own case from
    the frozen deck and the seed (``reference_case``), its meta, static
    ctx, tables and initial state."""

    def __init__(self, case, side: Side, device):
        from .reference.core.physics import fill_node
        from .reference.core.state import meta_from_grid, state_from_grid
        from .reference.core.static_ctx import build_static_ctx
        from .reference.solver.init import chem_tables_device
        self.side = side
        p = dataclasses.replace(case.params, dtype=side.dtype)
        td = p.torch_dtype
        self.p, self.case = p, case
        self.meta = side.store(meta_from_grid(case.grid, dtype=td,
                                              device=device))
        self.ctx = build_static_ctx(self.meta, p)
        self.chem = chem_tables_device(case.chem, td, device)

        def tab(t):
            return (torch.as_tensor(np.asarray(t.x), dtype=td, device=device),
                    torch.as_tensor(np.asarray(t.y), dtype=td, device=device))

        self.beta_tab = tab(case.beta_scenario)
        self.cfl_tab = tab(case.cfl_scenario)
        st = side.store(state_from_grid(case.grid, p, case.dt0, device))
        self.init = side.store(fill_node(
            st, self.meta, p, torch.zeros((p.MaxX, p.MaxY), dtype=torch.bool,
                                          device=device), is_init=True))

    def run(self, prog: dict, K: int):
        """The program's ``run_iters`` call from its state ``prog["X0"]``:
        (state, diags) by ``reference.chunk.run_chunk``."""
        from .reference.chunk import run_chunk
        from .reference.core.state import SolverState
        td = self.p.torch_dtype
        X0 = SolverState(**{k: (v.to(td) if v.is_floating_point() else v)
                            for k, v in vars(prog["X0"]).items()})
        src = torch.as_tensor(self.case.grid.Src, dtype=td,
                              device=X0.S.device)
        return run_chunk(X0, self.meta, self.p, self.chem, self.ctx,
                         self.beta_tab, self.cfl_tab, prog["n"], prog["it0"],
                         K, src_ext=src, store=self.side.store)

    def y_plus(self, X1, y_prev):
        """y+ of the state ``X1`` (``recalc_y_plus``'s inputs), by this
        side."""
        from .reference.chunk import y_plus
        td = self.p.torch_dtype
        yp = y_plus(*(getattr(X1, f).to(td) for f in ("S", "dUdy", "dVdx",
                                                      "mu")),
                    y_prev.to(td), self.meta, self.p)
        return self.side.round(yp)


def reference_build(cell: dict, device):
    """The reference's case before the seed's data: the frozen deck
    through the reference's parser and build, the config's fast_math."""
    from .reference.config.deck import load_deck
    from .reference.solver.init import build_case
    cfg = cell["config"]
    case = build_case(load_deck(cfg["deck_path"]), dtype="float64",
                      wall_device=device)
    case.params = dataclasses.replace(case.params,
                                      fast_math=bool(cfg["fast_math"]))
    return case


def reference_case(cell: dict, seed: int, device, base=None):
    """The reference's case with the seed's perturbation: a new
    ``reference_build``, or a copy of ``base``, one."""
    import copy

    from .inputs import perturb
    if base is None:
        case = reference_build(cell, device)
    else:
        case = copy.copy(base)
        case.grid = copy.deepcopy(base.grid)
    perturb(case.grid, seed, cell["config"]["perturbation"])
    return case


def numbers(prog: dict, ref: Plain, other: Plain = None, K: int = 1) -> dict:
    """{number: value} of ``other``'s results against ``ref``'s: the
    program's (``prog``, when ``other`` is None) or another plain side's
    put in the program's place (the control), from the program's state."""
    out = {}
    if other is None:
        rm, pm = ref.meta, prog["meta"]

        def differ(names):
            return int(sum((pm[k].to(rm.CT.device).to(torch.int64)
                            != getattr(rm, k).to(torch.int64)).sum().item()
                           for k in names))

        out["flags_diff"] = differ(INT_META)
        out["wall_diff"] = differ(("i_wall", "j_wall"))
        lm_got, init_got = pm["l_min"], prog["init"]
    else:
        out["flags_diff"] = out["wall_diff"] = 0
        lm_got, init_got = other.meta.l_min, other.init
    out["lmin_gap"] = gaps([lm_got], [ref.meta.l_min])[1]
    out["init_l1"], out["init_max"] = gaps(planes(init_got),
                                           planes(ref.init))
    R1, dR = ref.run(prog, K)
    if other is None:
        X1, dg = prog["X1"], prog["diags"]
    else:
        X1, dg = other.run(prog, K)
    out["state_l1"], out["state_max"] = gaps(planes(X1), planes(R1))
    out["beta_l1"] = gaps(planes(X1, ("beta",)), planes(R1, ("beta",)))[0]
    dev = dR["dt_used"].device
    dt_g = dg["dt_used"].to(dev, torch.float64)
    dt_r = dR["dt_used"].to(torch.float64)
    out["dt_gap"] = ((dt_g - dt_r).abs() / dt_r).max().item()
    rg = dg["RMS"].to(dev, torch.float64)
    rr = dR["RMS"].to(torch.float64)
    den = torch.maximum(rg.abs(), rr.abs())
    out["rms_gap"] = torch.where(den > 0, (rg - rr).abs()
                                 / den.clamp_min(1e-300), 0.0).max().item()
    out["unstable_diff"] = int((dg["unstable"].to(dev).bool()
                                != dR["unstable"].bool()).sum().item())
    if prog["recalc"]:
        y_prev = prog["X0"].y_plus
        want = ref.y_plus(X1, y_prev)
        got = X1.y_plus if other is None else other.y_plus(X1, y_prev)
        out["yplus_l1"] = gaps([got], [want])[0]
    return out


def judge(got: dict, limits: dict, failed: int = 0) -> bool:
    """``correct``: no failed cycle, and every number that has a limit
    read and at most that limit."""
    return failed == 0 and all(k in got and got[k] <= v
                               for k, v in limits.items())
