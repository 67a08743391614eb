"""The kernel path's schedule over the plain step: the benchmark's reference
of one ``Solver.run_iters`` call and of ``Solver.recalc_y_plus``.

The schedule is the port's ``ops/fused_step.KernelChunk`` as its docstrings
state it (and JAX's ``make_pallas_chunk``): the chunk's first pass12 with
the state's dt; then its ``n - 1`` further iterations in blocks of ``K``,
each block on one dt taken from the carried primitives at its entry; each
iteration gfc (with the heat stage) and then pass12; last a gfc that gives
the fresh dt.  The stages are this package's frozen copies of the port's
plain ``core/step.gfc`` and ``core/step.pass12``.

``store`` is applied to every state the schedule carries from one stage to
the next: the identity for the reference, a rounding through a narrower
type for the control.
"""

from __future__ import annotations

import torch

from .core import flags as fl
from .core.physics import _safe_div
from .core.static_ctx import iscond
from .core.step import (expand, gfc, lam_t_const, make_aux, needs_y_plus,
                        pass12, shrink)


def blocks(n_iters: int, K: int) -> list:
    """(first iteration, length) of the blocks of a chunk's n_iters - 1
    iterations after its first pass12."""
    nb, rem = divmod(n_iters - 1, K)
    return [(j * K, K) for j in range(nb)] + ([(nb * K, rem)] if rem else [])


def carried_dt(slim, active, p, cfl_scen, dt_prev):
    """A block's dt: min(1, the least CFL dt of the carried primitives),
    monotone in the serial build's mode."""
    cfl_min = torch.clamp_max(cfl_scen, p.CFL)
    k_new = _safe_div(slim.CP, slim.CP - slim.R, 2.0)
    aaa = torch.sqrt(torch.clamp_min(k_new * slim.R * slim.Tg, 0.0))
    dtn = cfl_min * torch.minimum(p.dx / (aaa + torch.abs(slim.U)),
                                  p.dy / (aaa + torch.abs(slim.V)))
    dt = torch.clamp_max(torch.where(active, dtn, 1.0).amin(), 1.0)
    return torch.minimum(dt, dt_prev) if p.serial_dt_mode else dt


def run_chunk(state, meta, p, chem, ctx, beta_tab, cfl_tab, n_iters: int,
              start_iter: int, K: int, src_ext=None, store=None):
    """``n_iters`` iterations from ``state`` as the kernel path schedules
    them.  Returns (state, diags): diags holds per iteration ``RMS`` (n, 9),
    ``DD_max`` (n, 9), ``dt_used`` (n,) and ``unstable`` (n,)."""
    store = store or (lambda st: st)
    dtype = p.torch_dtype

    def aux(it):
        return make_aux(beta_tab, cfl_tab, p.TurbStartIter, it, dtype)

    src = (src_ext if p.has_ext_src and src_ext is not None
           else torch.zeros_like(state.S))
    yp = state.y_plus if needs_y_plus(p) else None
    lam = lam_t_const(state, p)
    state = store(state)
    S_c, beta_c, _, _, d0 = pass12(state, meta, p, aux(start_iter), ctx=ctx)
    slim = shrink(store(state.replace(S=S_c, beta=beta_c)))
    rms, ddm, dts, uns = [d0["RMS"]], [d0["DD_max"]], [state.dt], []
    dt = state.dt
    for b0, kk in blocks(n_iters, K):
        dt = carried_dt(slim, ctx.active, p, aux(start_iter + b0).cfl_scen,
                        dt)
        for b in range(start_iter + b0, start_iter + b0 + kk):
            slim.dt = dt
            full = expand(slim, p, src, yp, lam)
            out, _, unstable = gfc(full, meta, p, chem, aux(b),
                                   return_fields=True, ctx=ctx)
            out = store(out.replace(dt=dt))
            S_c, beta_c, _, _, d = pass12(out, meta, p, aux(b + 1), ctx=ctx)
            slim = shrink(store(out.replace(S=S_c, beta=beta_c)))
            rms.append(d["RMS"])
            ddm.append(d["DD_max"])
            dts.append(dt)
            uns.append(unstable.any())
    slim.dt = dt
    full = expand(slim, p, src, yp, lam)
    out, dt_field, unstable = gfc(full, meta, p, chem,
                                  aux(start_iter + n_iters - 1),
                                  return_fields=True, ctx=ctx)
    dt_new = torch.clamp_max(dt_field.amin(), 1.0)
    if p.serial_dt_mode:
        dt_new = torch.minimum(dt_new, dt)
    out = store(out.replace(dt=dt_new.to(dtype), y_plus=state.y_plus))
    uns.append(unstable.any())
    return out, {"RMS": torch.stack(rms), "DD_max": torch.stack(ddm),
                 "dt_used": torch.stack([t.reshape(()) for t in dts]),
                 "unstable": torch.stack(uns)}


def y_plus(S, dUdy, dVdx, mu, y_prev, meta, p):
    """ParallelRecalc_y_plus on one domain (deeps2d_core.cpp:1649-1677,
    2260-2322): the friction velocity at every wall gas node, then each
    active node's y+ from its nearest wall node's; ``y_prev`` elsewhere."""
    S0 = S[fl.i2d_Rho]
    ct = meta.CT
    wall = iscond(ct, fl.CT_WALL_NO_SLIP_2D) | iscond(ct, fl.CT_WALL_LAW_2D)
    solid = iscond(ct, fl.CT_SOLID_2D)
    tau_w = (torch.abs(dUdy) + torch.abs(dVdx)) * mu
    rho_s = torch.where(S0 != 0, S0, 1)
    u_w = torch.sqrt(torch.where(S0 != 0, tau_w / rho_s, 0.0) + 1e-30)
    u_map = torch.where(wall & ~solid, u_w, 0.0)
    active = iscond(ct, fl.CT_NODE_IS_SET_2D) & ~solid
    idx = (meta.i_wall.long() * p.MaxY + meta.j_wall.long()).reshape(-1)
    u_at = u_map.reshape(-1)[idx].reshape(S0.shape)
    mu_s = torch.where(mu != 0, mu, 1)
    yp = torch.abs(u_at * meta.l_min * S0 / mu_s)
    return torch.where(active, yp, y_prev)
