"""X-strip decomposition of the solver over a communicator.

Counterpart of ``openhyperflow2d_tpu/parallel/shard_step.py``: the grid is
cut into ``comm.n`` strips along X, the analog of the reference's MPI
strips with their halo Send/Recv (deeps2d_core.cpp:1336-1399).  Each strip
runs the solver stages on its own columns plus H = ``halo_depth`` halo
columns on each side, which it receives from its neighbours every
iteration, and the dt minimum and the diag sums go across strips through
the communicator (parallel/comm).

* ``make_shard_chunk`` (shard_step.py:61-253): the eager strip path with
  the reference-exact dt pairing (the dt minimum mid-iteration), and
  ``halo_ablate``, BASELINE.md's halo-overhead method.
* ``make_kernel_shard_chunk`` (``make_pallas_shard_chunk`` at
  ``fuse_iters=1``, shard_step.py:256-381): every strip runs the kernel
  path of ops/fused_step (``FusedStep``) over its extended strip, with the
  partials windowed to its own columns.  ``overlap=True`` is the
  reference's Isend/Irecv -> work -> Wait (deeps2d_core.cpp:1336-1409) in
  the GPU's form: pass12 runs first over the tiles next to the halos,
  their exchange is posted, pass12 runs over the other tiles, and the next
  gfc waits for the exchange.  Each tile runs the same body in both forms,
  so they give the same bits.

Semantics kept from the JAX package: X is padded with zero columns up to a
multiple of n (inactive nodes); the meta is extended once, with CT, TCT
and the neighbour flags zeroed in the halos that wrap around at the global
edges, so the ring's far-end columns are never read; the diag partials
count the own columns only.

The state of this path is a ``StripState``: one SolverState per shard this
process holds, over its own columns.  No process holds the whole grid on
its device: the prologue ``pass12`` and the epilogue ``gfc`` run on each
extended strip after one exchange of the fields they read, the port's form
of JAX's globally sharded arrays.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from ..core.physics import fill_node
from ..core.state import GridMeta, SolverState
from ..core.static_ctx import build_static_ctx, generic_interior_map
from ..core.step import (StepAux, expand, gfc, has_heat_stage, lead,
                         make_aux, pass12, shrink, trail)
from ..ops.fused_step import (N_CARRY, N_SCRATCH, SCR_SRCADD_E, FusedStep,
                              carry_views, halo_depth, heat_node_map,
                              local_dt, make_tile_plan, pack_carry, rms_of,
                              serial_dt, tile_totals)

META_FIELDS = [f.name for f in dataclasses.fields(GridMeta)
               if f.name not in ("dx_map", "dy_map")]
# zeroed in the halos that wrap around at the global edges
# (shard_step.py:336-340)
ZERO_EDGE = ("CT", "TCT", "idXl", "idXr", "idYu", "idYd")


@dataclass
class StripState:
    """The solver state of the strip path: one SolverState per shard this
    process holds, over the shard's own columns (the last shards also hold
    the zero columns that pad X to a multiple of the shard count)."""
    strips: list


class _StripChunk:
    """What both strip chunks share: the layout, the extended meta and
    static ctx of each strip, the prologue and the epilogue."""

    def __init__(self, meta: GridMeta, params, chem, beta_tab, cfl_tab,
                 turb_start, comm):
        p = params
        if not p.uniform_mesh:
            raise NotImplementedError("the strip path supports uniform "
                                      "meshes only")
        if p.has_ext_src:
            raise NotImplementedError("external sources are not ported")
        self.params, self.chem, self.comm = p, chem, comm
        self.beta_tab, self.cfl_tab, self.turb_start = (beta_tab, cfl_tab,
                                                        turb_start)
        n, X = comm.n, p.MaxX
        self.H = H = halo_depth(p)
        self.px = (-X) % n
        self.X_loc = (X + self.px) // n
        if self.X_loc < H:
            raise ValueError(f"{n} strips of {X} columns leave {self.X_loc} "
                             f"a strip, fewer than the halo of {H}")
        self.Xext = self.X_loc + 2 * H
        self.p_loc = dataclasses.replace(p, MaxX=self.Xext)
        dev = comm.device
        self.meta_ext = [self._extend_meta(meta, k) for k in comm.shards]
        self.ctx = [build_static_ctx(m, self.p_loc) for m in self.meta_ext]
        self.own_meta = [GridMeta(**{f: self.crop(getattr(m, f))
                                     for f in META_FIELDS})
                         for m in self.meta_ext]
        self.zero_src = torch.zeros((9, self.Xext, p.MaxY),
                                    dtype=p.torch_dtype, device=dev)

    # ------------------------------------------------------------------
    # layout
    # ------------------------------------------------------------------
    def _pad(self, a):
        """Zero columns up to a multiple of the shard count (_pad_x,
        shard_step.py:56-58)."""
        return F.pad(a, (0, 0, 0, self.px)) if self.px else a

    def _cols(self, k: int, lo: int, hi: int):
        """Global column indices [k X_loc + lo, k X_loc + hi) of shard k,
        around the ring of the padded grid."""
        Xp = self.X_loc * self.comm.n
        return (torch.arange(lo, hi) + k * self.X_loc) % Xp

    def _extend_meta(self, meta: GridMeta, k: int,
                     ablate: bool = False) -> GridMeta:
        """Shard k's meta over its extended strip; ``ablate``: its own far
        columns in the halos (see ``extend``)."""
        H, n, X_loc = self.H, self.comm.n, self.X_loc
        idx = (torch.cat([self._cols(k, X_loc - H, X_loc),
                          self._cols(k, 0, X_loc), self._cols(k, 0, H)])
               if ablate else self._cols(k, -H, X_loc + H))
        kw = {}
        for f in META_FIELDS:
            src = getattr(meta, f)
            a = self._pad(src).index_select(-2, idx.to(src.device))
            if f in ZERO_EDGE:
                if k == 0:
                    a[..., :H, :] = 0
                if k == n - 1:
                    a[..., -H:, :] = 0
            kw[f] = a.to(self.comm.device)
        return GridMeta(**kw)

    def crop(self, a):
        return a[..., self.H:self.H + self.X_loc, :]

    def scatter(self, state: SolverState) -> StripState:
        """The strips of a whole-grid state (on any device), on the
        communicator's device."""
        strips = []
        for k in self.comm.shards:
            idx = self._cols(k, 0, self.X_loc)
            kw = {}
            for f in dataclasses.fields(SolverState):
                a = getattr(state, f.name)
                if a.dim() >= 2:
                    a = self._pad(a).index_select(-2, idx.to(a.device))
                kw[f.name] = a.to(self.comm.device)
            strips.append(SolverState(**kw))
        return StripState(strips)

    def fill_init(self, state: StripState) -> StripState:
        """The initial FillNode2D(0,1) of each strip (Solver.__init__): a
        pointwise update, with each strip's own static ctx."""
        out = []
        for st, m, ctx in zip(state.strips, self.own_meta, self.ctx):
            own = dataclasses.replace(ctx, **{
                f.name: self.crop(getattr(ctx, f.name))
                for f in dataclasses.fields(ctx)
                if isinstance(getattr(ctx, f.name), torch.Tensor)
                and getattr(ctx, f.name).dim() >= 2})
            mask = torch.zeros(st.U.shape, dtype=torch.bool,
                               device=st.U.device)
            out.append(fill_node(st, m, dataclasses.replace(
                self.params, MaxX=self.X_loc), mask, is_init=True, ctx=own))
        return StripState(out)

    # ------------------------------------------------------------------
    # halos and reductions
    # ------------------------------------------------------------------
    def extend(self, own, ablate: bool = False):
        """Each strip's (..., X_loc, Y) block with H halo columns from its
        neighbours on each side (``ext``, shard_step.py:88-99).  ``ablate``:
        each strip's own far columns instead, a same-shaped local slice
        (results wrong at the seams, timing valid; shard_step.py:64-68)."""
        H = self.H
        left = [a[..., :H, :] for a in own]
        right = [a[..., -H:, :] for a in own]
        if ablate:
            from_left, from_right = right, left
        else:
            from_left, from_right = self.comm.exchange(left, right)
        return [torch.cat([fl, a, fr], -2)
                for fl, a, fr in zip(from_left, own, from_right)]

    def fill_halos(self, bufs, async_op: bool = False):
        """Exchange into the halo columns of extended (..., Xext, Y)
        buffers, in place."""
        H, X_loc = self.H, self.X_loc
        return self.comm.exchange(
            [b[..., H:2 * H, :] for b in bufs],
            [b[..., X_loc:X_loc + H, :] for b in bufs],
            [b[..., :H, :] for b in bufs],
            [b[..., H + X_loc:, :] for b in bufs], async_op=async_op)

    def global_dt(self, local, dt_prev):
        """dt from each strip's local minimum: the minimum across strips,
        then the serial build's monotone rule."""
        return serial_dt(self.comm.all_min(local)[0], dt_prev, self.params)

    def diag_of(self, fields_list):
        """RMS and DD_max of pass12's per-node fields, over the own
        columns of each strip and then across strips
        (shard_step.py:127-144)."""
        p = self.params
        sums, ddms = [], []
        for f in fields_list:
            gate, abs_dd = self.crop(f["gate"]), self.crop(f["abs_dd"])
            tmp, dd_l = self.crop(f["tmp"]), self.crop(f["dd_local"])
            if p.isAlternateRMS:
                acc = abs_dd if p.serial_rms_mode else abs_dd * abs_dd
                num = torch.where(gate, acc, 0.0).sum((-2, -1))
                den = torch.where(gate, tmp * tmp, 0.0).sum((-2, -1))
            else:
                num = torch.where(gate, dd_l * dd_l, 0.0).sum((-2, -1))
                den = gate.sum((-2, -1)).to(num.dtype)
            sums.append(torch.cat([num, den]))
            ddms.append(torch.where(gate, dd_l, 0.0).amax((-2, -1)))
        s = self.comm.all_sum(sums)[0]
        return rms_of(s[:9], s[9:], p), self.comm.all_max(ddms)[0]

    def any_own(self, masks):
        """Whether any strip has a set node in its own columns."""
        return self.comm.all_max([self.crop(m).any().to(torch.int32)
                                  for m in masks])[0] > 0

    # ------------------------------------------------------------------
    # prologue and epilogue
    # ------------------------------------------------------------------
    def aux_at(self, it):
        return make_aux(self.beta_tab, self.cfl_tab, self.turb_start, it,
                        self.params.torch_dtype)

    def prologue(self, state: StripState, start_iter: int):
        """pass12 of iteration start_iter on each extended strip, after one
        exchange of S, A and B (what it reads at the neighbours); the other
        fields' halos are zero (read at the node only).  Returns (each
        strip's own carry (31, X_loc, Y), pass12 diag)."""
        sab = self.extend([torch.cat([st.S, st.A, st.B])
                           for st in state.strips])
        outs, fields = [], []
        aux = self.aux_at(start_iter)
        for st, ext, m, ctx in zip(state.strips, sab, self.meta_ext,
                                   self.ctx):
            kw = {}
            for f in dataclasses.fields(SolverState):
                a = getattr(st, f.name)
                kw[f.name] = (F.pad(a, (0, 0, self.H, self.H))
                              if a.dim() >= 2 else a)
            kw.update(S=ext[0:9], A=ext[9:18], B=ext[18:27])
            S_c, beta_c, _, _, f = pass12(SolverState(**kw), m, self.p_loc,
                                          aux, return_fields=True, ctx=ctx)
            outs.append(pack_carry(shrink(st.replace(
                S=self.crop(S_c), beta=self.crop(beta_c)))))
            fields.append(f)
        rms, ddm = self.diag_of(fields)
        dt = state.strips[0].dt
        return outs, {"RMS": rms, "DD_max": ddm, "dt_used": dt}

    def epilogue(self, ext_carry, dt, state: StripState, it: int):
        """gfc of iteration ``it`` (with its heat stage) on each extended
        carry, halos filled; returns (StripState, dt_new, unstable)."""
        outs, dts, uns = [], [], []
        aux = self.aux_at(it)
        for c, m, ctx in zip(ext_carry, self.meta_ext, self.ctx):
            full = expand(carry_views(c, dt), self.p_loc, self.zero_src)
            out, dt_field, unstable = gfc(full, m, self.p_loc, self.chem,
                                          aux, return_fields=True, ctx=ctx)
            outs.append(out)
            dts.append(torch.clamp_max(self.crop(dt_field).amin(), 1.0))
            uns.append(unstable)
        dt_new = self.global_dt(dts, dt)
        strips = []
        for out, st in zip(outs, state.strips):
            kw = {f.name: (self.crop(getattr(out, f.name))
                           if getattr(out, f.name).dim() >= 2
                           else getattr(out, f.name))
                  for f in dataclasses.fields(SolverState)}
            # beta passes through gfc as a view of the carry
            kw.update(dt=dt_new, y_plus=st.y_plus, beta=kw["beta"].clone())
            strips.append(SolverState(**kw))
        return StripState(strips), dt_new, self.any_own(uns)


class ShardChunk(_StripChunk):
    """chunk(state, n_iters, start_iter, src_ext) -> (state', diags) of
    the eager strip path (make_shard_chunk)."""

    def __init__(self, *args, halo_ablate: bool = False):
        super().__init__(*args)
        self.halo_ablate = halo_ablate
        # the loop's meta and ctx: with halo_ablate, JAX extends the meta
        # with the same local slices (shard_step.py:88-92, 154-158); the
        # prologue and the epilogue keep the real ones, as JAX runs them on
        # the global grid
        self.loop_meta, self.loop_ctx = self.meta_ext, self.ctx
        if halo_ablate:
            meta = args[0]
            self.loop_meta = [self._extend_meta(meta, k, ablate=True)
                              for k in self.comm.shards]
            self.loop_ctx = [build_static_ctx(m, self.p_loc)
                             for m in self.loop_meta]

    def __call__(self, state: StripState, n_iters: int, start_iter: int,
                 src_ext=None):
        p, pl = self.params, self.p_loc
        own, diag0 = self.prologue(state, start_iter)
        dt = diag0["dt_used"]
        rms, ddm, dts, uns = [], [], [], []
        for k in range(start_iter, start_iter + n_iters - 1):
            ext = self.extend(own, self.halo_ablate)
            aux_g, aux_p = self.aux_at(k), self.aux_at(k + 1)
            outs, local = [], []
            for c, m, ctx in zip(ext, self.loop_meta, self.loop_ctx):
                full = expand(carry_views(c, dt), pl, self.zero_src)
                out, dt_field, unstable = gfc(full, m, pl, self.chem, aux_g,
                                              return_fields=True, ctx=ctx)
                outs.append((out, unstable))
                local.append(torch.clamp_max(self.crop(dt_field).amin(),
                                             1.0))
            dt = self.global_dt(local, dt)
            own, fields = [], []
            for (out, _), m, ctx in zip(outs, self.loop_meta, self.loop_ctx):
                out = out.replace(dt=dt)
                S_c, beta_c, _, _, f = pass12(out, m, pl, aux_p,
                                              return_fields=True, ctx=ctx)
                own.append(self.crop(pack_carry(shrink(out.replace(
                    S=S_c, beta=beta_c)))))
                fields.append(f)
            r, d = self.diag_of(fields)
            rms.append(r)
            ddm.append(d)
            dts.append(dt)
            uns.append(self.any_own([u for _, u in outs]))
        out, _, unstable_last = self.epilogue(
            self.extend(own), dt, state, start_iter + n_iters - 1)
        return out, {"RMS": lead(diag0["RMS"], rms),
                     "dt_used": lead(diag0["dt_used"], dts),
                     "DD_max": lead(diag0["DD_max"], ddm),
                     "unstable": trail(uns, unstable_last)}


class KernelShardChunk(_StripChunk):
    """chunk(state, n_iters, start_iter, src_ext) -> (state', diags) of
    the kernel strip path (make_pallas_shard_chunk at fuse_iters=1).
    ``steps``: one FusedStep per strip held here, each with its own tile
    plan over the extended strip (its spec map from the strip's extended
    meta, global edges zeroed) and the window of its own columns."""

    def __init__(self, *args, dispatch: str = "lists",
                 overlap: bool = False):
        super().__init__(*args)
        if overlap and dispatch != "lists":
            raise ValueError("overlap=True splits each body's tile list "
                             "and needs dispatch=\"lists\"")
        self.overlap = overlap
        p, pl = self.params, self.p_loc
        self.steps = []
        for m, ctx in zip(self.meta_ext, self.ctx):
            spec_map = generic_interior_map(*(getattr(m, f).cpu().numpy()
                                              for f in ZERO_EDGE), pl)
            heat_map = heat_node_map(ctx) if has_heat_stage(p) else None
            plan = make_tile_plan(self.Xext, p.MaxY, spec_map,
                                  self.comm.device, heat_map, halo=self.H)
            self.steps.append(FusedStep(m, pl, self.chem, plan, dispatch,
                                        ctx))

    @property
    def launches(self) -> dict:
        """Launches per kernel instantiation, summed over the strips."""
        out = {}
        for s in self.steps:
            for k, v in s.launches.items():
                out[k] = out.get(k, 0) + v
        return out

    def reset_launches(self) -> None:
        for s in self.steps:
            s.reset_launches()

    def start(self, state: StripState, n_iters: int, start_iter: int):
        """The prologue and the chunk's per-iteration scalars: (each strip's
        extended carry, its halos filled, pass12 diag, StepAux of iterations
        start_iter.., kernel scalar rows rounded through float32, as
        KernelChunk.prologue rounds them)."""
        dtype = self.params.torch_dtype
        own, diag0 = self.prologue(state, start_iter)
        raw = self.aux_at(torch.arange(start_iter, start_iter + n_iters))
        kaux = torch.stack([raw.beta_scen, raw.cfl_scen,
                            raw.is_mu_t_iter.to(dtype)], 1)
        ca = [F.pad(c, (0, 0, self.H, self.H)) for c in own]
        self.fill_halos(ca)
        return ca, diag0, raw, kaux.to(torch.float32).to(dtype)

    def frozen_dt(self, ca, dt_prev, cfl_scen):
        """The iteration's dt from the extended carries: each strip's
        minimum, then the minimum across strips (scan_dt's counterpart)."""
        return self.global_dt([local_dt(carry_views(c, dt_prev), ctx.active,
                                        self.p_loc, cfl_scen)
                               for c, ctx in zip(ca, self.ctx)], dt_prev)

    def __call__(self, state: StripState, n_iters: int, start_iter: int,
                 src_ext=None):
        p, dtype = self.params, self.params.torch_dtype
        ca, diag0, raw, kaux = self.start(state, n_iters, start_iter)
        dev, Y = self.comm.device, p.MaxY
        cb = [torch.empty_like(c) for c in ca]
        scr, part_f, part_i = [], [], []
        for step in self.steps:
            s = torch.empty((N_SCRATCH, self.Xext, Y), dtype=dtype,
                            device=dev)
            s[SCR_SRCADD_E].zero_()
            scr.append(s)
            part_f.append(torch.zeros((step.plan.n_tiles, 27), dtype=dtype,
                                      device=dev))
            part_i.append(torch.zeros((step.plan.n_tiles, 2),
                                      dtype=torch.int32, device=dev))

        pending = None
        dt = diag0["dt_used"]
        rms, ddm, dts, uns, ovr = [], [], [], [], []
        for b in range(n_iters - 1):
            if pending is not None:
                pending.wait()
            dt = self.frozen_dt(ca, dt, raw.cfl_scen[b])
            dt_k = dt.to(torch.float32).to(dtype)
            for s, step in enumerate(self.steps):
                step.gfc(ca[s], cb[s], scr[s], dt_k, kaux[b], part_i[s])
                if step.has_heat:
                    step.heat(cb[s], scr[s], dt_k)
            for s, step in enumerate(self.steps):
                step.pass12(ca[s], cb[s], scr[s], dt_k, kaux[b + 1],
                            part_f[s], "edge" if self.overlap else None)
            if self.overlap:
                # Isend/Irecv -> work -> Wait: the fresh edge columns travel
                # while pass12 runs over the inner tiles
                pending = self.fill_halos(cb, async_op=True)
                for s, step in enumerate(self.steps):
                    step.pass12(ca[s], cb[s], scr[s], dt_k, kaux[b + 1],
                                part_f[s], "inner")
            totals = [tile_totals(f, i) for f, i in zip(part_f, part_i)]
            sums = self.comm.all_sum([torch.cat(t[:2]) for t in totals])[0]
            counts = self.comm.all_sum([t[3] for t in totals])[0]
            rms.append(rms_of(sums[:9], sums[9:], p))
            ddm.append(self.comm.all_max([t[2] for t in totals])[0])
            uns.append(counts[0] > 0)
            ovr.append(counts[1] > 0)
            dts.append(dt)
            ca, cb = cb, ca
            if not self.overlap:
                self.fill_halos(ca)
        if pending is not None:
            pending.wait()

        out, _, unstable_last = self.epilogue(ca, dt, state,
                                              start_iter + n_iters - 1)
        return out, {
            "RMS": lead(diag0["RMS"], rms),
            "dt_used": lead(diag0["dt_used"], dts),
            "DD_max": lead(diag0["DD_max"], ddm),
            "unstable": trail(uns, unstable_last),
            # the epilogue gfc computes a fresh dt (no freeze)
            "dt_overrun": trail(ovr, torch.zeros((), dtype=torch.bool,
                                                 device=dev)),
        }


def make_shard_chunk(meta: GridMeta, params, chem, beta_tab, cfl_tab,
                     turb_start, comm, halo_ablate: bool = False):
    """The eager strip path (shard_step.py:61-253).  ``meta``: the whole
    grid's GridMeta on any device; each strip's part goes to
    ``comm.device``."""
    return ShardChunk(meta, params, chem, beta_tab, cfl_tab, turb_start,
                      comm, halo_ablate=halo_ablate)


def make_kernel_shard_chunk(meta: GridMeta, params, chem, beta_tab,
                            cfl_tab, turb_start, comm,
                            dispatch: str = "lists", overlap: bool = False):
    """The kernel strip path (make_pallas_shard_chunk at fuse_iters=1,
    shard_step.py:256-381, and its overlapped form, :383-568)."""
    return KernelShardChunk(meta, params, chem, beta_tab, cfl_tab,
                            turb_start, comm, dispatch=dispatch,
                            overlap=overlap)
