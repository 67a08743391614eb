"""X-strip decomposition of the solver over a communicator.

Counterpart of ``openhyperflow2d_tpu/parallel/shard_step.py``: the grid is
cut into ``comm.n`` strips along X, the analog of the reference's MPI
strips with their halo Send/Recv (deeps2d_core.cpp:1336-1399).  Each strip
runs the solver stages on its own columns plus ``halo`` columns on each
side, which it receives from its neighbours, and the dt minimum and the
diag sums go across strips through the communicator (parallel/comm).
The halo is H K columns: H = ``halo_depth`` (the columns one iteration
reads) times the iterations K between two exchanges.

* ``make_shard_chunk`` (shard_step.py:61-253): the eager strip path with
  the reference-exact dt pairing (the dt minimum mid-iteration), and
  ``halo_ablate``, BASELINE.md's halo-overhead method; K = 1, as JAX's.
* ``make_kernel_shard_chunk`` (``make_pallas_shard_chunk(fuse_iters=K)``,
  shard_step.py:256-381): every strip runs the kernel path of
  ops/fused_step (``FusedStep``) over its extended strip, with the
  partials windowed to its own columns, in blocks of K iterations on one
  frozen dt: at a block's entry one dt minimum across strips, then K
  iterations over the extended strips (after iteration i the outer H (i +
  1) columns of each side hold stale values, which never reach the own
  columns), then one exchange of HK columns and one sum and one max
  across strips of the block's K rows.  ``overlap=True`` is the
  reference's Isend/Irecv -> work -> Wait (deeps2d_core.cpp:1336-1409) in
  the GPU's form (``sharded_inner_overlap``, shard_step.py:383-568): the
  block's last pass12 runs first over the tiles next to the halos, their
  exchange is posted, pass12 runs over the other tiles, and the next
  block waits for the exchange.  Each tile runs the same body in both
  forms, so they give the same bits.

Semantics kept from the JAX package: X is padded with zero columns up to a
multiple of n (inactive nodes); the meta is extended once, with CT, TCT
and the neighbour flags zeroed in the halos that wrap around at the global
edges, so the ring's far-end columns are never read; the diag partials
count the own columns only.

The state of this path is a ``StripState``: one SolverState per shard this
process holds, over its own columns.  No process holds the whole grid on
its device: a chunk's prologue ``pass12`` and epilogue ``gfc`` run on each
extended strip after one exchange of the fields they read, the port's form
of JAX's globally sharded arrays (shard_step.py:597, :629).  The kernel
chunk runs them on the kernels, the state forms a single domain's chunk
runs (``KernelShardChunk.start``/``finish`` over ``FusedStep.pack_state``,
``run_prologue``, ``run_epilogue`` and ``end_state``); the eager chunk on
core/step (``_StripChunk.prologue``/``epilogue``).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from ..core.physics import fill_node
from ..core.state import GridMeta, SolverState
from ..core.static_ctx import build_static_ctx, generic_interior_map
from ..core.step import (expand, gfc, has_heat_stage, lead, make_aux,
                         needs_y_plus, pass12, shrink, trail)
from ..ops.fused_step import (SCR_B, SCR_S, FusedStep, carry_views,
                              chunk_diags, fuse_blocks, halo_depth,
                              heat_node_map, is_euler, local_dt,
                              make_tile_plan, pack_carry, rms_of, serial_dt,
                              tile_totals)

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
    static ctx of each strip, the halo exchange and the reductions across
    strips; and the eager path's prologue and epilogue.  ``H`` is
    the halo_depth, ``K`` the iterations between two exchanges, ``halo``
    = H K the halo's columns on each side."""

    def __init__(self, meta: GridMeta, params, chem, beta_tab, cfl_tab,
                 turb_start, comm, fuse_iters: int = 1):
        p = params
        if not p.uniform_mesh:
            raise NotImplementedError("the strip path supports uniform "
                                      "meshes only")
        if int(fuse_iters) < 1:
            raise ValueError(f"fuse_iters must be >= 1, got {fuse_iters}")
        self.params, self.chem, self.comm = p, chem, comm
        self.beta_tab, self.cfl_tab, self.turb_start = (beta_tab, cfl_tab,
                                                        turb_start)
        n, X = comm.n, p.MaxX
        self.H = halo_depth(p)
        self.K = int(fuse_iters)
        self.halo = halo = self.H * self.K
        self.px = (-X) % n
        self.X_loc = (X + self.px) // n
        if self.X_loc < halo:
            raise ValueError(f"{n} strips of {X} columns leave {self.X_loc} "
                             f"a strip, fewer than the halo of {halo} "
                             f"({self.H} columns x {self.K} iterations)")
        self.Xext = self.X_loc + 2 * halo
        self.p_loc = dataclasses.replace(p, MaxX=self.Xext)
        dev = comm.device
        self.meta_ext = [self._extend_meta(meta, k) for k in comm.shards]
        self.ctx = [build_static_ctx(m, self.p_loc) for m in self.meta_ext]
        self.own_meta = [GridMeta(**{f: self.crop(getattr(m, f))
                                     for f in META_FIELDS})
                         for m in self.meta_ext]
        self.zero_src = torch.zeros((9, self.Xext, p.MaxY),
                                    dtype=p.torch_dtype, device=dev)
        self._src_key, self._src = None, [self.zero_src] * len(comm.shards)

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
        H, n, X_loc = self.halo, self.comm.n, self.X_loc
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
        return a[..., self.halo:self.halo + self.X_loc, :]

    def src_ext(self, src) -> list:
        """Each strip's external source field over its extended strip, its
        halos the neighbours' columns around the ring (``ext(src_loc)``,
        shard_step.py:195, 351, 424-427), on the communicator's device;
        the zeros on a deck without sources.  ``src``: the whole grid's
        (9, X, Y) field on any device; sliced again only when another
        tensor comes (Solver.set_sources makes a new one)."""
        if not self.params.has_ext_src or src is self._src_key:
            return self._src
        self._src = [
            self._pad(src).index_select(-2, self._cols(
                k, -self.halo, self.X_loc + self.halo).to(src.device)).to(
                    device=self.comm.device, dtype=self.params.torch_dtype)
            for k in self.comm.shards]
        self._src_key = src
        return self._src

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
        """Each strip's (..., X_loc, Y) block with ``halo`` columns from its
        neighbours on each side (``ext``, shard_step.py:88-99).  ``ablate``:
        each strip's own far columns instead, a same-shaped local slice
        (results wrong at the seams, timing valid; shard_step.py:64-68)."""
        H = self.halo
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
        H, X_loc = self.halo, self.X_loc
        return self.comm.exchange(
            [b[..., H:2 * H, :] for b in bufs],
            [b[..., X_loc:X_loc + H, :] for b in bufs],
            [b[..., :H, :] for b in bufs],
            [b[..., H + X_loc:, :] for b in bufs], async_op=async_op)

    def lam_ext(self, state: StripState, ablate: bool = False) -> list:
        """Each strip's chunk-constant lam_t over its extended strip on an
        Euler deck, its halos from the neighbours (``lam_ext``,
        shard_step.py:163, 342, 391; ``ablate``: as ``extend``); Nones
        under SM_NS, where expand rebuilds lam_t as mu_t*CP."""
        if not is_euler(self.params):
            return [None] * len(state.strips)
        return self.extend([st.lam_t for st in state.strips], ablate)

    def yp_ext(self, state: StripState, ablate: bool = False) -> list:
        """Each strip's chunk-constant y+ over its extended strip where the
        closure reads it (``needs_y_plus``), its halos from the neighbours
        once a chunk (``yp_ext``, shard_step.py:162, 341, 390; ``ablate``:
        as ``extend``); Nones elsewhere (expand's zeros)."""
        if not needs_y_plus(self.params):
            return [None] * len(state.strips)
        return self.extend([st.y_plus for st in state.strips], ablate)

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
        strip's own carry (31, X_loc, Y), pass12 diag).  The eager strip
        path's (ShardChunk), core/step.pass12 on every strip: the plain
        version KernelShardChunk.start is held against (CPU tests,
        chip_smoke.py's check_strip_ends), which no kernel chunk runs."""
        sab = self.extend([torch.cat([st.S, st.A, st.B])
                           for st in state.strips])
        outs, fields = [], []
        aux = self.aux_at(start_iter)
        for st, ext, m, ctx in zip(state.strips, sab, self.meta_ext,
                                   self.ctx):
            kw = {}
            for f in dataclasses.fields(SolverState):
                a = getattr(st, f.name)
                kw[f.name] = (F.pad(a, (0, 0, self.halo, self.halo))
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

    def epilogue(self, ext_carry, dt, state: StripState, it: int,
                 lam=None, yp=None, src=None):
        """gfc of iteration ``it`` (with its heat stage) on each extended
        carry, halos filled; ``lam``, ``yp``, ``src``: the strips'
        ``lam_ext``, ``yp_ext`` and ``src_ext`` (None: made here, src the
        zeros); returns (StripState, dt_new, unstable).  The eager strip
        path's, core/step.gfc on every strip: the plain version
        KernelShardChunk.finish is held against, which no kernel chunk
        runs."""
        if lam is None:
            lam = self.lam_ext(state)
        if yp is None:
            yp = self.yp_ext(state)
        if src is None:
            src = [self.zero_src] * len(ext_carry)
        outs, dts, uns = [], [], []
        aux = self.aux_at(it)
        for c, m, ctx, lam_t, y_plus, src_k in zip(
                ext_carry, self.meta_ext, self.ctx, lam, yp, src):
            full = expand(carry_views(c, dt), self.p_loc, src_k, y_plus,
                          lam_t)
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
        lam = self.lam_ext(state, self.halo_ablate)
        yp = self.yp_ext(state, self.halo_ablate)
        srcs = self.src_ext(src_ext)
        dt = diag0["dt_used"]
        rms, ddm, dts, uns = [], [], [], []
        for k in range(start_iter, start_iter + n_iters - 1):
            ext = self.extend(own, self.halo_ablate)
            aux_g, aux_p = self.aux_at(k), self.aux_at(k + 1)
            outs, local = [], []
            for c, m, ctx, lam_t, y_plus, src_k in zip(
                    ext, self.loop_meta, self.loop_ctx, lam, yp, srcs):
                full = expand(carry_views(c, dt), pl, src_k, y_plus, lam_t)
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
            self.extend(own), dt, state, start_iter + n_iters - 1, src=srcs)
        return out, {"RMS": lead(diag0["RMS"], rms),
                     "dt_used": lead(diag0["dt_used"], dts),
                     "DD_max": lead(diag0["DD_max"], ddm),
                     "unstable": trail(uns, unstable_last)}


class KernelShardChunk(_StripChunk):
    """chunk(state, n_iters, start_iter, src_ext) -> (state', diags) of
    the kernel strip path (make_pallas_shard_chunk(fuse_iters=K)).
    ``steps``: one FusedStep per strip held here, each with its own tile
    plan over the extended strip (its spec map from the strip's extended
    meta, global edges zeroed), the window of its own columns, and its
    edge and inner parts at the halo's width.  Both ends run on the
    kernels (``start``, ``finish``): no core/step stage runs from it on
    CUDA tensors.  The returned strips are views of a call's buffers, and
    every call allocates its own."""

    def __init__(self, *args, dispatch: str = "lists",
                 overlap: bool = False, fuse_iters: int = 1):
        super().__init__(*args, fuse_iters=fuse_iters)
        if overlap and dispatch != "lists":
            raise ValueError("overlap=True splits each body's tile list "
                             "and needs dispatch=\"lists\"")
        if overlap and self.X_loc < 2 * self.halo:
            # shard_step.py:304-309: the two edges a block exchanges must
            # not overlap
            raise ValueError(f"overlap=True needs strips of at least 2 x "
                             f"the halo of {self.halo} columns, got "
                             f"{self.X_loc}; use fewer strips or a smaller "
                             f"fuse_iters")
        self.overlap = overlap
        p, pl = self.params, self.p_loc
        self.steps = []
        for m, ctx in zip(self.meta_ext, self.ctx):
            spec_map = generic_interior_map(*(getattr(m, f).cpu().numpy()
                                              for f in ZERO_EDGE), pl)
            heat_map = heat_node_map(ctx) if has_heat_stage(p) else None
            plan = make_tile_plan(self.Xext, p.MaxY, spec_map,
                                  self.comm.device, heat_map, halo=self.halo)
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

    def start(self, state: StripState, n_iters: int, start_iter: int,
              buffers: bool = False):
        """The prologue on the kernels and the chunk's per-iteration
        scalars.  Each strip's own state is packed over its extended strip
        (``FusedStep.pack_state``, zero halos), the halos of the scratch's
        S, A and B are filled from the neighbours (the planes pass12 reads
        off the node, STAGE_PLANES["pass12"]; the eager prologue exchanges
        the same), pass12's launches run over every tile of each strip
        (``FusedStep.run_prologue``: partials of the own columns only),
        and one sum and one max across strips give its diag.  Returns
        (each strip's extended carry, its halos filled, pass12 diag,
        StepAux of iterations start_iter.., kernel scalar rows rounded
        through float32, as KernelChunk.prologue rounds them); with
        ``buffers`` also (each strip's other carry buffer, its scratch,
        the unrounded rows)."""
        p = self.params
        dtype = p.torch_dtype
        raw = self.aux_at(torch.arange(start_iter, start_iter + n_iters))
        rows = torch.stack([raw.beta_scen, raw.cfl_scen,
                            raw.is_mu_t_iter.to(dtype)], 1)
        packed = [step.pack_state(st, self.halo)
                  for step, st in zip(self.steps, state.strips)]
        self.fill_halos([scr[SCR_S:SCR_B + 9] for _, _, scr, _ in packed])
        part_f = [step.run_prologue(cin, cout, scr, st.dt, rows[0], src)
                  for step, st, (cin, cout, scr, src) in zip(
                      self.steps, state.strips, packed)]
        sums = self.comm.all_sum([torch.cat([f[:, 0:9].sum(0),
                                             f[:, 9:18].sum(0)])
                                  for f in part_f])[0]
        ddm = self.comm.all_max([f[:, 18:27].amax(0) for f in part_f])[0]
        diag0 = {"RMS": rms_of(sums[:9], sums[9:], p), "DD_max": ddm,
                 "dt_used": state.strips[0].dt}
        ca = [cout for _, cout, _, _ in packed]
        self.fill_halos(ca)
        kaux = rows.to(torch.float32).to(dtype)
        if not buffers:
            return ca, diag0, raw, kaux
        return (ca, diag0, raw, kaux, [cin for cin, _, _, _ in packed],
                [scr for _, _, scr, _ in packed], rows)

    def frozen_dt(self, ca, dt_prev, cfl_scen):
        """A block's dt from the extended carries, their halos filled: each
        strip's minimum, then the minimum across strips (scan_dt's
        counterpart)."""
        return self.global_dt([local_dt(carry_views(c, dt_prev), ctx.active,
                                        self.p_loc, cfl_scen)
                               for c, ctx in zip(ca, self.ctx)], dt_prev)

    def block_rows(self, part_f, part_i, kk: int, dt):
        """A block's diag rows from every strip's (K, tiles, ...) partials:
        one sum and one max across strips of its kk rows."""
        p = self.params
        totals = [tile_totals(f[:kk], i[:kk]) for f, i in zip(part_f,
                                                              part_i)]
        sums = self.comm.all_sum([torch.cat(t[:2], -1) for t in totals])[0]
        counts = self.comm.all_sum([t[3] for t in totals])[0]
        ddm = self.comm.all_max([t[2] for t in totals])[0]
        return (rms_of(sums[..., :9], sums[..., 9:], p), ddm,
                counts[..., 0] > 0, counts[..., 1] > 0, dt.expand(kk))

    def stage_planes(self, state: StripState, src_ext=None):
        """Set each strip's chunk-constant planes from ``state`` and the
        chunk's source field (whole grid): lam_t on an Euler deck, y+
        where the closure reads it, the sources, each over its extended
        strip.  Returns them as the eager epilogue takes them (lam, yp,
        src)."""
        lam, yp = self.lam_ext(state), self.yp_ext(state)
        srcs = self.src_ext(src_ext)
        for step, lam_t, y_plus, src_k in zip(self.steps, lam, yp, srcs):
            if lam_t is not None:
                step.set_lam_t(lam_t)
            if y_plus is not None:
                step.set_y_plus(y_plus)
            step.set_src(src_k)
        return lam, yp, srcs

    def finish(self, ca, cb, scr, dt, state: StripState, row):
        """The epilogue on the kernels: each strip's gfc state form over
        every tile of its extended carry ``ca`` (halos filled) with the
        block's ``dt``, then heat_kernel with Q_conv on a strip with the
        heat stage (``FusedStep.run_epilogue``; their partials count the
        own columns only); dt from the least node dt across strips, the
        Tg<0 flag one max across strips; each strip's SolverState cropped
        to its own columns (``FusedStep.end_state``: the strip's own lam_t
        where gfc keeps it, its y+ passed through).  Returns (StripState,
        dt_new, unstable)."""
        ends = [step.run_epilogue(a, b, s, dt, row)
                for step, a, b, s in zip(self.steps, ca, cb, scr)]
        dt_new = self.global_dt([part_dt.amin().clamp_max(1.0)
                                 for _, _, _, part_dt in ends], dt)
        unstable = self.comm.all_max([part_i[:, 0].sum()
                                      for _, _, part_i, _ in ends])[0] > 0
        strips = [step.end_state(a, b, s, st_planes, q_conv, dt_new,
                                 st.lam_t, st.y_plus, crop=self.crop)
                  for step, a, b, s, (st_planes, q_conv, _, _), st in zip(
                      self.steps, ca, cb, scr, ends, state.strips)]
        return StripState(strips), dt_new, unstable

    def __call__(self, state: StripState, n_iters: int, start_iter: int,
                 src_ext=None):
        dtype = self.params.torch_dtype
        ca, diag0, raw, kaux, cb, scr, rows = self.start(
            state, n_iters, start_iter, buffers=True)
        self.stage_planes(state, src_ext)
        dev, K = self.comm.device, self.K
        part_f, part_i = [], []
        for step, s in zip(self.steps, scr):
            # NaN: a value no launch wrote shows where it is read
            s.fill_(float("nan"))
            # slot i holds iteration i of a block
            part_f.append(torch.zeros((K, step.plan.n_tiles, 27),
                                      dtype=dtype, device=dev))
            part_i.append(torch.zeros((K, step.plan.n_tiles, 2),
                                      dtype=torch.int32, device=dev))

        pending = None
        dt = diag0["dt_used"]
        blocks = []
        for b0, kk in fuse_blocks(n_iters, K):
            if pending is not None:
                pending.wait()
            dt = self.frozen_dt(ca, dt, raw.cfl_scen[b0])
            dt_k = dt.to(torch.float32).to(dtype)
            for i, b in enumerate(range(b0, b0 + kk)):
                split = self.overlap and i == kk - 1
                for s, step in enumerate(self.steps):
                    step.path_gfc(ca[s], cb[s], scr[s], dt_k, kaux[b],
                                  part_i[s][i])
                for s, step in enumerate(self.steps):
                    step.path_pass12(ca[s], cb[s], scr[s], dt_k, kaux[b],
                                     kaux[b + 1], part_i[s][i], part_f[s][i],
                                     "edge" if split else None)
                if split:
                    # Isend/Irecv -> work -> Wait: the fresh edge columns
                    # travel while pass12 runs over the inner tiles
                    pending = self.fill_halos(cb, async_op=True)
                    for s, step in enumerate(self.steps):
                        step.path_pass12(ca[s], cb[s], scr[s], dt_k,
                                         kaux[b], kaux[b + 1], part_i[s][i],
                                         part_f[s][i], "inner")
                ca, cb = cb, ca
            if not self.overlap:
                self.fill_halos(ca)
            blocks.append(self.block_rows(part_f, part_i, kk, dt))
        if pending is not None:
            pending.wait()

        out, _, unstable_last = self.finish(ca, cb, scr, dt, state,
                                            rows[-1])
        return out, chunk_diags(diag0, blocks, unstable_last)


def make_shard_chunk(meta: GridMeta, params, chem, beta_tab, cfl_tab,
                     turb_start, comm, halo_ablate: bool = False):
    """The eager strip path (shard_step.py:61-253).  ``meta``: the whole
    grid's GridMeta on any device; each strip's part goes to
    ``comm.device``."""
    return ShardChunk(meta, params, chem, beta_tab, cfl_tab, turb_start,
                      comm, halo_ablate=halo_ablate)


def make_kernel_shard_chunk(meta: GridMeta, params, chem, beta_tab,
                            cfl_tab, turb_start, comm,
                            dispatch: str = "lists", overlap: bool = False,
                            fuse_iters: int = 1):
    """The kernel strip path (make_pallas_shard_chunk(fuse_iters=K),
    shard_step.py:256-381, and its overlapped form, :383-568), with a halo
    of halo_depth x K columns exchanged once a block of K iterations."""
    return KernelShardChunk(meta, params, chem, beta_tab, cfl_tab,
                            turb_start, comm, dispatch=dispatch,
                            overlap=overlap, fuse_iters=fuse_iters)
