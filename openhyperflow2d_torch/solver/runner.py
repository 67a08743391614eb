"""Time-marching loop: the DEEPS2D_Run equivalent on torch.

Counterpart of ``openhyperflow2d_tpu.solver.runner``: an outer cycle of
``Nstep`` inner iterations; the inner iterations run as one chunk (the
eager ``make_fast_chunk`` or the kernel path's ``make_kernel_chunk``; with
a communicator, their X-strip forms ``make_shard_chunk`` and
``make_kernel_shard_chunk`` of parallel/shard_step), and the outer cycle
returns to Python for the host-side bookkeeping, exactly where the
reference does its rank-0 work (deeps2d_core.cpp:512-2023).
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass

import numpy as np
import torch

from ..core import flags as fl
from ..core.physics import fill_node
from ..core.state import meta_from_grid, state_from_grid
from ..core.static_ctx import generic_interior_map, iscond
from ..core.step import make_fast_chunk
from ..ops.fused_step import DEFAULT_DISPATCH, make_kernel_chunk
from ..parallel.multihost import gather_to_host
from ..parallel.shard_step import make_kernel_shard_chunk, make_shard_chunk
from .. import spans
from .init import Case, chem_tables_device


def choose_step_path(device_type: str, dtype: str, uniform_mesh: bool):
    """Step-path selection: the hand-written CUDA kernels run on a CUDA
    device in float32 on a uniform mesh; everything else runs the eager,
    reference-exact path.  Decided from the configuration alone.  Returns
    ``(use_kernels, reason)``.

    This departs from JAX's choose_step_path (solver/runner.py:48-50) on
    purpose: JAX sends multi-device runs to its XLA path, which GSPMD
    shards by itself.  PyTorch has no GSPMD, so the port runs several
    devices (or several strips on one device) as X strips on the kernel
    path (parallel/shard_step), and the device count does not enter."""
    if device_type != "cuda":
        return False, (f"device is {device_type!r}; the kernels are CUDA "
                       f"kernels")
    if str(dtype) != "float32":
        return False, (f"dtype {dtype}: the kernels are float32; float64 "
                       f"runs take the eager path")
    if not uniform_mesh:
        return False, "non-uniform mesh runs on the eager path only"
    return True, "CUDA, float32, uniform mesh"


def check_supported(params) -> None:
    """Raise NotImplementedError for a chemistry model other than Zeldovich
    and none, the two the JAX package has (it runs any other code as no
    reactions); every other feature of a case is ported."""
    if params.chemistry not in (fl.CRM_ZELDOVICH, fl.CRM_NO_REACTIONS):
        raise NotImplementedError(
            f"not ported yet: chemistry model {params.chemistry}")


def _wall_friction(st, m):
    """Friction velocity at the wall gas nodes, 0 elsewhere."""
    S0 = st.S[fl.i2d_Rho]
    ct = m.CT
    wall = iscond(ct, fl.CT_WALL_NO_SLIP_2D) | iscond(ct, fl.CT_WALL_LAW_2D)
    solid = iscond(ct, fl.CT_SOLID_2D)
    tau_w = (torch.abs(st.dUdy) + torch.abs(st.dVdx)) * st.mu
    rho_s = torch.where(S0 != 0, S0, 1)
    u_w = torch.sqrt(torch.where(S0 != 0, tau_w / rho_s, 0.0) + 1e-30)
    return torch.where(wall & ~solid, u_w, 0.0)


def _y_plus(st, m, u_map, Y: int):
    """``st`` with y+ of its active nodes from the friction velocity of
    the whole grid ``u_map`` (rows of Y nodes) at their nearest wall."""
    S0 = st.S[fl.i2d_Rho]
    active = (iscond(m.CT, fl.CT_NODE_IS_SET_2D)
              & ~iscond(m.CT, fl.CT_SOLID_2D))
    idx = (m.i_wall.long() * Y + m.j_wall.long()).reshape(-1)
    u_at = u_map.reshape(-1)[idx].reshape(S0.shape)
    mu_s = torch.where(st.mu != 0, st.mu, 1)
    yp = torch.abs(u_at * m.l_min * S0 / mu_s)
    return st.replace(y_plus=torch.where(active, yp, st.y_plus))


@dataclass
class RunStats:
    iters: int = 0
    steps_per_sec: float = 0.0
    unstable: bool = False
    # kernel path only: a frozen dt exceeded some node's freshly computed
    # CFL limit during the cycle
    dt_overrun: bool = False


class Solver:
    """The solver on one device, or over the X strips of a communicator.

    ``device``: torch device; None means the GPU (``"cuda"``), and raises
    when CUDA is absent.  The CPU runs only when the caller asks for it
    (``device="cpu"``, as the tests do).
    ``use_kernels``: None picks the path with ``choose_step_path``; True or
    False forces the kernel path or the eager path (on CPU tensors the
    kernel path runs the kernels' plain versions).
    ``dispatch``: how the kernel path issues its kernels,
    ``"lists"`` or ``"dual"`` (ops/fused_step.DISPATCH_FORMS); None picks
    ``DEFAULT_DISPATCH``.
    ``comm``: a communicator of parallel/comm (``LocalComm(n, device)``:
    n strips in this process; ``DistComm()``: one strip per
    torch.distributed rank).  The solver then runs the strip path of
    parallel/shard_step on ``comm.device``; ``state`` is a StripState and
    ``host_state()`` gathers it on the primary process.  ``overlap``: the
    kernel strip path's Isend/Irecv -> work -> Wait form.
    ``fuse_iters`` (K; JAX's ``pallas_fuse``): the kernel path runs its
    iterations in blocks of K on one dt, frozen at the block's entry
    (make_pallas_chunk's fuse_iters), so dt lags up to K iterations behind
    the primitives and the ``dt_overrun`` diag flags an iteration whose
    frozen dt exceeds some node's fresh CFL limit; on strips the halo is
    K times as wide and is exchanged once a block.  The eager path has no
    such blocks: there ``fuse_iters > 1`` raises a ValueError, where
    JAX's Solver ignores ``pallas_fuse`` off its Pallas path (the dt
    schedule would silently differ from the one asked for).
    """

    def __init__(self, case: Case, device=None, use_kernels: bool = None,
                 dispatch: str = None, comm=None, overlap: bool = False,
                 fuse_iters: int = 1):
        with spans.span("solver.init"):
            self._setup(case, device, use_kernels, dispatch, comm, overlap,
                        fuse_iters)

    def _setup(self, case, device, use_kernels, dispatch, comm, overlap,
               fuse_iters):
        p = case.params
        check_supported(p)
        if comm is not None:
            if device is not None and \
                    torch.device(device).type != comm.device.type:
                raise ValueError(f"device {device} is not the "
                                 f"communicator's {comm.device}")
            device = comm.device
        if device is None:
            device = "cuda"
        if torch.device(device).type == "cuda" and \
                not torch.cuda.is_available():
            raise RuntimeError(
                "Solver(device=None) runs on the GPU, and CUDA is not "
                "available; pass device=\"cpu\" to run on the CPU")
        self.device = torch.device(device)
        if use_kernels is None:
            use_kernels, self.path_reason = choose_step_path(
                self.device.type, p.dtype, p.uniform_mesh)
        else:
            self.path_reason = "chosen by the caller"
        if use_kernels and not p.uniform_mesh:
            raise NotImplementedError(
                "non-uniform meshes run on the eager path only (the kernels "
                "read the deck's global dx/dy; JAX's Pallas path refuses "
                "them too)")
        if use_kernels:
            self.path_reason += (f"; fuse_iters={fuse_iters} (dt frozen "
                                 f"over blocks of {fuse_iters})")
        elif fuse_iters != 1:
            raise ValueError(f"fuse_iters={fuse_iters}: the eager path runs "
                             f"one dt an iteration; blocks of K iterations "
                             f"on one frozen dt need the kernel path")
        self.use_kernels = use_kernels
        self.fuse_iters = fuse_iters
        self.comm = comm
        self.case = case
        self.params = p
        dtype = p.torch_dtype
        dev = self.device
        self.chem = chem_tables_device(case.chem, dtype, dev)

        def tab(t):
            return (torch.as_tensor(np.asarray(t.x), dtype=dtype, device=dev),
                    torch.as_tensor(np.asarray(t.y), dtype=dtype, device=dev))

        self.beta_tab = tab(case.beta_scenario)
        self.cfl_tab = tab(case.cfl_scenario)
        self.last_iter = 0
        self.global_time = float(case.deck.get_float("InitTime", 0.0,
                                                     required=False))
        # swap-file resume: GlobalTime from node(0,0).time unless the deck
        # overrides it with a positive InitTime (deeps2d_core.cpp:4618-4621)
        if case.preloaded and self.global_time <= 0.0:
            self.global_time = case.preload_time
        self.current_time_part = 0.0
        self.stats = RunStats()
        if comm is not None:
            self._init_strips(case, use_kernels, dispatch, overlap)
            return

        self.meta = meta_from_grid(case.grid, dtype=dtype, device=dev)
        self.state = state_from_grid(case.grid, p, case.dt0, device=dev)
        self._src_ext = torch.as_tensor(case.grid.Src, dtype=dtype,
                                        device=dev)

        # initial FillNode2D(0,1): fluxes + turbulence init, once
        # (deeps2d_core.cpp:4565); skipped on swap-file resume, where the
        # fluxes come from the swap (the first-init loop sits under
        # !PreloadFlag, 4510)
        if not case.preloaded:
            self.state = fill_node(
                self.state, self.meta, p,
                torch.zeros((p.MaxX, p.MaxY), dtype=torch.bool, device=dev),
                is_init=True)

        if use_kernels:
            g = case.grid
            spec_map = generic_interior_map(g.CT, g.TCT, g.idXl, g.idXr,
                                            g.idYu, g.idYd, p)
            self._chunk_fn = make_kernel_chunk(
                self.meta, p, self.chem, self.beta_tab, self.cfl_tab,
                p.TurbStartIter, spec_map=spec_map,
                dispatch=dispatch or DEFAULT_DISPATCH,
                fuse_iters=self.fuse_iters)
            self.fused = self._chunk_fn.step
        else:
            probe_idx = tuple(self._probe_index(mp.x, mp.y)
                              for mp in case.monitor_points)
            self._chunk_fn = make_fast_chunk(
                self.meta, p, self.chem, self.beta_tab, self.cfl_tab,
                p.TurbStartIter, probe_idx=probe_idx)
            self.fused = None

    def _init_strips(self, case, use_kernels, dispatch, overlap):
        """The strip path: the whole grid's meta and initial state stay on
        the host; each strip goes to the communicator's device, where its
        initial FillNode2D runs."""
        p, comm = self.params, self.comm
        self.path_reason += f"; {comm.n} X strips"
        meta = meta_from_grid(case.grid, dtype=p.torch_dtype, device="cpu")
        args = (meta, p, self.chem, self.beta_tab, self.cfl_tab,
                p.TurbStartIter, comm)
        if use_kernels:
            self._chunk_fn = make_kernel_shard_chunk(
                *args, dispatch=dispatch or DEFAULT_DISPATCH,
                overlap=overlap, fuse_iters=self.fuse_iters)
        else:
            self._chunk_fn = make_shard_chunk(*args)
        self.meta = self.fused = None
        # the whole grid's sources stay on the host: each chunk takes its
        # strips' slices (with their halos) to the device
        self._src_ext = torch.tensor(case.grid.Src, dtype=p.torch_dtype)
        host = state_from_grid(case.grid, p, case.dt0, device="cpu")
        self.state = self._chunk_fn.scatter(host)
        if not case.preloaded:
            self.state = self._chunk_fn.fill_init(self.state)

    def set_sources(self, src):
        """Update the volumetric source field (SetSources2D re-applied each
        outer cycle, deeps2d_core.cpp:1716-1722; JAX runner.py:169-182):
        the (9, X, Y) ``src`` (numpy or torch) that every later chunk
        reads, on the strip path each strip's slice with its halos."""
        dev = self.device if self.comm is None else "cpu"
        src = src if isinstance(src, torch.Tensor) else np.asarray(src)
        # a copy: a later apply_sources on the grid's array must not reach
        # the solver before the next set_sources
        self._src_ext = torch.as_tensor(src).to(
            dtype=self.params.torch_dtype, device=dev, copy=True)

    def run_iters(self, n_iters: int):
        """Run ``n_iters`` inner iterations; returns the stacked diagnostics
        as numpy arrays (reading them waits for the device)."""
        with spans.span("solver.chunk", iters=n_iters):
            state, diags = self._chunk_fn(self.state, n_iters,
                                          self.last_iter, self._src_ext)
        self.state = state
        self.last_iter += n_iters
        with spans.span("solver.fetch"):
            diags = {k: v.cpu().numpy() for k, v in diags.items()}
        self.current_time_part += float(diags["dt_used"].sum())
        return diags

    def run_cycle(self):
        """One outer cycle = Nstep inner iterations + host-side bookkeeping.
        Returns (diags, seconds of ``run_iters`` on the monotonic clock
        of the spans)."""
        n = self.case.Nstep
        with spans.span("solver.cycle", cycle=self.last_iter, iters=n):
            t0 = time.perf_counter_ns()
            diags = self.run_iters(n)
            dt_wall = (time.perf_counter_ns() - t0) * 1e-9
            self.global_time += self.current_time_part
            self.current_time_part = 0.0
            self.stats.iters = self.last_iter
            self.stats.steps_per_sec = n / max(dt_wall, 1e-9)
            self.stats.unstable = bool(diags["unstable"].any())
            ovr = diags.get("dt_overrun")
            self.stats.dt_overrun = (bool(ovr.any()) if ovr is not None
                                     else False)
            if self.params.sm == fl.SM_NS and len(self.case.wall_nodes):
                with spans.span("solver.y_plus"):
                    self.recalc_y_plus()
        return diags, dt_wall

    def recalc_y_plus(self):
        """Per-cycle y+ update on the device (ParallelRecalc_y_plus,
        deeps2d_core.cpp:1649-1677 + 2260-2322): friction velocity on every
        wall node, broadcast to every node by its nearest-wall index with
        one flat gather (on the strip path, from the friction velocity of
        every strip, gathered along X)."""
        if self.comm is None:
            st, m = self.state, self.meta
            self.state = _y_plus(st, m, _wall_friction(st, m),
                                 self.params.MaxY)
            return
        metas = self._chunk_fn.own_meta
        strips = self.state.strips
        full = self.comm.all_gather([_wall_friction(st, m)
                                     for st, m in zip(strips, metas)])
        self.state = type(self.state)([
            _y_plus(st, m, u, self.params.MaxY)
            for st, m, u in zip(strips, metas, full)])

    # ------------------------------------------------------------------
    def monitor_condition(self, diags) -> bool:
        """Exit test (deeps2d_core.cpp:1870-1883): continue while true."""
        mi = self.case.MonitorIndex
        emv = self.case.ExitMonitorValue
        rms = np.asarray(diags["RMS"])[-1]     # last iteration of the cycle
        if mi == 5:
            return self.global_time < emv
        if mi == 0:
            return float(rms.max()) > emv
        return float(rms[mi - 1]) > emv

    def max_rms(self, diags):
        rms = np.asarray(diags["RMS"])[-1]
        mi = self.case.MonitorIndex
        if mi == 0 or mi > 4:
            return float(rms.max()), int(rms.argmax())
        return float(rms[mi - 1]), mi - 1

    def host_state(self) -> dict:
        """The dynamic state as numpy arrays, {field: array}; on the strip
        path the strips gathered on the primary process (None on the other
        ranks)."""
        if self.comm is not None:
            return gather_to_host(self.state, self.comm, self.params.MaxX)
        return {k: v.detach().cpu().contiguous().numpy()
                for k, v in self.state.__dict__.items()}

    def recalc_y_plus_host(self):
        """Host (numpy) form of the per-cycle y+ update, the oracle of
        ``recalc_y_plus`` in the tests (JAX runner.py:264-289); returns the
        y+ plane and changes nothing."""
        st = self.host_state()
        wn = self.case.wall_nodes
        iw = wn[:, 0]
        jw = wn[:, 1]
        tau_w = (np.abs(st["dUdy"][iw, jw]) + np.abs(st["dVdx"][iw, jw])) \
            * st["mu"][iw, jw]
        rho_w = st["S"][0][iw, jw]
        u_w = np.sqrt(np.where(rho_w != 0,
                               tau_w / np.where(rho_w != 0, rho_w, 1), 0.0)
                      + 1e-30)
        u_map = np.zeros((self.params.MaxX, self.params.MaxY))
        u_map[iw, jw] = u_w
        g = self.case.grid
        active = (g.is_cond(fl.CT_NODE_IS_SET_2D)
                  & ~g.is_cond(fl.CT_SOLID_2D))
        mu = st["mu"]
        mu_s = np.where(mu != 0, mu, 1)
        l_min = np.asarray(g.l_min).astype(self.params.dtype)
        y_plus = np.abs(u_map[g.i_wall, g.j_wall] * l_min * st["S"][0]
                        / mu_s)
        return np.where(active, y_plus, st["y_plus"])

    def _probe_index(self, x: float, y: float):
        p = self.params
        i = int((x - p.dx * 0.5) / p.dx)
        j = int(y / p.dy)
        return (min(max(i, 0), p.MaxX - 1), min(max(j, 0), p.MaxY - 1))

    def probe_many(self, points):
        """Monitor-point (p, T) of a list of (x, y) probes with one fetch
        to the host a call (deeps2d_core.cpp:1470-1473).  On the strip path
        each probe's strip fills its row and one sum across strips gives
        every rank every row."""
        idx = [self._probe_index(px, py) for (px, py) in points]
        if self.comm is None:
            ii = torch.tensor([i for i, _ in idx], device=self.device)
            jj = torch.tensor([j for _, j in idx], device=self.device)
            vals = torch.stack([self.state.p[ii, jj], self.state.Tg[ii, jj]],
                               1)
        else:
            X_loc = self._chunk_fn.X_loc
            rows = []
            for k, st in zip(self.comm.shards, self.state.strips):
                r = torch.zeros((len(idx), 2), dtype=st.p.dtype,
                                device=st.p.device)
                for n, (i, j) in enumerate(idx):
                    if i // X_loc == k:
                        r[n, 0] = st.p[i % X_loc, j]
                        r[n, 1] = st.Tg[i % X_loc, j]
                rows.append(r)
            vals = self.comm.all_sum(rows)[0]
        return [(float(p_), float(t)) for p_, t in vals.cpu().numpy()]

    def probe(self, x: float, y: float):
        """Single monitor-point (p, T)."""
        return self.probe_many([(x, y)])[0]


def run_case(case: Case, max_cycles: int = None, verbose: bool = True,
             on_cycle=None, **solver_kw):
    """The whole run with the reference's exit semantics (JAX
    runner.py:349-373); ``solver_kw`` go to ``Solver`` (its ``device``
    defaults to the GPU)."""
    solver = Solver(case, **solver_kw)
    cycles = 0
    while True:
        diags, _ = solver.run_cycle()
        cycles += 1
        mrms, k = solver.max_rms(diags)
        if verbose:
            print(f"Cycle {cycles}: iter={solver.last_iter} "
                  f"maxRMS[{k}]={mrms * 100:.5f}% "
                  f"t={solver.global_time:.6f}s "
                  f"({solver.stats.steps_per_sec:.1f} step/sec)")
        if on_cycle is not None:
            on_cycle(solver, diags)
        if solver.stats.unstable:
            print("ERROR: Computational instability (Tg < 0)")
            break
        if not solver.monitor_condition(diags):
            break
        if max_cycles is not None and cycles >= max_cycles:
            break
    return solver


def profile_solver(solver, n_iters: int = 50, trace_dir: str = "hf2d_trace"):
    """Trace the inner loop with torch.profiler (JAX runner.py:375-381):
    ``run_iters(2)`` first (the kernels build and load), then a CPU and,
    on a CUDA solver, CUDA trace of ``run_iters(n_iters)``, written under
    ``trace_dir`` as a Chrome trace; the solver's spans (``spans``) are on
    for the traced call, so the trace shows its steps.  Returns the trace
    file's path."""
    solver.run_iters(2)
    acts = [torch.profiler.ProfilerActivity.CPU]
    dev = solver.device
    if dev.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    was_on = spans.enabled()
    spans.enable()
    try:
        with torch.profiler.profile(activities=acts) as prof:
            solver.run_iters(n_iters)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
    finally:
        if not was_on:
            spans.disable()
    os.makedirs(trace_dir, exist_ok=True)
    path = os.path.join(trace_dir, f"hf2d_trace_{os.getpid()}.json")
    prof.export_chrome_trace(path)
    return path
