"""Command-line entry point: the hf2d_start equivalent on PyTorch.

Usage::

    python -m openhyperflow2d_torch.cli <deck.dat> [options]

Counterpart of ``openhyperflow2d_tpu/cli.py``: it runs the deck with the
reference's outer-cycle structure (hf2d_start.cpp:32-368 and the rank-0
work of DEEPS2D_Run, deeps2d_core.cpp:1716-1848).  Every cycle of Nstep
inner iterations it reports the XCut mass flow, appends the Tecplot
transient file, rewrites the snapshot, writes RMS and monitor rows, saves
heat-flux profiles and Cx/Cy, re-applies the deck's volumetric sources
(SetSources2D, after their StartIter), checkpoints and evaluates the exit
monitor, with the JAX CLI's file names and printed lines.

It runs on the GPU unless ``--device cpu``.  ``--pallas`` is the kernel
path (the hand-written CUDA kernels, ops/fused_step), chosen by default by
``choose_step_path`` (CUDA, float32, uniform mesh); ``--devices N`` runs N
X strips in this process (``LocalComm``); under ``torchrun`` (WORLD_SIZE >
1) one strip a rank over ``torch.distributed`` (``DistComm``), the primary
rank writing the files.  ``--swap`` (default on, as in the JAX CLI)
resumes from ``<outdir>/<Project>.hf2d`` when it is there with the grid's
size, and rewrites it every outer cycle; ``--no-swap`` turns both off.  Not
taken from the JAX CLI: ``--pallas-tile`` (a TPU tile; the CUDA tile is
fixed) and ``--coordinator`` (torchrun's environment stands in for it).
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="openhyperflow2d-torch",
        description="2D compressible flow solver on PyTorch and CUDA "
                    "(deck-compatible with OpenHyperFLOW2D)")
    ap.add_argument("deck", help="project deck file (.dat)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the solver runs (default: the GPU)")
    ap.add_argument("--dtype", default=None,
                    help="float32|float64 (default: float32 on the GPU, "
                    "float64 on the CPU)")
    ap.add_argument("--max-cycles", type=int, default=None)
    ap.add_argument("--serial-dt", action="store_true",
                    help="replicate the serial reference's monotone dt")
    ap.add_argument("--devices", type=int, default=1,
                    help="run N X strips in this process (parallel/comm "
                    "LocalComm); under torchrun one strip a rank")
    ap.add_argument("--outdir", default=".")
    ap.add_argument("--restore", default=None,
                    help="checkpoint file to resume from")
    ap.add_argument("--pallas", default=None,
                    action=argparse.BooleanOptionalAction,
                    help="the kernel path (the CUDA kernels; dt lags up to "
                    "--fuse iterations).  Default: auto, ON for CUDA "
                    "float32 uniform-mesh runs, OFF otherwise "
                    "(--no-pallas forces the eager path)")
    ap.add_argument("--fuse", type=int, default=8,
                    help="iterations a block of the kernel path runs on one "
                    "frozen dt (Solver(fuse_iters=)); the eager path runs "
                    "one dt an iteration")
    ap.add_argument("--fast-math", action="store_true",
                    help="reciprocal-multiply transforms (ulp-level "
                    "rounding changes)")
    ap.add_argument("--swap", default=True,
                    action=argparse.BooleanOptionalAction,
                    help="reference .hf2d swap-file semantics: auto-resume "
                    "from <outdir>/<Project>.hf2d when present, sync it "
                    "every outer cycle (--no-swap disables)")
    args = ap.parse_args(argv)

    from .config.deck import load_deck
    from .geometry.sources import apply_sources
    from .io_out.host import host_view
    from .io_out.swapfile import write_swap_file
    from .io_out.tecplot import (save_data_2d, save_monitors_header,
                                 save_monitors_row, save_rms_header,
                                 save_rms_rows)
    from .parallel.comm import LocalComm
    from .parallel.multihost import init_distributed, is_primary
    from .postproc.outcfd import (calc_mass_flow_rate_x, save_x_heat_flux,
                                  save_y_heat_flux)
    from .solver.checkpoint import load_checkpoint, save_checkpoint
    from .solver.init import build_case
    from .solver.runner import Solver, choose_step_path

    dtype = args.dtype or ("float64" if args.device == "cpu" else "float32")
    os.makedirs(args.outdir, exist_ok=True)
    print(f"Load {args.deck!r} ...", flush=True)
    deck = load_deck(args.deck)
    case = build_case(deck, dtype=dtype, serial_dt_mode=args.serial_dt,
                      use_swap=args.swap, swap_dir=args.outdir)
    name = case.project_name or "out"
    print(f"X={case.params.MaxX} Y={case.params.MaxY} "
          f"dx={case.params.dx} dy={case.params.dy} dtype={dtype}")
    if case.preloaded:
        print(f"Mapping computation area from {case.swap_path!r} "
              f"(PreloadFlag=1, GlobalTime={case.preload_time:.6g})")

    if args.fast_math:
        import dataclasses
        case.params = dataclasses.replace(case.params, fast_math=True)
    comm = None
    if int(os.environ.get("WORLD_SIZE", "1")) > 1:
        comm = init_distributed("nccl" if args.device == "cuda" else "gloo")
    elif args.devices > 1:
        comm = LocalComm(args.devices, args.device)
    use_kernels = args.pallas
    if use_kernels is None:
        # auto path selection: one hot loop a deck, like the reference
        # (deeps2d_core.cpp:512); prints the reason
        use_kernels, why = choose_step_path(args.device, dtype,
                                            case.params.uniform_mesh)
        print(f"step path: {'CUDA kernels' if use_kernels else 'eager'} "
              f"({why})")
    solver = Solver(case, device=args.device, use_kernels=use_kernels,
                    comm=comm, fuse_iters=args.fuse if use_kernels else 1)
    primary = is_primary()
    if comm is not None and primary:
        print(f"{comm.n} X strips ({type(comm).__name__})")

    ckpt_path = os.path.join(args.outdir, f"{name}.ckpt.npz")
    if args.restore:
        load_checkpoint(args.restore, solver)
        print(f"restored from {args.restore}: iter={solver.last_iter} "
              f"t={solver.global_time}")

    def snapshot_cp(st):
        # per-node Calc_Cp for the final snapshot column when is_Cx_calc
        # (deeps2d_core.cpp:2664-2668)
        if not case.is_Cx_calc:
            return None
        from .postproc.outcfd import calc_cp
        fl2 = case.flow2d_list[case.Cx_params["Cx_Flow_index"] - 1]
        return calc_cp(st, case.grid, fl2)

    rms_path = os.path.join(args.outdir, f"RMS-{name}")
    mon_path = os.path.join(args.outdir, f"Monitors-{name}")
    # OutFileName = ProjectName + OutputFile; TecPlotFileName = "tp-" +
    # OutFileName; ErrFileName = ProjectName + ErrorFile
    # (deeps2d_core.cpp:2884-2887)
    plt_path = os.path.join(args.outdir, f"{name}{case.output_suffix}")
    tp_path = os.path.join(args.outdir, f"tp-{name}{case.output_suffix}")
    if primary:
        save_rms_header(rms_path)
        if case.monitor_points:
            save_monitors_header(mon_path, len(case.monitor_points))

    cycles = 0
    while True:
        diags, secs = solver.run_cycle()
        cycles += 1
        mrms, k = solver.max_rms(diags)
        if case.isVerboseOutput and primary:
            # per-NOutStep step log (deeps2d_core.cpp:1603-1637) from the
            # per-iteration diag history; step_time/step-rate are the
            # cycle averages (the whole cycle is one chunk)
            rms_h = np.asarray(diags["RMS"])
            dts_h = np.asarray(diags["dt_used"])
            it0 = solver.last_iter - rms_h.shape[0]
            names = ["Rho", "RhoU", "RhoV", "RhoE", "RhoYfu", "RhoYox",
                     "RhoYcp", "k", "eps"]
            rate = solver.stats.steps_per_sec
            d_time = case.NOutStep / max(rate, 1e-9)
            for it in range(0, rms_h.shape[0], case.NOutStep):
                mi = case.MonitorIndex
                if 0 < mi < 5:
                    kk = mi - 1
                else:
                    kk = int(rms_h[it][:4].argmax())
                print(f"Step No {it0 + it} maxRMS[{names[kk]}]="
                      f"{rms_h[it][kk] * 100:.6g} % step_time="
                      f"{d_time:.6g} sec ({rate:.6g} step/sec) "
                      f"dt={dts_h[it]:.6g}", flush=True)
        if primary:
            print(f"Cycle {cycles}: iter={solver.last_iter} "
                  f"maxRMS[{k}]={mrms * 100:.4f}% "
                  f"t={solver.global_time:.6g}s "
                  f"({solver.stats.steps_per_sec:.1f} step/sec)",
                  flush=True)
        if solver.stats.dt_overrun and primary:
            print("WARNING: frozen dt exceeded the per-node CFL limit "
                  "during this cycle (fused-path dt lag); consider a "
                  "smaller --fuse or CFL", flush=True)

        # rank-0 outer-cycle work (deeps2d_core.cpp:1716-1848); the
        # sources, re-applied, switch on after their StartIter
        if case.sources:
            apply_sources(case.grid, case.sources, solver.last_iter)
            solver.set_sources(case.grid.Src)
        fields = solver.host_state()   # a collective on the strip path
        # every rank reads the monitor probes (a sum across strips)
        probes = (solver.probe_many([(mp.x, mp.y)
                                     for mp in case.monitor_points])
                  if case.monitor_points and "probes" not in diags
                  else None)
        if not primary:
            # the other ranks only take part in collectives and the exit
            # test
            if solver.stats.unstable:
                return 1
            if not solver.monitor_condition(diags):
                break
            if args.max_cycles and cycles >= args.max_cycles:
                break
            continue
        st = host_view(fields)
        for (x0, y0, dyc) in case.xcuts:
            mp = calc_mass_flow_rate_x(case.grid, st, x0, y0, dyc)
            print(f"XCut x0={x0} y0={y0} dy={dyc}: mass flow {mp:.6g} kg/s")
        rms_hist = np.asarray(diags["RMS"])
        save_rms_rows(rms_path, solver.last_iter - rms_hist.shape[0],
                      rms_hist, every=case.NOutStep)
        if case.is_Cx_calc:
            # Cx/Cy plus raw Fx/Fy forces (deeps2d_core.cpp:1810-1812)
            from .postproc.outcfd import (calc_cx, calc_cy, calc_x_force,
                                          calc_y_force)
            cp = case.Cx_params
            fl2 = case.flow2d_list[cp["Cx_Flow_index"] - 1]
            body = (cp["x0_body"], cp["y0_body"], cp["dx_body"],
                    cp["dy_body"])
            cx = calc_cx(case.grid, st, *body, fl2)
            cy = calc_cy(case.grid, st, *body, fl2)
            fx = calc_x_force(case.grid, st, *body)
            fy = calc_y_force(case.grid, st, *body)
            print(f"Cx = {cx:.6g} Cy = {cy:.6g} "
                  f"Fx = {fx:.6g} Fy = {fy:.6g}")
        if case.is_Cd_calc:
            from .postproc.outcfd import calc_cd, calc_cv
            cp = case.Cx_params
            fl2 = case.flow2d_list[cp["Cd_Flow_index"] - 1]
            cd = calc_cd(case.grid, st, cp["x0_nozzle"], cp["y0_nozzle"],
                         cp["dy_nozzle"], fl2)
            cv = calc_cv(case.grid, st, cp["x0_nozzle"], cp["y0_nozzle"],
                         cp["dy_nozzle"], cp["p_ambient"], fl2)
            print(f"Cd={cd:.6g} Cv={cv:.6g}")
        if case.monitor_points:
            if probes is None:
                # per-NOutStep rows (deeps2d_core.cpp:1603-1637, 2560-2569)
                # from the probes the eager chunk captured
                pr = np.asarray(diags["probes"])
                dts = np.asarray(diags["dt_used"])
                tcum = (solver.global_time - dts.sum()) + np.cumsum(dts)
                for it in range(0, pr.shape[0], case.NOutStep):
                    save_monitors_row(
                        mon_path, float(tcum[it]),
                        [(row[0], row[1]) for row in pr[it]])
            else:
                # the kernel and strip paths: one row an outer cycle
                save_monitors_row(mon_path, solver.global_time, probes)
        if cycles % max(case.NSaveStep, 1) == 0:
            cp_arr = snapshot_cp(st)
            save_data_2d(plt_path, case.grid, st, case.params,
                         solver.global_time, mode_append=False,
                         is_p_asterisk_out=case.is_p_asterisk_out,
                         cp_arr=cp_arr)
            save_data_2d(tp_path, case.grid, st, case.params,
                         solver.global_time, mode_append=(cycles > 1),
                         is_p_asterisk_out=case.is_p_asterisk_out,
                         cp_arr=cp_arr)
        if case.isOutHeatFluxX and case.flow2d_list:
            # normalization flow + wall-scan window from the deck keys
            # Cp_Flow_Index / y_max / y_min (deeps2d_core.cpp:1796,
            # 2894-2902)
            hp = case.heatflux_params
            save_x_heat_flux(os.path.join(args.outdir, f"HeatFlux-X-{name}"),
                             case.grid, st,
                             case.flow2d_list[hp["Cp_Flow_index"] - 1],
                             case.params.Ts0, hp["y_max"], hp["y_min"])
        if case.isOutHeatFluxY:
            save_y_heat_flux(os.path.join(args.outdir, f"HeatFlux-Y-{name}"),
                             case.grid, st, case.params.Ts0)
        save_checkpoint(ckpt_path, solver, st=fields)
        if args.swap and case.swap_path:
            # per-cycle swap sync (deeps2d_core.cpp:1818-1848)
            write_swap_file(case.swap_path, solver, case.grid, st=fields)

        if solver.stats.unstable:
            err_path = os.path.join(args.outdir, f"{name}{case.error_suffix}")
            save_data_2d(err_path, case.grid, st, case.params,
                         solver.global_time,
                         is_p_asterisk_out=case.is_p_asterisk_out,
                         cp_arr=snapshot_cp(st))
            print(f"ERROR: Computational instability (Tg < 0); error "
                  f"snapshot saved to {err_path}")
            return 1
        if not solver.monitor_condition(diags):
            break
        if args.max_cycles and cycles >= args.max_cycles:
            break

    fields = solver.host_state()      # a collective on the strip path
    if primary:
        st = host_view(fields)
        save_data_2d(plt_path, case.grid, st, case.params,
                     solver.global_time,
                     is_p_asterisk_out=case.is_p_asterisk_out,
                     cp_arr=snapshot_cp(st))
        print(f'Results saved in file "{plt_path}".\n\n'
              f"Ready. Computation finished.")
    return 0


if __name__ == "__main__":
    sys.exit(main())
