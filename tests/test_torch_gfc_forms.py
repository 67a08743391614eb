"""gfc's extended kernels: their feature forms, the chemistry tables'
coefficient block and the three F planes they write.

(i) gfc_ext_kernel comes in two forms fixed at compile time
(``ops/csrc/fused_step.cuh`` XF_AXI / XF_ALL; ``ops/fused_step.gfc_form``
on the host, ``hf2d_gfc_ext`` in C, from the same flags): the
axisymmetric-only form ``gfc_axi_kernel`` (also on the d2/NRBC deck: d2
and NRBC are pass12's) and the all-features form ``gfc_ext_kernel`` with
sources; the closures' and the Euler gfc keep one extended form each.
Each extended deck picks the kernel chip_smoke.py expects of it
(EXT_FORMS), a name among EXT_KERNEL_NAMES, and a deck with neither
feature has no form.

(ii) ``pack_chem`` appends, after what the flat kernels read, each
ascending table's (x0, y0, m1) and for s >= 2 (x_{s-1}, m_s - m_{s-1}),
m_s = (y_s - y_{s-1}) / (x_s - x_{s-1}) in float32: the floats
table_lookup computes at every node, so the extended kernels and the
closures' flat ones read them once per CTA.  Held bit for bit on the
combustor's, the bubble's and the flat SA channel's tables and on ascending tables of 2-16 knots made from a numpy seed;
the prefix is unchanged; a table of one knot or not ascending carries no
coefficients.

(iii) The kernel path's plain gfc writes F[2], F[7] and F[8] only (the
other six are the A and B floats pass12 reads at the node, radial_fluxes,
which equal the eager gfc's F bit for bit), and pass12's plain version
gives the same bits from that scratch (the six planes NaN) as from one
whose nine F planes hold the eager gfc's F.
"""

import dataclasses
import functools
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch_parity import axisymmetric

from openhyperflow2d_torch import examples as ex
from openhyperflow2d_torch.core import flags as fl
from openhyperflow2d_torch.core.state import (_CHEM_PROPS, _CHEM_SPECIES,
                                              ChemTables)
from openhyperflow2d_torch.core.step import expand, gfc
from openhyperflow2d_torch.ops.fused_step import (EXT_KERNEL_NAMES, F_OWN,
                                                  SCR_F, carry_views,
                                                  gfc_form, n_scratch,
                                                  pack_chem, radial_fluxes,
                                                  scan_dt)
from openhyperflow2d_torch.solver.init import build_case
from openhyperflow2d_torch.solver.runner import Solver

N_TABLES = 12


def nrbc_d2_deck():
    """The JAX package's _nrbc_d2_axisym_deck (tests/test_static_ctx.py:
    25-37) with the port's examples."""
    d = ex.channel_deck(nx=48, ny=40, problem_type=1, turb_model=4,
                        turb_ext_model=0, flow_type=1)
    d.data["Contour1.Bound1.Cond"] = "NT_FARFIELD_2D"
    d.data["Contour1.Bound2.Cond"] = ("NT_D2X_2D, TCT_dkdx_NULL_2D, "
                                      "TCT_depsdx_NULL_2D")
    d.data["Contour1.Bound3.Cond"] = ("NT_D0Y_2D, NT_D2Y_2D, "
                                      "TCT_k_CONST_2D, TCT_eps_CONST_2D")
    return d


# the extended decks: (deck, the k-eps variant to set, gfc's kernel,
# gfc_form where gfc runs gfc_ext_kernel's forms)
DECKS = {
    "combustor": (lambda: axisymmetric(ex.combustor_deck(48, 40)), None,
                  "gfc_axi_kernel", "axi"),
    "combustor_rng": (lambda: axisymmetric(ex.combustor_deck(48, 40)),
                      "TEM_k_eps_RNG", "gfc_closure_ext_kernel", "axi"),
    "sa": (lambda: axisymmetric(ex.wall_channel_deck(
               48, 40, 3, fl.TEM_Spalart_Allmaras)), None,
           "gfc_closure_ext_kernel", "axi"),
    "bubble": (lambda: axisymmetric(ex.bubble_deck(48, 40)), None,
               "gfc_euler_ext_kernel", "axi"),
    "nrbc_d2": (nrbc_d2_deck, None, "gfc_axi_kernel", "axi"),
    "scramjet": (lambda: ex.scramjet_deck(64, 48), None, "gfc_ext_kernel",
                 "all"),
}
# a flat deck whose gfc stages the coefficient block too: the closures'
# forms (the SA wall channel, not axisymmetric: gfc_sa_kernel)
FLAT_DECKS = {"sa_flat": lambda: ex.wall_channel_deck(
    48, 40, 3, fl.TEM_Spalart_Allmaras)}


@functools.lru_cache(maxsize=None)
def port_case(name):
    deck, tem = DECKS[name][:2] if name in DECKS else (FLAT_DECKS[name],
                                                       None)
    case = build_case(deck(), dtype="float32")
    if tem is not None:
        case = dataclasses.replace(case, params=dataclasses.replace(
            case.params, tem=getattr(fl, tem)))
    return case


@pytest.mark.parametrize("name", sorted(DECKS))
def test_each_deck_picks_its_gfc_form(name):
    _, _, kernel, form = DECKS[name]
    case = port_case(name)
    assert gfc_form(case.params) == form
    step = Solver(case, device="cpu", use_kernels=True).fused
    bodies = (("general", "dual") if kernel == "gfc_euler_ext_kernel"
              else ("spec", "general", "dual"))
    for body in bodies:
        assert step.gfc_name(body) == f"{kernel}<{body}>"
        assert step.gfc_name(body) in EXT_KERNEL_NAMES
    assert step.iteration_launches()[0].startswith(kernel)


def test_a_deck_without_axisymmetry_or_sources_has_no_gfc_form():
    p = port_case("nrbc_d2").params
    flat = dataclasses.replace(p, ft=fl.FT_FLAT)
    assert flat.has_d2x or flat.has_d2y or flat.has_nrbc
    with pytest.raises(ValueError, match="'axi': False, 'src': False"):
        gfc_form(flat)


def f32bits(a):
    return np.asarray(a, dtype=np.float32).view(np.int32)


def check_block(chemf, chemi, n_prefix):
    """Every coefficient of the block against the float32 slopes of the
    knots the flat kernels read; returns the tables' knot counts."""
    f = chemf.double().numpy().astype(np.float32)
    meta = chemi.numpy()
    length, off = int(meta[3 * N_TABLES]), int(meta[3 * N_TABLES + 1])
    assert off == n_prefix and f.size == off + length
    blk = f[off:]
    head = blk[:4 * N_TABLES].reshape(N_TABLES, 4)
    tail_floats = 0
    counts = []
    for t in range(N_TABLES):
        o, n, asc = meta[3 * t:3 * t + 3]
        x, y = f[o:o + n], f[o + n:o + 2 * n]
        counts.append(int(n))
        if not asc or n == 1:
            np.testing.assert_array_equal(head[t], [0, 0, 0, -1])
            continue
        m = (y[1:] - y[:-1]) / (x[1:] - x[:-1])
        assert m.dtype == np.float32
        np.testing.assert_array_equal(f32bits(head[t][:3]),
                                      f32bits([x[0], y[0], m[0]]))
        if n == 2:
            assert head[t][3] == 0
            continue
        code = int(head[t][3])
        assert code >= 4 * N_TABLES and code % 2 == 0
        assert blk[code] == n - 2 and blk[code + 1] == 0
        pairs = blk[code + 2:code + 2 * (n - 1)].reshape(n - 2, 2)
        np.testing.assert_array_equal(f32bits(pairs[:, 0]),
                                      f32bits(x[1:n - 1]))
        np.testing.assert_array_equal(f32bits(pairs[:, 1]),
                                      f32bits(m[1:] - m[:-1]))
        tail_floats += 2 * (n - 1)
    assert length == 4 * N_TABLES + tail_floats
    return counts


def prefix(chem, p):
    """chemf and chemi as the flat kernels read them: R, then each table's
    xs and ys; (offset, knots, ascending) a table."""
    vals = [getattr(chem, f"R_{sp}").reshape(1) for sp in _CHEM_SPECIES]
    off, meta = 4, []
    for prop in _CHEM_PROPS:
        for sp in _CHEM_SPECIES:
            xs = getattr(chem, f"{prop}_{sp}_x")
            meta += [off, xs.numel(), int(f"{prop}_{sp}" in p.chem_asc)]
            vals += [xs, getattr(chem, f"{prop}_{sp}_y")]
            off += 2 * xs.numel()
    return torch.cat(vals), torch.tensor(meta, dtype=torch.int32)


@pytest.mark.parametrize("name", ["combustor", "bubble", "sa_flat"])
def test_the_block_of_the_decks_tables(name):
    solver = Solver(port_case(name), device="cpu", use_kernels=True)
    step = solver.fused
    assert step.gfc_ext == (name != "sa_flat")
    want_f, want_i = prefix(solver.chem, solver.params)
    assert torch.equal(step.chemf[:want_f.numel()], want_f)
    assert torch.equal(step.chemi[:want_i.numel()], want_i)
    assert check_block(step.chemf, step.chemi, want_f.numel()) == [2] * 12


def random_tables(seed):
    """Tables of 1-16 knots from a numpy seed, ascending but for a few
    (reversed knots) and a one-knot table."""
    rng = np.random.default_rng(seed)
    kw = {f"R_{sp}": torch.tensor([rng.uniform(200.0, 400.0)],
                                  dtype=torch.float32)
          for sp in _CHEM_SPECIES}
    asc = []
    for t, (prop, sp) in enumerate((pr, s) for pr in _CHEM_PROPS
                                   for s in _CHEM_SPECIES):
        n = 1 if t == 5 else 2 + (5 * t + seed) % 15
        xs = np.cumsum(rng.uniform(5.0, 400.0, n)).astype(np.float32)
        ys = rng.uniform(1e-3, 3e3, n).astype(np.float32)
        if t % 4 == 3:
            xs = xs[::-1].copy()
        else:
            asc.append(f"{prop}_{sp}")
        kw[f"{prop}_{sp}_x"] = torch.from_numpy(xs)
        kw[f"{prop}_{sp}_y"] = torch.from_numpy(ys)
    return ChemTables(**kw), SimpleNamespace(chem_asc=tuple(asc))


@pytest.mark.parametrize("seed", [0, 1])
def test_the_block_of_tables_from_a_seed(seed):
    chem, p = random_tables(seed)
    chemf, chemi = pack_chem(chem, p)
    want_f, want_i = prefix(chem, p)
    assert torch.equal(chemf[:want_f.numel()], want_f)
    assert torch.equal(chemi[:want_i.numel()], want_i)
    counts = check_block(chemf, chemi, want_f.numel())
    assert 1 in counts and max(counts) > 8


def iteration_inputs(solver):
    chunk, step = solver._chunk_fn, solver.fused
    ca, _, raw, kaux = chunk.prologue(solver.state, 2, solver.last_iter)
    dt = scan_dt(carry_views(ca, solver.state.dt), step.ctx.active,
                 solver.params, raw.cfl_scen[0]).to(torch.float32)
    return ca, dt, kaux


def bits(t):
    return t.contiguous().view(torch.int32)


@pytest.mark.parametrize("name", ["combustor", "sa", "scramjet"])
def test_gfc_writes_three_f_planes_and_pass12_reads_no_other(name):
    solver = Solver(port_case(name), device="cpu", use_kernels=True)
    solver.run_iters(3)
    step = solver.fused
    ca, dt, kaux = iteration_inputs(solver)
    nan = float("nan")
    scr = torch.full((n_scratch(solver.params),) + ca.shape[1:], nan)
    cb = torch.full_like(ca, nan)
    part_i = torch.zeros((step.plan.n_tiles, 2), dtype=torch.int32)
    step.gfc_plain(ca, cb, scr, dt, kaux[0], part_i)
    for e in range(9):
        written = torch.isfinite(scr[SCR_F + e])
        assert bool(written.all() if e in F_OWN else (~written).all()), e
    # the same inputs through the eager gfc: its F in all nine planes
    full = expand(carry_views(ca, dt), step.params, step.src,
                  y_plus=step.y_plus(), lam_t=step.lam_t())
    out, _, _ = gfc(full, step.meta, step.params, step.chem,
                    step._aux(kaux[0]), return_fields=True, ctx=step.ctx,
                    heat=False)
    # the six planes not written are A and B floats, bit for bit
    assert torch.equal(bits(radial_fluxes(scr)), bits(out.F))
    scr9 = scr.clone()
    scr9[SCR_F:SCR_F + 9] = out.F
    results = []
    for s in (scr, scr9):
        c2 = torch.full_like(ca, nan)
        c2[18:] = cb[18:]
        pf = torch.zeros((step.plan.n_tiles, 27))
        step.pass12_plain(ca, c2, s, dt, kaux[1], pf)
        assert torch.isfinite(c2[:18]).all()
        results.append((c2[:18], pf))
    for a, b in zip(*results):
        assert torch.equal(bits(a), bits(b))


def test_sass_report_reads_the_gfc_kernels():
    """bench/sass reads the solver's kernels of a listing by name and body:
    their loads, divisions' FCHK and CALLs, and local memory traffic."""
    from openhyperflow2d_torch.bench import sass
    listing = "\n".join([
        "\t\tFunction : _Z14gfc_axi_kernelILi0EEv9ExtConstsPKfPfS3_",
        "        /*0000*/   LDS.128 R4, [R2] ;",
        "        /*0010*/   FFMA R1, R4, R5, R6 ;",
        "        /*0020*/   STL [R1+0x8], R3 ;",
        "\t\tFunction : _Z14gfc_ext_kernelILi1EEv9ExtConstsPKfPfS3_",
        "        /*0000*/   LDG.E R4, [R2.64] ;",
        "        /*0010*/   @!P0 FCHK P0, R4, R5 ;",
        "        /*0020*/   @P0 CALL.REL.NOINC 0x100 ;"])
    assert sass.report(listing) == [
        "gfc_axi_kernel<general>: 3 instructions, FFMA 1, LDS 1, STL 1",
        "gfc_ext_kernel<spec>: 3 instructions, FCHK 1, CALL 1, LDG 1"]
