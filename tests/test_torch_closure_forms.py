"""The closures' gfc in forms fixed at compile time
(``ops/csrc/fused_step_closure.cu``; ``ops/fused_step.closure_form`` on the
host, ``closure_family`` in C, from the deck's families).

(i) Each deck picks its form by one rule: a deck whose p.models holds one
family runs that family's form (``gfc_keps_var_kernel`` for the k-eps
variants, ``gfc_sa_kernel``, ``gfc_smag_kernel``, ``gfc_prandtl_kernel``),
a deck with more than one runs ``gfc_closure_kernel``, which tests each
family at run time.  Held on the nine closures of chip_smoke.py's 3f (the
wall channel of tests/test_turbulence_models.py), the combustor with RNG
k-eps (5d) and the wall channel with k-eps JL inside and the Prandtl
family at its wall (3f's two-family deck), in every body the deck's tile
plan launches and in "dual".

(ii) Only the forms that carry k-eps have a spec body: no other family
makes spec tiles (static_ctx.spec_supported).

(iii) Every name of CLOSURE_KERNEL_NAMES is one instantiation of the
sources and one entry of the attribute query, at the stage chip_smoke.py
asks for (a text check of the .cu files: no nvcc here).

(iv) The bodies chip_smoke.py keeps for speed alone (CLOSURE_KEPT_BY_AB:
no leaner than the all-families form, so held faster than it on the card)
are family forms' bodies that some deck of (i) launches.

(v) bench/sass --spills reads each local-memory slot of a kernel in an
nvdisasm listing with line tables (a synthetic listing: no nvdisasm here).
"""

import dataclasses
import functools
import importlib.util
import re
from pathlib import Path

import pytest

from openhyperflow2d_torch import examples as ex
from openhyperflow2d_torch.core import flags as fl
from openhyperflow2d_torch.ops import fused_step as fs
from openhyperflow2d_torch.solver.init import build_case
from openhyperflow2d_torch.solver.runner import Solver

CSRC = Path(fs.__file__).parent / "csrc"
ROOT = Path(__file__).resolve().parents[1]

# chip_smoke.py's CLOSURES: (TurbulenceModel, TurbExtModel), and the form
# each runs
CLOSURES = {"chien": (4, fl.TEM_k_eps_Chien, "keps"),
            "jl": (4, fl.TEM_k_eps_JL, "keps"),
            "lsy": (4, fl.TEM_k_eps_LSY, "keps"),
            "rng": (4, fl.TEM_k_eps_RNG, "keps"),
            "sa": (3, fl.TEM_Spalart_Allmaras, "sa"),
            "smagorinsky": (5, fl.TEM_Smagorinsky, "smag"),
            "van driest": (2, fl.TEM_vanDriest, "prandtl"),
            "escudier": (2, fl.TEM_Escudier, "prandtl"),
            "klebanoff": (2, fl.TEM_Klebanoff, "prandtl")}
# 48 x 96: complete interior tiles, so the k-eps decks have spec tiles
NX, NY = 48, 96


@functools.lru_cache(maxsize=None)
def port_case(name):
    if name == "combustor rng":
        case = build_case(ex.combustor_deck(NX, NY), dtype="float32")
        tem = fl.TEM_k_eps_RNG
    elif name == "two families":
        # k-eps JL inside, the Prandtl family at the no-slip wall (kept:
        # no turbulence reset to the deck's one model)
        d = ex.wall_channel_deck(NX, NY, 4, fl.TEM_k_eps_JL)
        d.data.update({"isTurbulenceReset": "0",
                       "Contour1.Bound3.TurbulenceModel": "2"})
        case = build_case(d, dtype="float32")
        tem = fl.TEM_k_eps_JL
    else:
        tm, tem, _ = CLOSURES[name]
        case = build_case(ex.wall_channel_deck(NX, NY, tm, tem),
                          dtype="float32")
    return dataclasses.replace(case, params=dataclasses.replace(
        case.params, tem=tem))


FORMS = {**{name: form for name, (_, _, form) in CLOSURES.items()},
         "combustor rng": "keps", "two families": "all"}


@pytest.mark.parametrize("name", list(FORMS))
def test_each_closure_deck_picks_its_form(name):
    case = port_case(name)
    p = case.params
    form = FORMS[name]
    assert fs.is_closure(p)
    assert fs.closure_form(p) == form
    assert (len(p.models) > 1) == (form == "all")
    kernel = fs.CLOSURE_FORMS[form]
    for dispatch in fs.DISPATCH_FORMS:
        step = Solver(case, device="cpu", use_kernels=True,
                      dispatch=dispatch).fused
        assert step.closure_form == form
        bodies = (["dual"] if dispatch == "dual" else
                  [b for b in ("spec", "general")
                   if step.plan.tiles(b).numel()])
        assert ("spec" in bodies) == ("keps" in p.models
                                      and dispatch == "lists")
        for body in bodies:
            assert step.gfc_name(body) == f"{kernel}<{body}>"
            assert step.gfc_name(body) in fs.CLOSURE_KERNEL_NAMES
        assert step.iteration_launches()[:len(bodies)] == [
            f"{kernel}<{b}>" for b in bodies]
    # the family bits C picks from (ClosureConsts::models)
    c = fs.kernel_consts(p, step.plan, False)
    assert c.models == sum(fs.MODEL_BITS[m] for m in p.models)
    assert (c.models in fs.MODEL_BITS.values()) == (form != "all")


def test_only_the_k_eps_forms_have_a_spec_body():
    spec = {n[:-len("<spec>")] for n in fs.CLOSURE_KERNEL_NAMES
            if n.endswith("<spec>")}
    assert spec == {fs.CLOSURE_FORMS[f] for f in fs.CLOSURE_SPEC_FORMS}
    for form in ("sa", "smag", "prandtl"):
        kernel = fs.CLOSURE_FORMS[form]
        assert f"{kernel}<spec>" not in fs.CLOSURE_KERNEL_NAMES
        assert {f"{kernel}<general>", f"{kernel}<dual>"} <= set(
            fs.CLOSURE_KERNEL_NAMES)
    assert set(fs.CLOSURE_KERNEL_NAMES) <= set(fs.PATH_KERNEL_NAMES)


@functools.lru_cache(maxsize=None)
def chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def chip_smoke_stages():
    return chip_smoke()._STAGE


def test_every_closure_form_is_one_instantiation_and_one_query_entry():
    text = {f.name: f.read_text() for f in CSRC.glob("*.cu")}
    closure = text["fused_step_closure.cu"]
    forms = dict(re.findall(r"^HF2D_CLOSURE_FORM\((\w+), (\w+)\)$", closure,
                            re.M))
    entries = {m[0]: m[1:] for m in re.findall(
        r"HF2D_FORM\((\w+), (\w+), (\d+),\s*(nullptr|reinterpret_cast"
        r"<const void\*>\((\w+)<BODY_SPEC>\))\)", closure)}
    stages = chip_smoke_stages()
    kernels = {n.split("<")[0] for n in fs.CLOSURE_KERNEL_NAMES}
    assert set(forms) == set(entries) == kernels
    bits = {"MODEL_" + ("SMAG" if m == "smag" else m.upper()): m
            for m in fs.MODEL_BITS}
    for form, kernel in fs.CLOSURE_FORMS.items():
        # defined once in all the sources, as this form's family
        assert sum(len(re.findall(rf"\b{kernel}\(", t)) + t.count(
            f"HF2D_CLOSURE_FORM({kernel},") for t in text.values()) == 1
        fam = forms[kernel]
        assert (fam == "FAM_ALL") if form == "all" else bits[fam] == form
        # its attribute-query entry: the same family, chip_smoke.py's
        # stage, a spec body exactly where the names have one
        e_fam, stage, spec, spec_kernel = entries[kernel]
        assert e_fam == fam
        assert int(stage) == stages[kernel]
        has_spec = f"{kernel}<spec>" in fs.CLOSURE_KERNEL_NAMES
        assert (spec != "nullptr") == has_spec
        assert spec_kernel == (kernel if has_spec else "")
    assert len({e[1] for e in entries.values()}) == len(entries)


def test_the_bodies_kept_by_an_ab_are_family_forms_a_deck_launches():
    kept = chip_smoke().CLOSURE_KEPT_BY_AB
    assert kept and len(set(kept)) == len(kept)
    launched = {f"{fs.CLOSURE_FORMS[form]}<{body}>"
                for _, _, form in CLOSURES.values()
                for body in ("general", "dual")
                + (("spec",) if form in fs.CLOSURE_SPEC_FORMS else ())}
    every = fs.CLOSURE_FORMS["all"]
    for name in kept:
        assert name in fs.CLOSURE_KERNEL_NAMES
        assert not name.startswith(every + "<")
        assert name in launched


def test_sass_spills_reads_each_local_slot_of_a_lineinfo_listing():
    """bench/sass --spills: each local-memory slot of a kernel in an
    nvdisasm -g listing, each store with the origin of the stored register
    and each load with the first instruction that reads it, by source
    line."""
    from openhyperflow2d_torch.bench import sass
    name = "_Z19gfc_keps_var_kernelILi0EEv13ClosureConstsPKfPf"
    listing = "\n".join([
        f".text.{name}:",
        '\t//## File "/x/fused_step.cuh", line 209',
        "        /*0000*/   LDG.E.CONSTANT R5, desc[UR6][R4.64] ;",
        "        /*0010*/   FADD R5, R6, R7 ;",
        '\t//## File "/x/fused_step.cuh", line 966',
        "        /*0020*/   STL [R1+0x4], R5 ;",
        "        /*0030*/   STL.64 [R1], R8 ;",
        '\t//## File "/x/fused_step.cuh", line 1105',
        "        /*0040*/   @P0 LDL.LU R2, [R1+0x4] ;",
        "        /*0050*/   FMUL R3, R4, R4 ;",
        '\t//## File "/x/fused_step.cuh", line 1111',
        "        /*0060*/   FFMA R0, R0, -0.5, R2 ;",
        ".text._Z13some_helperv:",
        "        /*0000*/   STL [R1], R2 ;"])
    funcs = sass.line_functions(listing)
    assert list(funcs) == ["gfc_keps_var_kernel<general>"]
    assert sass.spills(funcs["gfc_keps_var_kernel<general>"]) == [
        "local +0x0: stored at 0x0030 (fused_step.cuh:966) from ?",
        "local +0x4: stored at 0x0020 (fused_step.cuh:966) from FADD at "
        "0x0010 (fused_step.cuh:209); loaded at 0x0040 "
        "(fused_step.cuh:1105), read by FFMA at 0x0060 "
        "(fused_step.cuh:1111)"]
