"""Port parity: the static per-node context.

Every StaticCtx field, the packed 4-word form, the generic-interior map and
the specialized interior ctx must equal the JAX package's; the CUDA header's
bit indices must follow the JAX package's bit order.
"""

import dataclasses
import re
from pathlib import Path

import numpy as np
import pytest
import torch
from torch_parity import np_fields, to_np

from openhyperflow2d_tpu.core import state as jstate
from openhyperflow2d_tpu.core import static_ctx as jctx
from openhyperflow2d_tpu.examples import combustor_deck, reacting_rans_deck
from openhyperflow2d_tpu.solver import init as jinit
from openhyperflow2d_torch.core import state as tstate
from openhyperflow2d_torch.core import static_ctx as tctx

HEADER = (Path(__file__).resolve().parents[1] / "openhyperflow2d_torch"
          / "ops" / "csrc" / "hf2d_ctx_bits.cuh")

DECKS = {
    "combustor": lambda: combustor_deck(48, 40),
    "rans_wall": lambda: reacting_rans_deck(48, 40, wall_bottom=True),
    "rans_step_heat": lambda: reacting_rans_deck(
        48, 40, wall_bottom=True, adiabatic=False, with_step=True),
}


@pytest.fixture(scope="module", params=sorted(DECKS))
def metas(request):
    case = jinit.build_case(DECKS[request.param]())
    jm = jstate.meta_from_grid(case.grid, dtype=case.params.jdtype)
    tp = tstate.params_from_dict(dataclasses.asdict(case.params))
    tm = tstate.meta_from_numpy(np_fields(jm))
    return case, jm, tm, tp


def _assert_ctx_equal(jc, tc, where=None):
    for f in dataclasses.fields(tctx.StaticCtx):
        a, b = getattr(jc, f.name), getattr(tc, f.name)
        if isinstance(a, bool):
            assert b is a or b == a, f.name
            continue
        a, b = np.asarray(a), to_np(b)
        if where is not None and a.ndim >= 2:
            a, b = a[..., where], b[..., where]
        np.testing.assert_array_equal(b, a, err_msg=f.name)
        assert b.dtype == a.dtype, f.name


def test_build_static_ctx_matches_jax(metas):
    case, jm, tm, tp = metas
    _assert_ctx_equal(jctx.build_static_ctx(jm, case.params),
                      tctx.build_static_ctx(tm, tp))


def test_packed_ctx_bitwise_and_unpack(metas):
    case, jm, tm, tp = metas
    jpk = np.asarray(jctx.build_packed_ctx(jm, case.params))
    tpk = to_np(tctx.build_packed_ctx(tm, tp))
    assert tpk.dtype == np.int32 and tpk.shape == (jctx.N_CTX_WORDS,) + \
        jpk.shape[1:]
    np.testing.assert_array_equal(tpk.view(np.uint32), jpk)
    _assert_ctx_equal(
        jctx.unpack_static_ctx(jnp_u32(jpk), jm, case.params),
        tctx.unpack_static_ctx(torch.as_tensor(tpk), tm, tp))


def jnp_u32(a):
    import jax.numpy as jnp
    return jnp.asarray(a, jnp.uint32)


def test_generic_map_and_specialized_ctx(metas):
    case, jm, tm, tp = metas
    g = case.grid
    jgen = jctx.generic_interior_map(g.CT, g.TCT, g.idXl, g.idXr, g.idYu,
                                     g.idYd, case.params)
    # the port's map, from the host grid and from the int32 device planes
    tgen = tctx.generic_interior_map(g.CT, g.TCT, g.idXl, g.idXr, g.idYu,
                                     g.idYd, tp)
    tgen2 = tctx.generic_interior_map(*(to_np(getattr(tm, f)) for f in (
        "CT", "TCT", "idXl", "idXr", "idYu", "idYd")), tp)
    np.testing.assert_array_equal(tgen, jgen)
    np.testing.assert_array_equal(tgen2, jgen)
    assert tgen.any()
    # specialized ctx equals JAX's, and equals the full decode on generic
    # nodes (the condition that makes the SPEC kernel body exact)
    tspec = tctx.specialized_interior_ctx(tm, tp)
    _assert_ctx_equal(jctx.specialized_interior_ctx(jm, case.params), tspec)
    full = tctx.build_static_ctx(tm, tp)
    for f in dataclasses.fields(tctx.StaticCtx):
        sv, gv = getattr(tspec, f.name), to_np(getattr(full, f.name))
        if isinstance(sv, bool):
            got = gv[..., tgen]
            assert (got == sv).all(), f.name
        else:
            sv = to_np(sv)
            want = sv if sv.ndim == 0 else sv[..., tgen]
            np.testing.assert_array_equal(gv[..., tgen], np.broadcast_to(
                want, gv[..., tgen].shape), err_msg=f.name)


def test_header_bit_indices_follow_jax_order():
    text = HEADER.read_text()
    idx = {m.group(1): int(m.group(2)) for m in re.finditer(
        r"constexpr int CTX_(\w+) = (\d+);", text)}
    b = 0
    for f in jctx._CTX_BOOL_STACKS:
        assert idx.pop(f.upper()) == b, f
        b += 9
    for f in jctx._CTX_BOOL_PLANES:
        assert idx.pop(f.upper()) == b, f
        b += 1
    assert idx.pop("N_BITS") == b == jctx.N_CTX_BITS
    assert idx.pop("N_WORDS") == jctx.N_CTX_WORDS
    assert not idx, f"header names without a JAX field: {sorted(idx)}"
    assert tctx._CTX_BOOL_STACKS == jctx._CTX_BOOL_STACKS
    assert tctx._CTX_BOOL_PLANES == jctx._CTX_BOOL_PLANES


def test_header_layouts_match_python():
    from openhyperflow2d_torch.ops import fused_step as fs
    text = HEADER.read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);",
                             text).group(1))

    o = 0
    for name, n in fs.CARRY_FIELDS:
        key = {"Yc": "YC", "mu_t": "MU_T"}.get(name, name.upper())
        assert const(f"CARRY_{key}") == o, name
        o += n
    assert const("N_CARRY") == o == fs.N_CARRY
    assert const("N_SCRATCH") == fs.N_SCRATCH
    assert const("SCR_F") == fs.SCR_F   # the F planes of axisymmetric decks
    assert (const("TILE_X"), const("TILE_Y")) == fs.TILE
