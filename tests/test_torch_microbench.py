"""Port parity: the microbenchmark chains (bench/microbench) against the
JAX scripts' own kernels.

``scripts/shift_microbench.py`` and ``scripts/vpu_div_peak.py`` are loaded
by path; their ``make_kernel`` runs the Pallas kernel in interpret mode on
the CPU (shift_microbench.py:62, vpu_div_peak.py:41), on the scripts' own
input (``default_rng(0)``, a (256, 512) float32 block).  The port's
wrappers take CPU tensors, so they run the plain versions.

* The four shift chains, the exact reciprocal and sqrt: bit for bit.  Each
  step rounds once on both sides (an add, a correctly rounded reciprocal
  times 2, a sqrt plus 1), in the same order.
* div: XLA simplifies ``2 / (2 / q)`` to ``q``, so the script's chain of 96
  divisions returns its input, while the port divides 96 times (as the
  TPU kernel and the CUDA kernel do): held to one ulp, and bit for bit to
  numpy's IEEE chain.
* mul-add, rsqrt and the approximate reciprocal within a stated tolerance
  (``TOL``): XLA's CPU backend contracts ``q * a + b`` into an FMA, rounds
  rsqrt its own way, and interpret mode's ``approx=True`` reciprocal keeps
  about 14 bits.  mul-add is also held bit for bit to numpy's chain with
  the product and the sum rounded apart.
"""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openhyperflow2d_torch.bench import microbench as mb
from openhyperflow2d_torch.bench import sass
from openhyperflow2d_torch.ops import build

SCRIPTS = Path(__file__).resolve().parents[1] / "scripts"

# relative tolerance of the ops that are not pinned, with the reason:
TOL = {
    # the FMA rounds once a step, the product and the sum rounded apart
    # twice: up to one ulp a step of a map whose slope is ~1, 96 ulps of
    # ~1.0 (1.1e-5)
    "mul-add (baseline)": 2e-5,
    # one ulp of values in [1, 2) (see div above)
    "div": 2.4e-7,
    # a few ulps a step of a map whose slope at its fixed point (~1.755) is
    # ~0.22, so the differences do not grow: a few ulps in all
    "rsqrt": 1e-6,
    # interpret mode's approximate reciprocal is good to ~2^-14 (6e-5) a
    # step, and x -> 2/x is a 2-cycle that neither damps nor grows a
    # difference: 96 x 6e-5 (5.9e-3)
    "reciprocal approx": 1e-2,
}
# numpy's float32 chains, each op rounded once (IEEE)
NUMPY_STEP = {
    "mul-add (baseline)": lambda q: q * np.float32(1.000001)
    + np.float32(1e-7),
    "div": lambda q: np.float32(2.0) / q,
}


def load_script(name):
    spec = importlib.util.spec_from_file_location(f"_script_{name}",
                                                  SCRIPTS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def shift_script():
    return load_script("shift_microbench")


@pytest.fixture(scope="module")
def div_script():
    return load_script("vpu_div_peak")


@pytest.fixture(scope="module")
def script_shift(shift_script):
    """{label: the script's interpret-mode kernel on its own input}, each
    computed once."""
    cache = {}

    def get(label):
        if label not in cache:
            fn = getattr(shift_script, "shift_" + label.replace("-", "_"))
            cache[label] = np.asarray(jax.jit(shift_script.make_kernel(fn))(
                jnp.asarray(mb.shift_input())))
        return cache[label]
    return get


def axis_index(i, n, wrap):
    """microbench.cu axis_index: a position along an axis of length n,
    wrapped around (roll) or clamped to the first (concat)."""
    return np.mod(i, n) if wrap else np.maximum(i, 0)


def emulate_shift_chain(x, axis, wrap):
    """microbench.cu shift_chain in numpy, CTA by CTA and thread by thread,
    in the kernel's index arithmetic: along X the tile staged with the
    N_SHIFT rows behind it; along Y each lane's SHIFT_EPT columns (hi) and,
    on lanes 16-31, the columns 128 behind them (lo), passed down the warp
    as the kernel's shuffles pass them.  Each thread's SHIFT_EPT window
    sums run in the chain's order and are stored where the kernel stores
    them; every output must be stored exactly once."""
    X, Y = x.shape
    gx, gy = mb.shift_grid(x.shape, axis)
    tr, tc = mb.SHIFT_TILE[axis]
    H, E = mb.N_SHIFT, mb.SHIFT_EPT
    t = np.arange(mb.SHIFT_THREADS)
    out = np.full(x.shape, np.nan, np.float32)
    stores = np.zeros(x.shape, np.int64)
    for by in range(gy):
        for bx in range(gx):
            r0, c0 = by * tr, bx * tc
            if axis == 0:
                s = x[np.ix_(axis_index(r0 + np.arange(tr + H) - H, X, wrap),
                             c0 + np.arange(tc))]
                a, b = t % tc, t // tc
                w = s[b[:, None] * E + np.arange(E + H), a[:, None]]
                r = r0 + b[:, None] * E + np.arange(E)
                c = np.broadcast_to(c0 + a[:, None], r.shape)
            else:
                lane, warp = t % 32, t // 32
                r = np.broadcast_to((r0 + warp)[:, None], (t.size, E))
                c = c0 + lane[:, None] * E + np.arange(E)
                hi = x[r, c]
                lo = np.where((lane >= 16)[:, None],
                              x[r, axis_index(c - 128, Y, wrap)], 0)
                w = np.empty((t.size, E + H), np.float32)
                w[:, H:] = hi
                for d in range(1, H // E + 1):
                    src = warp * 32 + (lane - d) % 32
                    w[:, H - d * E:H - d * E + E] = np.where(
                        (lane[src] + d < 32)[:, None], hi[src], lo[src])
            acc = w[:, H:].copy()
            for k in range(1, H + 1):
                acc = acc + w[:, H - k:H - k + E]
            out[r, c] = acc
            np.add.at(stores, (r, c), 1)
    assert (stores == 1).all()
    return out


def test_constants_match_the_scripts(shift_script, div_script):
    assert (mb.N_SHIFT, mb.SHAPE) == (shift_script.N_CHAIN,
                                      shift_script.SHAPE)
    assert (mb.N_DIV, mb.SHAPE) == (div_script.N_CHAIN, div_script.SHAPE)
    assert mb.DIV_OPS == tuple(div_script.OPS)


@pytest.mark.parametrize("label", list(mb.SHIFTS))
def test_shift_chain_matches_the_script(script_shift, label):
    x = mb.shift_input()
    want = script_shift(label)
    mb.reset_launches()
    got = mb.shift_chain(torch.as_tensor(x), *mb.SHIFTS[label]).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    assert not any(mb.LAUNCHES.values())    # the plain version ran


# the scripts' block, and smaller ones that both axes' tiles fit, shorter
# along X than the 64-row window (the clamp and the wrap reach past row 0
# two and four times) and one tile wide along Y
@pytest.mark.parametrize("shape", [mb.SHAPE, (32, 128), (16, 128)])
@pytest.mark.parametrize("label", list(mb.SHIFTS))
def test_shift_tiling_matches_plain(label, shape):
    x = np.random.default_rng(1).random(shape, np.float32)
    got = emulate_shift_chain(x, *mb.SHIFTS[label])
    want = mb.shift_chain_plain(torch.as_tensor(x), *mb.SHIFTS[label])
    np.testing.assert_array_equal(got, want.numpy())


@pytest.mark.parametrize("label", list(mb.SHIFTS))
def test_shift_tiling_matches_the_script(script_shift, label):
    got = emulate_shift_chain(mb.shift_input(), *mb.SHIFTS[label])
    np.testing.assert_array_equal(got, script_shift(label))


@pytest.mark.parametrize("shape, axis", [
    ((256, 500), 0), ((250, 512), 0), ((256, 64), 1), ((254, 512), 1),
    ((0, 512), 0), ((16 * 65536, 32), 0)])
def test_unfit_shift_shapes_raise(shape, axis):
    with pytest.raises(ValueError, match="whole"):
        mb.shift_grid(shape, axis)
    assert mb.shift_grid(mb.SHAPE, axis)      # the scripts' block fits


# the script's block; ragged ones (a tail of 1-3); fewer groups than CTAs;
# more groups than threads (several groups a thread)
@pytest.mark.parametrize("n, sms", [
    (256 * 512, 132), (256 * 512 - 3, 132), (4097, 132), (6, 132),
    (20001, 3)])
def test_div_plan_covers_each_element_once(n, sms):
    """The plan's mirror of microbench.cu's index arithmetic (div_plan, the
    spec launch_div follows) covers each element once.  This tests the
    mirror; the kernel itself is held bit for bit on the card on the
    aligned, ragged and misaligned wide blocks (chip_smoke.py phase 8)."""
    plan = mb.div_plan(n, sms)
    assert plan.grid == min(sms * mb.DIV_CTAS_PER_SM, plan.groups)
    assert plan.tail == n % mb.DIV_EPT
    sizes = [len(plan.group_range(b)) for b in range(plan.grid)]
    assert max(sizes) - min(sizes) <= 1 and min(sizes) >= 1
    elems = np.fromiter((i for _, _, i in plan.elements()), np.int64)
    np.testing.assert_array_equal(np.bincount(elems, minlength=n),
                                  np.ones(n, np.int64))
    for bad in (0, 2**31):
        with pytest.raises(ValueError, match="div_chain takes"):
            mb.div_plan(bad, sms)


@pytest.mark.parametrize("op", mb.DIV_OPS)
def test_div_chain_matches_the_script(div_script, op):
    x = mb.div_input()
    want = np.asarray(div_script.make_kernel(div_script.OPS[op])(
        jnp.asarray(x)))
    got = mb.div_chain(torch.as_tensor(x), op).numpy()
    assert got.dtype == np.float32
    assert np.isfinite(got).all()
    if op in TOL:
        np.testing.assert_allclose(got, want, rtol=TOL[op], atol=0)
    else:
        np.testing.assert_array_equal(got, want)
    if op in NUMPY_STEP:
        q = x
        for _ in range(mb.N_DIV):
            q = NUMPY_STEP[op](q)
        assert q.dtype == np.float32
        np.testing.assert_array_equal(got, q)


def test_wrappers_do_not_fall_back():
    """Only a CPU tensor takes the plain version; any other device goes to
    the kernel's checks or raises, and nothing is counted."""
    mb.reset_launches()
    x = torch.zeros(mb.SHAPE, device="meta")
    with pytest.raises(ValueError, match="CUDA or CPU"):
        mb.shift_chain(x, 0, False)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        mb.div_chain(x, "div")
    with pytest.raises(ValueError, match="unknown op"):
        mb.div_chain(torch.ones(mb.SHAPE), "exp")
    with pytest.raises(ValueError, match="axis"):
        mb.shift_chain(torch.ones(mb.SHAPE), 2, False)
    assert set(mb.LAUNCHES) == set(mb.kernel_names())
    assert not any(mb.LAUNCHES.values())


def test_microbench_needs_cuda(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert mb.main([]) == 2
    assert "CUDA is not available" in capsys.readouterr().err


def _sass_listing():
    """A cuobjdump -sass listing in miniature: div_chain<1, true> with a
    loop of DIV_UNROLL x DIV_EPT steps of MUFU.RCP + FMUL, div_chain<1,
    false> (not reported) and shift_chain<0, false>."""
    steps = mb.DIV_UNROLL * mb.DIV_EPT
    insts = (["LDG.E.128 R4, desc[UR4][R2.64]"]
             + ["MUFU.RCP R5, R4", "FMUL R4, R5, 2"] * steps
             + ["ISETP.NE.AND P0, PT, R6, RZ, PT", "@P0 BRA 0x10",
                "STG.E.128 desc[UR4][R2.64], R4"])
    lines = ["\t\tFunction : _ZN4_GLOBAL_9div_chainILi1ELb1EEEvPKfPfi"]
    lines += [f"        /*{16 * i:04x}*/   {t} ;   /* 0x0 */"
              for i, t in enumerate(insts)]
    lines += ["\t\tFunction : _ZN4_GLOBAL_9div_chainILi1ELb0EEEvPKfPfi",
              "        /*0000*/   MUFU.RCP R5, R4 ;",
              "\t\tFunction : _ZN4_GLOBAL_11shift_chainILi0ELb0EEEvPKfPfii",
              "        /*0000*/   LDS R1, [R2] ;",
              "        /*0010*/   @!P1 FADD R1, R1, R3 ;",
              "        /*0020*/   FADD R1, R1, R3 ;"]
    return "\n".join(lines), steps


def test_sass_report_counts_a_step():
    """bench/sass reads a listing's kernels and, for div_chain, its inner
    loop's opcodes a chain step (a predicate guard ignored)."""
    listing, steps = _sass_listing()
    div, shift = sass.report(listing)
    n = 2 * steps + 2
    assert div.startswith(f"{mb.div_name('div')}: {n + 2} instructions, "
                          f"MUFU {steps}, FMUL {steps}, ISETP 1, BRA 1, "
                          "LDG 1, STG 1")
    assert div.endswith(f"loop at 0x10, a step of its {steps}: "
                        f"{n / steps:g} instructions, MUFU 1, FMUL 1, "
                        f"ISETP {1 / steps:g}, BRA {1 / steps:g}")
    assert shift == (f"{mb.shift_name(0, False)}: 3 instructions, "
                     "FADD 2, LDS 1")


def test_kernels_from_swaps_the_library(monkeypatch):
    """Within kernels_from, load_kernels() (so every wrapper) returns the
    other build, and the loaded one again after the block, also where it
    raised."""
    this, other = object(), object()
    monkeypatch.setattr(build, "_LOADED", this)
    with build.kernels_from(other):
        assert build.load_kernels() is other
    assert build.load_kernels() is this
    with pytest.raises(RuntimeError):
        with build.kernels_from(other):
            raise RuntimeError
    assert build.load_kernels() is this
