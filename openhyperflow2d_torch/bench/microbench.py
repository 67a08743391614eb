"""Microbenchmarks of dependent op chains on the card: the port's
counterparts of ``scripts/shift_microbench.py`` (stencil shifts) and
``scripts/vpu_div_peak.py`` (division-class ops).

* ``shift_chain(x, axis, wrap)``: acc = x + the sum of 64 dependent shifts
  by one along X (axis 0) or Y (axis 1), the first row or column
  replicated (``wrap=False``, the solver's concat-of-slices shift) or
  wrapped around (``wrap=True``, a roll).
* ``div_chain(x, op)``: 96 dependent applications of one op of
  ``DIV_OPS`` per element.

Each wrapper runs its kernel (ops/csrc/microbench.cu) for a CUDA tensor and
its plain version (``shift_chain_plain``, ``div_chain_plain``) for a CPU
tensor, and counts its kernel launches in ``LAUNCHES``.  On the card:

    python -m openhyperflow2d_torch.bench.microbench

prints the two scripts' rows, with CUDA-event times per call, on their own
input (``default_rng(0)``, a (256, 512) float32 block).  It exits non-zero
without CUDA.
"""

from __future__ import annotations

import argparse
import sys
from dataclasses import dataclass

import numpy as np
import torch

N_SHIFT = 64        # shift_microbench.py N_CHAIN
N_DIV = 96          # vpu_div_peak.py N_CHAIN
SHAPE = (256, 512)  # both scripts' SHAPE
SHIFTS = {"concat-x": (0, False), "roll-x": (0, True),
          "concat-y": (1, False), "roll-y": (1, True)}
# vpu_div_peak.py OPS, in microbench.cu's OP_* order
DIV_OPS = ("mul-add (baseline)", "div", "reciprocal exact",
           "reciprocal approx", "sqrt", "rsqrt")
# shift_chain (microbench.cu ShiftTile): a CTA's output tile, rows x
# columns, by axis, and each of its SHIFT_THREADS threads sums SHIFT_EPT
# outputs; along X it stages the N_SHIFT rows behind the tile in shared
# memory, along Y lanes 16-31 load the N_SHIFT columns behind the warp's
SHIFT_TILE = ((16, 32), (4, 128))
SHIFT_EPT = 4
SHIFT_THREADS = 128
# div_chain (microbench.cu): each thread runs DIV_EPT elements' chains (a
# group), DIV_THREADS threads a CTA, DIV_CTAS_PER_SM CTAs an SM
DIV_EPT = 4
DIV_THREADS = 256
DIV_CTAS_PER_SM = 1
DIV_UNROLL = 8      # chain steps an iteration of the kernel's loop

LAUNCHES: dict = {}


def shift_name(axis: int, wrap: bool) -> str:
    return f"shift_chain<{'xy'[axis]},{'roll' if wrap else 'concat'}>"


def div_name(op: str) -> str:
    return f"div_chain<{op}>"


def kernel_names() -> list:
    return ([shift_name(a, w) for a, w in SHIFTS.values()]
            + [div_name(op) for op in DIV_OPS])


def reset_launches() -> None:
    LAUNCHES.clear()
    LAUNCHES.update(dict.fromkeys(kernel_names(), 0))


reset_launches()


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------
def shift_plain(q: torch.Tensor, axis: int, wrap: bool) -> torch.Tensor:
    """q shifted by one along X (axis 0) or Y (axis 1): the first row or
    column replicated, or wrapped around."""
    dim = axis - 2
    if wrap:
        return torch.roll(q, 1, dims=dim)
    n = q.shape[dim]
    return torch.cat([q.narrow(dim, 0, 1), q.narrow(dim, 0, n - 1)], dim)


def shift_chain_plain(x: torch.Tensor, axis: int, wrap: bool):
    q = acc = x
    for _ in range(N_SHIFT):
        q = shift_plain(q, axis, wrap)
        acc = acc + q
    return acc


def div_step_plain(q: torch.Tensor, op: str) -> torch.Tensor:
    """One application of ``op`` with every constant a float32 of q's device
    (so nothing is computed in double)."""
    def c(v):
        return torch.tensor(v, dtype=q.dtype, device=q.device)
    if op == "mul-add (baseline)":
        return q * c(1.000001) + c(1e-7)
    if op == "div":
        # torch.div, not 2.0 / q: a Python scalar over a tensor is
        # q.reciprocal() * 2, two roundings
        return torch.div(c(2.0), q)
    if op in ("reciprocal exact", "reciprocal approx"):
        return torch.reciprocal(q) * c(2.0)
    if op == "sqrt":
        return torch.sqrt(q) + c(1.0)
    if op == "rsqrt":
        return torch.rsqrt(q) + c(1.0)
    raise ValueError(f"unknown op {op!r}; one of {DIV_OPS}")


def div_chain_plain(x: torch.Tensor, op: str) -> torch.Tensor:
    q = x
    for _ in range(N_DIV):
        q = div_step_plain(q, op)
    return q


# ---------------------------------------------------------------------------
# launch plans (what microbench.cu's launchers compute)
# ---------------------------------------------------------------------------
def shift_grid(shape, axis: int) -> tuple:
    """shift_chain's grid (CTAs along Y, CTAs along X) for an (X, Y)
    block: whole tiles of SHIFT_TILE[axis], else ValueError."""
    X, Y = shape
    tr, tc = SHIFT_TILE[axis]
    if X <= 0 or Y <= 0 or X % tr or Y % tc or X // tr > 65535:
        raise ValueError(f"shift_chain along axis {axis} takes whole "
                         f"{tr} x {tc} tiles (at most 65535 along X); got "
                         f"a {X} x {Y} block")
    return Y // tc, X // tr


@dataclass(frozen=True)
class DivPlan:
    """div_chain's launch over n elements: ``groups`` groups of DIV_EPT
    (the last holds ``tail`` elements when n is not a multiple), ``grid``
    CTAs of DIV_THREADS; with groups = base * grid + rem, CTA b takes base
    groups, one more if b < rem, from b * base + min(b, rem), and its
    thread t every DIV_THREADS-th of them from t."""
    n: int
    grid: int
    groups: int
    tail: int

    def group_range(self, b: int) -> range:
        base, rem = divmod(self.groups, self.grid)
        start = b * base + min(b, rem)
        return range(start, start + base + (b < rem))

    def elements(self):
        """(CTA, thread, element) of every element the kernel loads and
        stores, in the kernel's index arithmetic."""
        for b in range(self.grid):
            g = self.group_range(b)
            for t in range(DIV_THREADS):
                for grp in range(g.start + t, g.stop, DIV_THREADS):
                    for e in range(DIV_EPT):
                        if grp * DIV_EPT + e < self.n:
                            yield b, t, grp * DIV_EPT + e


def div_plan(n: int, sms: int) -> DivPlan:
    """The plan of div_chain's launcher for n elements on a card of ``sms``
    SMs (cudaDevAttrMultiProcessorCount)."""
    if not 0 < n <= 2**31 - 1 - DIV_EPT:
        raise ValueError(f"div_chain takes 1 to 2^31 - {1 + DIV_EPT} "
                         f"elements; got {n}")
    groups = -(-n // DIV_EPT)
    return DivPlan(n, min(sms * DIV_CTAS_PER_SM, groups), groups,
                   n % DIV_EPT)


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------
def _check(x: torch.Tensor) -> None:
    if x.dtype != torch.float32:
        raise NotImplementedError(f"the chains are float32; got {x.dtype}")
    if x.dim() != 2 or not x.is_contiguous():
        raise ValueError("the chains take a contiguous (X, Y) block")


def sm_count(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _launch(entry: str, name: str, args) -> None:
    from ..ops.build import load_kernels
    lib = load_kernels()
    code = getattr(lib.lib, entry)(*args,
                                   torch.cuda.current_stream().cuda_stream)
    lib.check(code, name)
    LAUNCHES[name] += 1


def shift_chain(x: torch.Tensor, axis: int, wrap: bool) -> torch.Tensor:
    """The shift chain: the kernel for a CUDA tensor, the plain version for
    a CPU tensor."""
    if axis not in (0, 1):
        raise ValueError(f"axis {axis} is not 0 (X) or 1 (Y)")
    if x.device.type == "cpu":
        return shift_chain_plain(x, axis, wrap)
    if x.device.type != "cuda":
        raise ValueError(f"shift_chain runs on CUDA or CPU tensors, not "
                         f"{x.device}")
    _check(x)
    shift_grid(x.shape, axis)
    out = torch.empty_like(x)
    _launch("hf2d_shift_chain", shift_name(axis, wrap),
            (axis, int(wrap), x.data_ptr(), out.data_ptr(), *x.shape))
    return out


def div_chain(x: torch.Tensor, op: str) -> torch.Tensor:
    """The op chain: the kernel for a CUDA tensor, the plain version for a
    CPU tensor."""
    if op not in DIV_OPS:
        raise ValueError(f"unknown op {op!r}; one of {DIV_OPS}")
    if x.device.type == "cpu":
        return div_chain_plain(x, op)
    if x.device.type != "cuda":
        raise ValueError(f"div_chain runs on CUDA or CPU tensors, not "
                         f"{x.device}")
    _check(x)
    div_plan(x.numel(), sm_count(x.device))
    out = torch.empty_like(x)
    _launch("hf2d_div_chain", div_name(op),
            (DIV_OPS.index(op), x.data_ptr(), out.data_ptr(), x.numel()))
    return out


# ---------------------------------------------------------------------------
# the scripts' inputs and work
# ---------------------------------------------------------------------------
def shift_input() -> np.ndarray:
    """shift_microbench.py's block: default_rng(0), [0, 1)."""
    return np.random.default_rng(0).random(SHAPE, np.float32)


def div_input() -> np.ndarray:
    """vpu_div_peak.py's block: 1 + default_rng(0), [1, 2)."""
    return 1.0 + np.random.default_rng(0).random(SHAPE, np.float32)


def ops_per_element(name: str) -> int:
    """float32 operations per element of a chain: one add per shift; per
    op step, the op and its trailing multiply or add (two for mul-add, one
    for div)."""
    if name.startswith("shift_chain"):
        return N_SHIFT
    return N_DIV * (1 if name == div_name("div") else 2)


def time_call(fn, reps: int) -> float:
    """ms per call by CUDA events around ``reps`` calls, after a warm-up."""
    fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def run(device, reps: int = 100) -> dict:
    """The two scripts' loops on ``device`` (CUDA): {kernel name: ms per
    call}.  Prints their rows."""
    xs = torch.as_tensor(shift_input(), device=device)
    out = {}
    for label, (axis, wrap) in SHIFTS.items():
        ms = time_call(lambda: shift_chain(xs, axis, wrap), reps)
        out[shift_name(axis, wrap)] = ms
        print(f"{label:<16} {ms:8.3f} ms/call  {ms / N_SHIFT * 1e3:8.3f} "
              f"us/shift+add")
    sx = {k: out[shift_name(*v)] for k, v in SHIFTS.items()}
    print(f"roll-x/concat-x: {sx['roll-x'] / sx['concat-x']:.3f}  "
          f"roll-y/concat-y: {sx['roll-y'] / sx['concat-y']:.3f}")
    xd = torch.as_tensor(div_input(), device=device)
    elems = xd.numel() * N_DIV
    base = None
    for op in DIV_OPS:
        ms = time_call(lambda: div_chain(xd, op), reps)
        out[div_name(op)] = ms
        base = base or ms
        print(f"{op:<22} {ms:7.3f} ms  {elems / (ms * 1e-3) / 1e12:6.2f} "
              f"Telem/s  x{ms / base:.2f} vs baseline")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=100)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("microbench: CUDA is not available; the chains time the card",
              file=sys.stderr)
        return 2
    print(torch.cuda.get_device_name(0))
    run(torch.device("cuda", 0), args.reps)
    return 0


if __name__ == "__main__":
    sys.exit(main())
