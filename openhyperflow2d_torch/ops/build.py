"""Build and load the port's CUDA kernels.

``load_kernels()`` compiles ``ops/csrc/*.cu`` with nvcc, one process per
source, all started together, links the objects into one shared library
with a plain C interface and loads it with ctypes.  The library goes
to ``build/hf2d_torch/<hash of the sources>/`` under the repository root,
so an edited source rebuilds and an unchanged one is reused.  A failed build
raises with nvcc's output; nothing falls back.

``load_library(csrc)`` builds and loads the same entries from another
checkout's sources (``load_library(flags=...)``: from these sources with
more nvcc flags, as ``-fmad=false``), and ``kernels_from(lib)`` makes every
wrapper launch them for the length of a block: an A/B of two builds in one
process.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from contextlib import contextmanager
from dataclasses import dataclass
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "hf2d_torch"
LIB_NAME = "libhf2d_kernels.so"
# no --use_fast_math: division and sqrt must stay IEEE so the kernels stay
# inside their plain versions' envelope
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    # body, consts, cin, cout, scr, idn, mf, ctx, chemf, chemi, dt, aux,
    # tiles, n_tiles, flags, part_i, stream
    "hf2d_gfc": [_I] + [_P] * 12 + [_I, _P, _P, _P],
    # body, consts, cin, cout, scr, idn, ctx, dt, aux, tiles, n_tiles,
    # flags, part_f, stream
    "hf2d_pass12": [_I] + [_P] * 9 + [_I, _P, _P, _P],
    # the extended forms (fused_step_ext.cu): the same, with the source
    # field before the stream
    "hf2d_gfc_ext": [_I] + [_P] * 12 + [_I, _P, _P, _P, _P],
    "hf2d_pass12_ext": [_I] + [_P] * 9 + [_I, _P, _P, _P, _P],
    # consts, cin, cout, scr, mf, chemf, chemi, dt, aux, aux_next, tiles,
    # n_tiles, edges, part_i, part_f, stream (the spec tiles' fused
    # iteration, fused_step_spec.cu)
    "hf2d_step_spec": [_P] * 11 + [_I] + [_P] * 4,
    # as, n, jp1_lo, jp1_hi, out, bad, stream (the check of pass12's
    # division by j + 1)
    "hf2d_div_jp1_check": [_P, _I, _I, _I, _P, _P, _P],
    # consts, cin, cout, scr, idn, mf, ctx, chemf, chemi, dt, aux, tiles,
    # n_tiles, part_i, src, st, part_dt, keep, stream (gfc's state form,
    # the chunk's epilogue)
    "hf2d_gfc_state": [_P] * 12 + [_I] + [_P] * 4 + [_I, _P],
    # consts, cout, scr, ctx, dt, tiles, n_tiles, q_conv, stream
    "hf2d_heat": [_P] * 6 + [_I, _P, _P],
    # kernel (8 * stage + body), out (int32 x 6)
    "hf2d_kernel_info": [_I, _P],
    # axis, wrap, x, out, X, Y, stream
    "hf2d_shift_chain": [_I, _I, _P, _P, _I, _I, _P],
    # op, x, out, n, stream
    "hf2d_div_chain": [_I, _P, _P, _I, _P],
}


@dataclass
class KernelLib:
    lib: ctypes.CDLL
    path: Path
    build_seconds: float   # 0.0 when the library was already built
    ptxas_log: str         # nvcc -Xptxas -v output (registers, spills)

    def check(self, code: int, what: str) -> None:
        if code != 0:
            msg = self.lib.hf2d_error_string(code).decode()
            raise RuntimeError(f"{what} failed to launch: CUDA error "
                               f"{code} ({msg})")


def nvcc_path() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (looked on PATH and in "
                       "/usr/local/cuda/bin); the CUDA kernels cannot be "
                       "built")


def _source_hash(sources, flags=()) -> str:
    h = hashlib.sha256(" ".join([*NVCC_FLAGS, *flags]).encode())
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def build(csrc: Path = CSRC, flags=()) -> tuple[Path, float, str]:
    """Compile the kernels of ``csrc`` (with ``flags`` after NVCC_FLAGS)
    if needed; returns (library path, seconds spent compiling, ptxas
    log)."""
    sources = sorted(csrc.glob("*.cu")) + sorted(csrc.glob("*.cuh"))
    out_dir = BUILD_ROOT / _source_hash(sources, flags)
    lib_path = out_dir / LIB_NAME
    log_path = out_dir / "ptxas.log"
    if lib_path.exists():
        return lib_path, 0.0, log_path.read_text() if log_path.exists() \
            else ""
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    t0 = time.perf_counter()
    # objects in a directory of this process's own: processes that build
    # at once (the ranks of a multi-GPU run) never share a file
    obj_dir = Path(tempfile.mkdtemp(dir=out_dir))
    procs = []
    for src in sources:
        if src.suffix != ".cu":
            continue
        obj = obj_dir / f"{src.stem}.o"
        cmd = [nvcc, *NVCC_FLAGS, *flags, "-I", str(csrc), "-c", "-o",
               str(obj), str(src)]
        procs.append((cmd, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    log = ""
    failed = []
    for cmd, _, proc in procs:
        out = proc.communicate()[0]
        log += out
        if proc.returncode != 0:
            failed.append(f"nvcc failed (exit {proc.returncode}):\n"
                          f"{' '.join(cmd)}\n{out}")
    if failed:
        shutil.rmtree(obj_dir, ignore_errors=True)
        raise RuntimeError("\n".join(failed))
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
    os.close(fd)
    cmd = [nvcc, "-shared", "-o", tmp, *(str(o) for _, o, _ in procs)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    secs = time.perf_counter() - t0
    shutil.rmtree(obj_dir, ignore_errors=True)
    if proc.returncode != 0:
        # nvcc removes its output when the link fails
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise RuntimeError(
            f"nvcc failed (exit {proc.returncode}):\n{' '.join(cmd)}\n"
            f"{proc.stdout}\n{proc.stderr}")
    log_path.write_text(log)
    os.replace(tmp, lib_path)
    return lib_path, secs, log


_LOADED: KernelLib | None = None


def load_library(csrc: Path = CSRC, flags=()) -> KernelLib:
    """Build (if needed) and load the kernel library of ``csrc``, with
    ``flags`` after NVCC_FLAGS."""
    path, secs, log = build(Path(csrc), tuple(flags))
    lib = ctypes.CDLL(str(path))
    for name, argtypes in _SIGNATURES.items():
        # an earlier tree (load_library of an A/B) may lack later entries;
        # a wrapper that calls one raises AttributeError there
        fn = getattr(lib, name, None)
        if fn is None and Path(csrc).resolve() == CSRC:
            raise RuntimeError(f"{path} exports no {name}")
        if fn is not None:
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    lib.hf2d_error_string.argtypes = [ctypes.c_int]
    lib.hf2d_error_string.restype = ctypes.c_char_p
    return KernelLib(lib, path, secs, log)


def load_kernels() -> KernelLib:
    """Build (at first use) and load the kernel library, once per
    process."""
    global _LOADED
    if _LOADED is None:
        _LOADED = load_library()
    return _LOADED


@contextmanager
def kernels_from(lib: KernelLib):
    """Within the block, load_kernels() returns ``lib`` (another build of
    the same entries, load_library), so every wrapper launches its
    kernels."""
    global _LOADED
    saved = load_kernels()
    _LOADED = lib
    try:
        yield lib
    finally:
        _LOADED = saved
