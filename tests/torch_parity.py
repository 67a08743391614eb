"""Shared helpers of the port's parity tests (tests/test_torch_*.py).

Both packages run on the CPU in one process; data crosses between them as
numpy arrays.  JAX runs with x64 (tests/conftest.py).
"""

import dataclasses

import numpy as np
import torch

torch.set_num_threads(2)


def np_fields(obj) -> dict:
    """{field: numpy array} of a JAX dataclass pytree (None kept)."""
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        out[f.name] = None if v is None else np.asarray(v)
    return out


def to_np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def port_case(jcase):
    """The port's Case for a case built by the JAX package: the same host
    grid and deck, the port's SolverParams (built with the converter)."""
    from openhyperflow2d_torch.core.state import params_from_dict
    from openhyperflow2d_torch.solver import init as tinit
    kw = {f.name: getattr(jcase, f.name)
          for f in dataclasses.fields(tinit.Case)}
    kw["params"] = params_from_dict(dataclasses.asdict(jcase.params))
    return tinit.Case(**kw)


def port_inputs(jsolver):
    """(state, meta, params, chem) of the port from a JAX Solver's arrays."""
    from openhyperflow2d_torch.core.state import (chem_from_numpy,
                                                  meta_from_numpy,
                                                  params_from_dict,
                                                  state_from_numpy)
    return (state_from_numpy(np_fields(jsolver.state)),
            meta_from_numpy(np_fields(jsolver.meta)),
            params_from_dict(dataclasses.asdict(jsolver.params)),
            chem_from_numpy(np_fields(jsolver.chem)))


def max_rel_diff(a: dict, b: dict, fields, rtol, atol) -> float:
    """Worst |a-b| / (atol + rtol |a|) over ``fields`` (the form of
    __graft_entry__.dryrun_multichip's max_rel_diff); < 1 means
    allclose(rtol, atol)."""
    worst = 0.0
    for f in fields:
        x = np.asarray(a[f], np.float64)
        y = np.asarray(b[f], np.float64)
        assert x.shape == y.shape, (f, x.shape, y.shape)
        worst = max(worst, float(np.max(np.abs(x - y)
                                        / (atol + rtol * np.abs(x)))))
    return worst


def plane_scales(want: dict, f: str) -> np.ndarray:
    """Scale of each plane of a field: its largest |value| (per equation for
    S, per species for Yc).  The two velocity components (U, V) and the two
    momentum equations (S[1], S[2]) share the vector's scale: in a stream
    along x, V and rhoV are small, and their own maxima would measure
    rounding against noise."""
    if f in ("U", "V"):
        return np.array(max(np.abs(want["U"]).max(), np.abs(want["V"]).max()))
    x = np.abs(np.asarray(want[f], np.float64))
    if x.ndim < 3:
        return np.array(x.max())
    s = x.max(axis=(1, 2))
    if f in ("S", "A", "B") and s.size == 9:
        s[1] = s[2] = max(s[1], s[2])
    return s


def scaled_err(want: dict, got: dict, f: str) -> float:
    """Largest |got - want| of a field relative to its plane's scale
    (``plane_scales``); a plane whose scale is 0 is measured absolutely."""
    x = np.asarray(want[f], np.float64)
    y = np.asarray(got[f], np.float64)
    assert x.shape == y.shape, (f, x.shape, y.shape)
    d = np.abs(x - y)
    s = plane_scales(want, f)
    if d.ndim == 3:
        d = d.reshape(d.shape[0], -1).max(axis=1)
    else:
        d = d.max()
    return float(np.max(np.where(s > 0, d / np.where(s > 0, s, 1.0), d)))


def beta_err(want: dict, got: dict, rtol=1e-6, atol=3e-6,
             floor=1e-6) -> float:
    """max_rel_diff of beta over the nodes whose equation is not at float
    noise there: |S_e| > floor * scale_e (``plane_scales``).  Elsewhere the
    residual ratio dd = |dS / S| is noise over noise, and beta, a function
    of sqrt(dd), moves by O(1) at no cost to S (pass 2 of core/step)."""
    S = np.abs(np.asarray(want["S"], np.float64))
    keep = S > floor * plane_scales(want, "S")[:, None, None]
    x = np.asarray(want["beta"], np.float64)[keep]
    y = np.asarray(got["beta"], np.float64)[keep]
    return float(np.max(np.abs(x - y) / (atol + rtol * np.abs(x)),
                        initial=0.0))
