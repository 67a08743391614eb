"""Solver state, static grid metadata and configuration on torch tensors.

Counterpart of ``openhyperflow2d_tpu.core.state``:

* :class:`SolverState` — the dynamic carry of the time loop, ``(NumEq|4,
  X, Y)`` / ``(X, Y)`` tensors plus the 0-d ``dt``;
* :class:`GridMeta` — read-only per-node metadata.  The condition words
  ``CT``/``TCT`` are held as ``int32`` bit-views of the reference's
  ``uint32`` words: torch has no ``>>``/``<<`` for ``uint32`` on the CPU,
  and a bit-view keeps every bit test exact;
* :class:`SolverParams` — static configuration, same fields and defaults
  as the JAX package, with a ``torch_dtype`` property.

The ``*_from_numpy`` converters carry a JAX run's arrays into the port
(the parity tests hand both packages the same numpy arrays).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from ..config.tables import Table
from . import flags as fl


@dataclass
class SolverState:
    """Dynamic carry of the inner iteration loop."""

    S: torch.Tensor        # (9, X, Y) conservative variables
    beta: torch.Tensor     # (9, X, Y) per-eq blending factors
    A: torch.Tensor        # (9, X, Y) x-flux (convective - viscous)
    B: torch.Tensor        # (9, X, Y) y-flux
    F: torch.Tensor        # (9, X, Y) axisymmetric flux
    dSdx: torch.Tensor     # (9, X, Y)
    dSdy: torch.Tensor     # (9, X, Y)
    Src: torch.Tensor      # (9, X, Y) sources (external + turbulence)
    SrcAdd: torch.Tensor   # (9, X, Y) wall / heat sources
    U: torch.Tensor        # (X, Y) primitives
    V: torch.Tensor
    p: torch.Tensor
    Tg: torch.Tensor
    Yc: torch.Tensor       # (4, X, Y) mass fractions
    R: torch.Tensor        # (X, Y) mixture gas constant
    CP: torch.Tensor
    lam: torch.Tensor
    mu: torch.Tensor
    mu_t: torch.Tensor
    lam_t: torch.Tensor
    droYdx: torch.Tensor   # (4, X, Y)
    droYdy: torch.Tensor
    dUdx: torch.Tensor     # (X, Y) velocity/temperature gradients
    dUdy: torch.Tensor
    dVdx: torch.Tensor
    dVdy: torch.Tensor
    dTdx: torch.Tensor
    dTdy: torch.Tensor
    dkdx: torch.Tensor     # turbulence gradients
    dkdy: torch.Tensor
    depsdx: torch.Tensor
    depsdy: torch.Tensor
    y_plus: torch.Tensor   # (X, Y)
    Q_conv: torch.Tensor   # (X, Y) wall convective heat flux
    dt: torch.Tensor       # 0-d — dt for THIS iteration (one-iter lag)

    def replace(self, **kw) -> "SolverState":
        return dataclasses.replace(self, **kw)


@dataclass
class GridMeta:
    """Static per-node metadata (device-resident, read-only)."""

    CT: torch.Tensor       # (X, Y) int32 bit-view of the uint32 CT word
    TCT: torch.Tensor      # (X, Y) int32 bit-view of the uint32 TCT word
    idXl: torch.Tensor     # (X, Y) int8 neighbor-present flags
    idXr: torch.Tensor
    idYu: torch.Tensor
    idYd: torch.Tensor
    NGX: torch.Tensor      # (X, Y) int8
    NGY: torch.Tensor
    BGX: torch.Tensor      # (X, Y) wall cosines
    BGY: torch.Tensor
    Uw: torch.Tensor       # (X, Y) wall velocity
    Vw: torch.Tensor
    l_min: torch.Tensor    # (X, Y) wall distance
    i_wall: torch.Tensor   # (X, Y) int32
    j_wall: torch.Tensor


_CHEM_SPECIES = ("Fuel", "OX", "cp", "air")
_CHEM_PROPS = ("Cp", "lam", "mu")


@dataclass
class ChemTables:
    """Species property tables + constants on the device.

    Same fields as the JAX ``ChemTables``: per-species R as shape-(1,)
    tensors and (xs, ys) knot tensors of the Cp/lam/mu tables.
    """

    R_Fuel: torch.Tensor
    R_OX: torch.Tensor
    R_cp: torch.Tensor
    R_air: torch.Tensor
    Cp_Fuel_x: torch.Tensor
    Cp_Fuel_y: torch.Tensor
    Cp_OX_x: torch.Tensor
    Cp_OX_y: torch.Tensor
    Cp_cp_x: torch.Tensor
    Cp_cp_y: torch.Tensor
    Cp_air_x: torch.Tensor
    Cp_air_y: torch.Tensor
    lam_Fuel_x: torch.Tensor
    lam_Fuel_y: torch.Tensor
    lam_OX_x: torch.Tensor
    lam_OX_y: torch.Tensor
    lam_cp_x: torch.Tensor
    lam_cp_y: torch.Tensor
    lam_air_x: torch.Tensor
    lam_air_y: torch.Tensor
    mu_Fuel_x: torch.Tensor
    mu_Fuel_y: torch.Tensor
    mu_OX_x: torch.Tensor
    mu_OX_y: torch.Tensor
    mu_cp_x: torch.Tensor
    mu_cp_y: torch.Tensor
    mu_air_x: torch.Tensor
    mu_air_y: torch.Tensor

    @classmethod
    def from_tables(cls, R: dict, tables: dict, dtype=torch.float64,
                    device=None) -> "ChemTables":
        """Build from {species: R} and {(prop, species): Table}."""
        kw = {}
        for sp in _CHEM_SPECIES:
            kw[f"R_{sp}"] = torch.tensor([R[sp]], dtype=dtype, device=device)
            for prop in _CHEM_PROPS:
                t: Table = tables[(prop, sp)]
                kw[f"{prop}_{sp}_x"] = torch.as_tensor(
                    np.asarray(t.x, np.float64), dtype=dtype, device=device)
                kw[f"{prop}_{sp}_y"] = torch.as_tensor(
                    np.asarray(t.y, np.float64), dtype=dtype, device=device)
        return cls(**kw)


@dataclass(frozen=True)
class SolverParams:
    """Static solver configuration (same fields and defaults as JAX's)."""

    MaxX: int
    MaxY: int
    dx: float
    dy: float
    ft: int = fl.FT_FLAT              # FlowType (flat / axisymmetric)
    sm: int = fl.SM_EULER             # ProblemType (Euler / NS)
    tem: int = fl.TEM_k_eps_Std       # TurbExtModel
    bff: int = fl.BFF_SQR             # blending factor function
    beta0: float = 0.9
    nrbc_beta0: float = 0.25
    CFL: float = 0.1
    SigW: float = 1.0
    SigF: float = 1.0
    delta_bl: float = 0.0
    K0: float = 0.0                   # stoichiometric OX/fuel ratio
    gamma_c: float = 0.0              # chemistry completion factor
    Tf: float = 0.0                   # ignition temperature
    Ts0: float = 300.0
    Hu: tuple = (0.0, 0.0, 0.0, 0.0)  # heats of formation (fu, ox, cp, air)
    chemistry: int = fl.CRM_ZELDOVICH
    isAdiabaticWall: bool = True
    isAlternateRMS: bool = False
    TurbStartIter: int = 0
    isSrcAdd: bool = False
    turb_mod: int = 0                 # deck TurbulenceModel id
    # serial (non-MPI) reference build: dt only decreases
    # (deeps2d_core.cpp:846-852); MPI semantics are the default
    serial_dt_mode: bool = False
    # serial AlternateRMS accumulates the SIGNED residual
    # (deeps2d_core.cpp:1139-1141, 1541-1549)
    serial_rms_mode: bool = False
    # static specialization narrowed from the grid by build_case
    models: tuple = ("prandtl", "keps", "sa", "smag")
    has_walls: bool = True
    has_d2x: bool = True
    has_d2y: bool = True
    has_nrbc: bool = True
    has_ext_src: bool = True
    # chem tables ("{prop}_{species}") with strictly ascending knots
    chem_asc: tuple = ()
    # reciprocal-multiply forms of repeated divisions (last-ulp changes)
    fast_math: bool = False
    dtype: str = "float64"

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)


def ct_bits(ct) -> np.ndarray:
    """int32 bit-view of a host condition word array (uint32 semantics)."""
    return np.ascontiguousarray(
        np.asarray(ct).astype(np.int64).astype(np.uint32).view(np.int32))


def state_from_grid(grid, params: SolverParams, dt0: float,
                    device=None) -> SolverState:
    """Stage a HostGrid's dynamic fields as a SolverState."""
    dt = params.torch_dtype
    X, Y = grid.MaxX, grid.MaxY
    ne = fl.NUM_EQ

    def a(x):
        return torch.as_tensor(np.asarray(x), dtype=dt, device=device)

    def z(*shape):
        return torch.zeros(shape, dtype=dt, device=device)

    # optional per-field overrides staged through grid.extras["init_<f>"]
    # (fill-time turbulence fluxes of the area flood fill, solver/init.py)
    def ex(name, shape):
        v = grid.extras.get(f"init_{name}")
        return a(v) if v is not None else z(*shape)

    return SolverState(
        S=a(grid.S), beta=a(grid.beta),
        A=ex("A", (ne, X, Y)), B=ex("B", (ne, X, Y)), F=ex("F", (ne, X, Y)),
        dSdx=ex("dSdx", (ne, X, Y)), dSdy=ex("dSdy", (ne, X, Y)),
        Src=a(grid.Src), SrcAdd=ex("SrcAdd", (ne, X, Y)),
        U=a(grid.U), V=a(grid.V), p=a(grid.p), Tg=a(grid.Tg),
        Yc=a(grid.Y), R=a(grid.R), CP=a(grid.CP), lam=a(grid.lam),
        mu=a(grid.mu), mu_t=a(grid.mu_t), lam_t=a(grid.lam_t),
        droYdx=ex("droYdx", (4, X, Y)), droYdy=ex("droYdy", (4, X, Y)),
        dUdx=ex("dUdx", (X, Y)), dUdy=ex("dUdy", (X, Y)),
        dVdx=ex("dVdx", (X, Y)), dVdy=ex("dVdy", (X, Y)),
        dTdx=ex("dTdx", (X, Y)), dTdy=ex("dTdy", (X, Y)),
        dkdx=ex("dkdx", (X, Y)), dkdy=ex("dkdy", (X, Y)),
        depsdx=ex("depsdx", (X, Y)), depsdy=ex("depsdy", (X, Y)),
        y_plus=a(grid.y_plus), Q_conv=ex("Q_conv", (X, Y)),
        dt=torch.tensor(dt0, dtype=dt, device=device))


def meta_from_grid(grid, dtype=None, device=None) -> GridMeta:
    """Stage a HostGrid's static fields as a GridMeta.

    ``dtype``: dtype of the float planes.  Pass the case's solver dtype; the
    default follows the global float default (``torch.get_default_dtype``),
    as the JAX version follows its x64 flag.
    """
    f8 = dtype if dtype is not None else torch.get_default_dtype()

    def t(x, dt=None):
        return torch.as_tensor(np.ascontiguousarray(x), dtype=dt,
                               device=device)

    return GridMeta(
        CT=t(ct_bits(fl.ct_to_uint32(grid.CT))),
        TCT=t(ct_bits(grid.TCT)),
        idXl=t(grid.idXl.astype(np.int8)), idXr=t(grid.idXr.astype(np.int8)),
        idYu=t(grid.idYu.astype(np.int8)), idYd=t(grid.idYd.astype(np.int8)),
        NGX=t(grid.NGX), NGY=t(grid.NGY),
        BGX=t(grid.BGX, f8), BGY=t(grid.BGY, f8),
        Uw=t(grid.Uw, f8), Vw=t(grid.Vw, f8), l_min=t(grid.l_min, f8),
        i_wall=t(grid.i_wall), j_wall=t(grid.j_wall))
