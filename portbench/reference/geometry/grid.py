"""Host-side computational grid: structure-of-arrays node state.

The reference keeps a ~1.1 KB array-of-structs ``FlowNode2D`` per cell
(hyper_flow_node.hpp:130-239).  For TPU the state is laid out as a
structure of (X, Y) numpy planes built once on the host; the solver then
stages the dynamic subset as jnp arrays (see core/state.py).  Flux vectors
A/B/F/RX/RY and gradients are *not* persisted here — they are recomputed
in the fused device step (the main memory-traffic win vs the reference).

Grid construction mirrors InitDEEPS2D (libDEEPS2D/deeps2d_core.cpp:2835-4682).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..core import flags as fl
from ..gasdyn.flow import Flow, Flow2D


@dataclass
class HostGrid:
    """SoA node state, shapes (MaxX, MaxY) or (NumEq|4, MaxX, MaxY)."""

    MaxX: int
    MaxY: int
    dx: float
    dy: float
    ft: int = fl.FT_FLAT                       # FlowType
    Hu: np.ndarray = None                      # (4,) heats of formation
    Tf: float = 0.0                            # ignition temperature

    # dynamic state
    S: np.ndarray = None                       # (9, X, Y) conservative vars
    beta: np.ndarray = None                    # (9, X, Y) blending factors
    U: np.ndarray = None                       # (X, Y) velocities / primitives
    V: np.ndarray = None
    Uw: np.ndarray = None                      # wall velocities
    Vw: np.ndarray = None
    p: np.ndarray = None
    Tg: np.ndarray = None
    Y: np.ndarray = None                       # (4, X, Y) mass fractions
    R: np.ndarray = None                       # (X, Y) gas props
    CP: np.ndarray = None
    lam: np.ndarray = None
    mu: np.ndarray = None
    mu_t: np.ndarray = None
    lam_t: np.ndarray = None
    Src: np.ndarray = None                     # (9, X, Y) volumetric sources
    time: np.ndarray = None                    # (X, Y) node time stamps
    y_plus: np.ndarray = None

    # static metadata
    CT: np.ndarray = None                      # (X, Y) int64 condition bits
    TCT: np.ndarray = None                     # (X, Y) int64 turbulence bits
    idXl: np.ndarray = None                    # (X, Y) uint8 neighbor-present
    idXr: np.ndarray = None
    idYu: np.ndarray = None
    idYd: np.ndarray = None
    NGX: np.ndarray = None                     # (X, Y) int8 wall-direction
    NGY: np.ndarray = None
    BGX: np.ndarray = None                     # (X, Y) wall cosines
    BGY: np.ndarray = None
    l_min: np.ndarray = None                   # (X, Y) distance to wall
    i_wall: np.ndarray = None                  # (X, Y) int32 nearest wall idx
    j_wall: np.ndarray = None

    extras: dict = field(default_factory=dict)

    def __post_init__(self):
        X, Y = self.MaxX, self.MaxY
        ne = fl.NUM_EQ
        f8 = np.float64
        if self.Hu is None:
            self.Hu = np.zeros(4, f8)

        def z(shape, dtype=f8):
            return np.zeros(shape, dtype)

        if self.S is None:
            self.S = z((ne, X, Y))
        if self.beta is None:
            self.beta = z((ne, X, Y))
        for name in ("U", "V", "Uw", "Vw", "p", "Tg", "R", "CP", "lam", "mu",
                     "mu_t", "lam_t", "time", "y_plus", "BGX", "BGY",
                     "l_min"):
            if getattr(self, name) is None:
                setattr(self, name, z((X, Y)))
        if self.Y is None:
            self.Y = z((4, X, Y))
            self.Y[3] = 1.0   # base component (air) = 1, FlowNode2D ctor
        if self.Src is None:
            self.Src = z((ne, X, Y))
        if self.CT is None:
            self.CT = z((X, Y), np.int64)
        if self.TCT is None:
            self.TCT = z((X, Y), np.int64)
        for name in ("idXl", "idXr", "idYu", "idYd"):
            if getattr(self, name) is None:
                setattr(self, name, np.ones((X, Y), np.uint8))
        for name in ("NGX", "NGY"):
            if getattr(self, name) is None:
                setattr(self, name, np.ones((X, Y), np.int8))
        if self.BGX is not None and not self.BGX.any():
            self.BGX[:] = 1.0
            self.BGY[:] = 1.0
        if self.i_wall is None:
            self.i_wall = z((X, Y), np.int32)
        if self.j_wall is None:
            self.j_wall = z((X, Y), np.int32)

    # ------------------------------------------------------------------
    def is_cond(self, flag, i=None, j=None):
        """Vectorized isCond2D over CT."""
        ct = self.CT if i is None else self.CT[i, j]
        return (ct & flag) == flag

    def is_turb_cond(self, flag, i=None, j=None):
        tct = self.TCT if i is None else self.TCT[i, j]
        return (tct & flag) == flag

    def set_cond(self, mask_or_idx, flag):
        self.CT[mask_or_idx] |= flag

    # ------------------------------------------------------------------
    def set_node_from_flow2d(self, idx, f: Flow2D):
        """Node import ``FlowNode2D::operator=(Flow2D&)``
        (hyper_flow_node.hpp:1016-1056).

        ``idx`` is any numpy index (tuple of arrays / scalar pair) selecting
        target nodes.  The node's mass fractions ``Y`` must already be set
        (the bound/area writes them first, hyper_flow_bound.cpp:302-304).
        """
        rho = f.Pg() / f.Rg() / f.Tg()
        U, V = f.U(), f.V()
        self.U[idx] = U
        self.V[idx] = V
        self.p[idx] = f.Pg()
        self.R[idx] = f.Rg()
        self.lam[idx] = f.lam
        self.mu[idx] = f.mu
        self.Tg[idx] = f.Tg()
        self.CP[idx] = f.C
        k = f.C / (f.C - f.Rg())

        self.S[fl.i2d_Rho][idx] = rho
        self.S[fl.i2d_RhoU][idx] = rho * U
        self.S[fl.i2d_RhoV][idx] = rho * V
        self.S[fl.i2d_k][idx] = 0.0
        self.S[fl.i2d_eps][idx] = 0.0
        for c in range(fl.NUM_COMPONENTS):
            self.S[4 + c][idx] = self.Y[c][idx] * rho
        h_form = np.zeros_like(self.S[0][idx])
        rho_air = np.full_like(h_form, rho)
        for c in range(fl.NUM_COMPONENTS):
            h_form = h_form + self.Hu[c] * self.S[4 + c][idx]
            rho_air = rho_air - self.S[4 + c][idx]
        h_form = h_form + self.Hu[fl.NUM_COMPONENTS] * rho_air
        self.S[fl.i2d_RhoE][idx] = (f.Pg() / (k - 1.0)
                                    + rho * (U * U + V * V) * 0.5 + h_form)
        for eq in range(fl.NUM_EQ):
            self.Src[eq][idx] = 0.0

    def set_node_from_flow(self, idx, f: Flow):
        """Node import ``FlowNode2D::operator=(Flow&)``
        (hyper_flow_node.hpp:978-1012).

        Faithful to the reference quirks: S[RhoU] is loaded with ROG() (not
        rho*W), species use the node's *previous* density, and the new
        density comes from p0/(R*Tg) with the node's previous Tg.
        """
        rog = f.ROG()
        w = Flow.Wg(f)
        old_rho = np.array(self.S[fl.i2d_Rho][idx], copy=True)
        self.p[idx] = f.P0()
        self.R[idx] = f.Rg()
        self.lam[idx] = f.lam
        self.mu[idx] = f.mu
        self.CP[idx] = f.C
        k = f.C / (f.C - f.Rg())
        # NOTE(reference quirk): operator=(Flow&) writes RhoU=rho0, RhoV=rho0*W
        self.S[fl.i2d_RhoU][idx] = rog
        self.S[fl.i2d_RhoV][idx] = rog * w
        for c in range(fl.NUM_COMPONENTS):
            self.S[4 + c][idx] = old_rho * self.Y[c][idx]
        h_form = np.zeros_like(old_rho)
        rho_air = old_rho.copy()
        for c in range(fl.NUM_COMPONENTS):
            h_form = h_form + self.Hu[c] * self.S[4 + c][idx]
            rho_air = rho_air - self.S[4 + c][idx]
        h_form = h_form + self.Hu[fl.NUM_COMPONENTS] * rho_air
        with np.errstate(divide="ignore", invalid="ignore"):
            rho = np.where(self.Tg[idx] != 0,
                           self.p[idx] / self.R[idx] / self.Tg[idx], 0.0)
        self.S[fl.i2d_Rho][idx] = rho
        self.S[fl.i2d_RhoE][idx] = (self.p[idx] / (k - 1.0)
                                    + rho * w * w * 0.5 + h_form)
        for eq in range(fl.NUM_EQ):
            self.Src[eq][idx] = 0.0
