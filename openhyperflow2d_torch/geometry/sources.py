"""Volumetric gas sources (Source2D / SourceList2D).

Host-side re-implementation of hyper_flow_source.cpp:27-278: point / line
mass+energy injectors with flat or axisymmetric cell-volume weighting,
activated after their StartIter and re-applied every outer cycle
(deeps2d_core.cpp:1716-1722).

Reference quirks preserved: the y-major flat line source never writes
Src[rho] (missing else branch at hyper_flow_source.cpp:109-118), and
Src[c_index+4] is written even for c_index==4 ("mixture" -> eq 8).
The eq-8 write for mixture sources is clamped off here since eq 8 is the
turbulence eps equation — the reference would corrupt it (out-of-range
write into Src[8]); decks in the wild use c_index<4.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

from ..core import flags as fl


@dataclass
class Source2D:
    sx: int
    sy: int
    ex: int
    ey: int
    c_index: int
    Cp: float
    M_s0: float
    T: float
    T_f: float
    start_iter: int = 0

    def set_source(self, grid, src: np.ndarray, start_iter: int):
        """Apply onto the (9, X, Y) Src array (Source2D::SetSource2D)."""
        if start_iter < self.start_iter:
            return
        dx, dy = grid.dx, grid.dy
        ft_axi = grid.ft == fl.FT_AXISYMMETRIC
        DX = self.sx - self.ex
        DY = self.sy - self.ey

        def node_y(j):
            return (j + 0.5) * dy

        def write(x, y, rho_src):
            src[fl.i2d_Rho, x, y] = rho_src
            src[fl.i2d_RhoU, x, y] = 0.0
            src[fl.i2d_RhoV, x, y] = 0.0
            grid.Tf = grid.Tf   # scalar ignition temp stays global
            if self.c_index < 4:
                src[self.c_index + 4, x, y] = rho_src
            src[fl.i2d_RhoE, x, y] = self.Cp * self.T * rho_src

        if DX == 0 and DY == 0:
            if ft_axi:
                if self.sy == 0 or self.ey == 0:
                    rho_src = self.M_s0 / (math.pi * dx * dy * dy)
                else:
                    rho_src = self.M_s0 / (2 * math.pi * dx * dy
                                           * node_y(self.sy))
            else:
                rho_src = self.M_s0 / (dx * dy)
            src[fl.i2d_Rho, self.sx, self.sy] = rho_src
            src[fl.i2d_RhoU, self.sx, self.sy] = 0.0
            if self.c_index < 4:
                src[self.c_index + 4, self.sx, self.sy] = rho_src
            src[fl.i2d_RhoE, self.sx, self.sy] = self.Cp * self.T * rho_src
            return

        if abs(DX) > abs(DY):
            SKX = 1 if DX > 0 else -1
            SKY = 1 if DY > 0 else -1
            dF = abs(DY) / abs(DX)
            i = 0
            while i != DX + SKX:
                x = self.sx + i * SKX
                y = int(self.sy + abs(i) * dF * SKY)
                if ft_axi:
                    if self.sy == 0 or self.ey == 0:
                        DR = DY * dy
                        rho_src = self.M_s0 / (math.pi * dx * DR * DR)
                    else:
                        DR2 = math.pi * abs(self.sy ** 2 * dy * dy
                                            - self.ey ** 2 * dy * dy)
                        # C++ divides by zero (-> inf) for sy == ey
                        # (hyper_flow_source.cpp:82-84); keep it finite-safe
                        rho_src = self.M_s0 / (dx * DR2) if DR2 else \
                            float("inf")
                else:
                    rho_src = self.M_s0 / (dx * dy)
                write(x, y, rho_src)
                i += SKX
        else:
            SKY = 1 if DY > 0 else -1
            SKX = 1 if DX > 0 else -1
            dF = abs(DX) / abs(DY) if DY != 0 else 0.0
            i = 0
            while i != DY + SKY:
                x = int(self.sx + abs(i) * dF * SKX)
                y = self.sy + i * SKY
                if ft_axi:
                    if self.sy == 0 or self.ey == 0:
                        DR = DY * dy
                        rho_src = self.M_s0 / (math.pi * dx * DR * DR)
                    else:
                        DR2 = math.pi * abs(self.sy ** 2 * dy * dy
                                            - self.ey ** 2 * dy * dy)
                        rho_src = self.M_s0 / (dx * DR2)
                    src[fl.i2d_Rho, x, y] = rho_src
                else:
                    # reference quirk: flat y-major line sources never set
                    # Src[rho] (hyper_flow_source.cpp:109-118)
                    rho_src = src[fl.i2d_Rho, x, y]
                src[fl.i2d_RhoU, x, y] = 0.0
                src[fl.i2d_RhoV, x, y] = 0.0
                if self.c_index < 4:
                    src[self.c_index + 4, x, y] = rho_src
                src[fl.i2d_RhoE, x, y] = self.Cp * self.T * rho_src
                i += SKY


def build_source_list(deck, chem, grid) -> list:
    """SourceList2D ctor (hyper_flow_source.cpp:184-271)."""
    sources = []
    names = ["Fuel", "OX", "cp", "air"]
    n = deck.get_int("NumSrc", 0, required=False)
    for i in range(1, n + 1):
        pre = f"Src{i}"
        comp = deck.get_int(f"{pre}.GasSrcIndex", 0, required=False)
        tsrc = deck.get_float(f"{pre}.Tsrc", 0, required=False)
        if comp < 4:
            cp = chem.tables[("Cp", names[comp])].get_val(tsrc)
        else:
            y0 = deck.get_float(f"{pre}.Y_fuel", 0, required=False)
            y1 = deck.get_float(f"{pre}.Y_ox", 0, required=False)
            y2 = deck.get_float(f"{pre}.Y_cp", 0, required=False)
            y3 = 1 - y0 + y1 + y2
            cp = (y0 * chem.tables[("Cp", "Fuel")].get_val(tsrc)
                  + y1 * chem.tables[("Cp", "OX")].get_val(tsrc)
                  + y2 * chem.tables[("Cp", "cp")].get_val(tsrc)
                  + y3 * chem.tables[("Cp", "air")].get_val(tsrc))
        sources.append(Source2D(
            sx=deck.get_int(f"{pre}.GasSrcSX", 0, required=False),
            sy=deck.get_int(f"{pre}.GasSrcSY", 0, required=False),
            ex=deck.get_int(f"{pre}.GasSrcEX", 0, required=False),
            ey=deck.get_int(f"{pre}.GasSrcEY", 0, required=False),
            c_index=comp, Cp=cp,
            M_s0=deck.get_float(f"{pre}.Msrc", 0, required=False),
            T=tsrc,
            T_f=deck.get_float(f"{pre}.Tf_src", 0, required=False),
            start_iter=deck.get_int(f"{pre}.StartIter", 0, required=False)))
    return sources


def apply_sources(grid, sources: list, start_iter: int) -> np.ndarray:
    """SetSources2D over the list; returns the updated grid.Src."""
    for s in sources:
        s.set_source(grid, grid.Src, start_iter)
    return grid.Src
