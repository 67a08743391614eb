"""1-D isentropic gas dynamics: the `Flow` / `Flow2D` state objects.

Host-side re-implementation of the reference libFlow layer
(libFlow/flow.hpp:20-132, libFlow/flow.cpp, libFlow/flow2d.cpp).  These run
once at deck-load time to convert boundary-condition specifications
(static/total p,T + velocity/Mach) into stagnation state + velocity, so plain
Python floats are the right tool — no JAX here.

The gas-dynamic functions of the speed coefficient lambda = W/a_kr:

    tau(l) = 1 - (k-1)/(k+1) l^2          T/T0
    pi(l)  = tau^(k/(k-1))                p/p0
    eps(l) = tau^(1/(k-1))                rho/rho0
    q(l)   = ((k+1)/2)^(1/(k-1)) l tau^(1/(k-1))   reduced mass flux
    f(l)   = (l^2+1) tau^(1/(k-1))
    y(l)   = q/pi,  z(l) = l + 1/l,  r(l) = pi/f

Inversions use the same 100-iteration, 1%-tolerance bisection as the
reference (flow.cpp:320-362) so that derived BC states match.
"""

from __future__ import annotations

import math

TAU_F, P_F, EPS_F, Q_F, Y_F, F_F, R_F = range(7)

FV_VELOCITY = 0
FV_MACH = 1


class Flow:
    """Isentropic flow state: (k, T0, p0, R, lambda) + transport props."""

    def __init__(self, Cp: float = None, T0: float = 300.0, P0: float = 1.e5,
                 R: float = 300.0, lam: float = 0.01, mu: float = 5.e-5):
        # Default ctor in the reference initializes k=1.4, T0=300, p0=1e5,
        # R=300 and then C=k*R/(k-1) (flow.cpp:9-16,53-55).
        self._lambda = 0.01
        if Cp is None:
            self._k = 1.4
            self._t0 = 300.0
            self._p0 = 1.e5
            self._r = 300.0
            self.C = self._k * self._r / (self._k - 1.0)
        else:
            self.C = Cp
            self._k = Cp / (Cp - R)
            self._t0 = T0
            self._p0 = P0
            self._r = R
        self.lam = lam
        self.mu = mu

    # -- gas-dynamic functions (static in lambda) --------------------------
    def _tau(self, l: float) -> float:
        k = self._k
        return 1.0 - (k - 1.0) / (k + 1.0) * l * l

    def _pf(self, l: float) -> float:
        return self._tau(l) ** (self._k / (self._k - 1.0))

    def _eps(self, l: float) -> float:
        return self._tau(l) ** (1.0 / (self._k - 1.0))

    def _qf(self, l: float) -> float:
        k = self._k
        return ((k + 1.0) / 2.0) ** (1.0 / (k - 1.0)) * l * \
            (1.0 - (k - 1.0) / (k + 1.0) * l * l) ** (1.0 / (k - 1.0))

    def _ff(self, l: float) -> float:
        return (l * l + 1.0) * self._tau(l) ** (1.0 / (self._k - 1.0))

    def _yf(self, l: float) -> float:
        return self._qf(l) / self._pf(l)

    def _zf(self, l: float) -> float:
        return l + 1.0 / l

    def _rf(self, l: float) -> float:
        return self._pf(l) / self._ff(l)

    def _func(self, fid: int, l: float) -> float:
        return (self._tau, self._pf, self._eps, self._qf, self._yf,
                self._ff, self._rf)[fid](l)

    # -- bisection inversion (flow.cpp:320-362) ----------------------------
    def _invert(self, fid: int, val: float, area: int = None) -> float:
        if area is None:
            lmax, lmin = self.lam_max(), 0.01
        elif area < 0:
            lmax, lmin = 0.01, 1.0
        else:
            lmax, lmin = self.lam_max(), 1.0
        it = 0
        while True:
            it += 1
            test = (lmax + lmin) / 2.0
            if self._func(fid, test) < val:
                lmax = test
            else:
                lmin = test
            if it > 100:
                return -1.0
            if abs((val - self._func(fid, test)) / val) <= 0.01:
                return test

    # -- public accessors mirroring the reference API ----------------------
    def lam_max(self) -> float:
        return math.sqrt((self._k + 1.0) / (self._k - 1.0))

    LMAX = lam_max

    def kg(self, new_k: float = None) -> float:
        if new_k is not None:
            if new_k <= 0.0:
                return -1.0
            self._k = new_k
        return self._k

    def Rg(self, new_r: float = None) -> float:
        if new_r is not None:
            if new_r <= 0.0:
                return -1.0
            self._r = new_r
        return self._r

    def T0(self, new_t0: float = None) -> float:
        if new_t0 is not None and new_t0 > 0.0:
            self._t0 = new_t0
        return self._t0

    def P0(self, new_p0: float = None) -> float:
        if new_p0 is not None and new_p0 > 0.0:
            self._p0 = new_p0
        return self._p0

    def LAM(self, new_l: float = None) -> float:
        if new_l is not None:
            if not (0.0 < new_l < self.lam_max()):
                return -1.0
            self._lambda = new_l
        return self._lambda

    def TAU(self, new_tau: float = None) -> float:
        if new_tau is not None:
            if not (0.0 < new_tau < 1.0):
                return -1.0
            self._lambda = self._invert(TAU_F, new_tau)
        return self._tau(self._lambda)

    def PF(self, new_pi: float = None) -> float:
        if new_pi is not None:
            if not (0.0 < new_pi < 1.0):
                return -1.0
            self._lambda = self._invert(P_F, new_pi)
        return self._pf(self._lambda)

    def EPS(self, new_eps: float = None) -> float:
        if new_eps is not None:
            self._lambda = self._invert(EPS_F, new_eps)
        return self._eps(self._lambda)

    def QF(self, new_q: float = None, area: int = 1) -> float:
        if new_q is not None:
            l = self._invert(Q_F, new_q, area)
            if l <= 0.0:
                return -1.0
            self._lambda = l
        return self._qf(self._lambda)

    def YF(self, new_y: float = None) -> float:
        if new_y is not None:
            self._lambda = self._invert(Y_F, new_y)
        return self._yf(self._lambda)

    def FF(self, new_f: float = None, area: int = 1) -> float:
        if new_f is not None:
            self._lambda = self._invert(F_F, new_f, area)
        return self._ff(self._lambda)

    def RF(self, new_r: float = None) -> float:
        if new_r is not None:
            self._lambda = self._invert(R_F, new_r)
        return self._rf(self._lambda)

    def ZF(self, new_z: float = None, area: int = 1) -> float:
        if new_z is not None:
            if new_z * new_z < 4.0:
                return -1.0
            if area < 0:
                self._lambda = (new_z - math.sqrt(new_z * new_z - 3.999999)) / 2
            else:
                self._lambda = (new_z + math.sqrt(new_z * new_z - 3.999999)) / 2
        return self._zf(self._lambda)

    def Akr(self) -> float:
        """Critical speed sqrt(2k/(k+1) R T0) (flow.cpp:189-191)."""
        return math.sqrt(2.0 * self._k / (self._k + 1.0) * self._r * self._t0)

    def Asound(self) -> float:
        """Local speed of sound sqrt(k R T0 tau) (flow.cpp:198-200)."""
        return math.sqrt(self._k * self._r * self._t0 * self._tau(self._lambda))

    def Wg(self, new_w: float = None) -> float:
        if new_w is not None:
            if new_w <= 0.0:
                return -1.0
            if new_w >= self.Akr() * self.lam_max():
                return -1.0
            self._lambda = new_w / self.Akr()
            return new_w
        return self._lambda * self.Akr()

    def MACH(self, new_m: float = None) -> float:
        if new_m is not None:
            if new_m < 0.0:
                return -1.0
            k = self._k
            self._lambda = math.sqrt((k + 1.0) / 2.0 * new_m * new_m
                                     / (1.0 + (k - 1.0) / 2.0 * new_m * new_m))
            return new_m
        # C++ Flow::MACH() calls the non-virtual Flow::Wg().
        return Flow.Wg(self) / self.Asound()

    def Tg(self, new_t: float = None) -> float:
        if new_t is not None:
            if not (0.0 < new_t < self._t0):
                return -1.0
            self._lambda = self._invert(TAU_F, new_t / self._t0)
        return self._t0 * self._tau(self._lambda)

    def Pg(self, new_p: float = None) -> float:
        if new_p is not None:
            if new_p >= self._p0:
                return self.Pg()
            self.PF(new_p / self._p0)
        return self._p0 * self._pf(self._lambda)

    def ROG(self) -> float:
        """Static density eps * p0 / (R T0) (flow.hpp:79-81)."""
        return self.EPS() * self._p0 / self._r / self._t0

    def Pr(self) -> float:
        return self.C * self.mu / self.lam

    def BF(self) -> float:
        return math.sqrt(1.0 - 1.0 / self._k / self._k)

    def AF(self) -> float:
        k = self._k
        return k * (2.0 / (k + 1.0)) ** (k / (k - 1.0)) * \
            math.sqrt((k + 1.0) / (k - 1.0))

    def correct_flow(self, T: float, p: float, ref_val: float,
                     fv: int = FV_MACH) -> None:
        """Iterate (T0, p0) so static T, p are attained at the given
        Mach / velocity (flow.cpp:377-406)."""
        # NOTE: the C++ original calls the *non-virtual* Flow::MACH/Flow::Wg
        # here, so Flow2D's angle-preserving overrides must not kick in —
        # call the base-class methods explicitly.
        it = 0
        res_p = res_t = 1.0
        if fv == FV_MACH:
            while (res_p > 1e-4 or res_t > 1e-4) and it < 100:
                Flow.MACH(self, ref_val)
                self._t0 = T / self._tau(self._lambda)
                self._p0 = p / self._pf(self._lambda)
                res_p = abs((self._p0 - p / self._pf(self._lambda)) / self._p0)
                res_t = abs((self._t0 - T / self._tau(self._lambda)) / self._t0)
                Flow.Wg(self, ref_val * self.Asound())
                it += 1
        else:  # FV_VELOCITY
            while (res_p > 1e-4 or res_t > 1e-4) and it < 100:
                Flow.MACH(self, ref_val / self.Asound())
                self._t0 = T / self._tau(self._lambda)
                self._p0 = p / self._pf(self._lambda)
                res_p = abs((self._p0 - p / self._pf(self._lambda)) / self._p0)
                res_t = abs((self._t0 - T / self._tau(self._lambda)) / self._t0)
                Flow.Wg(self, ref_val)
                it += 1

    CorrectFlow = correct_flow

    def copy(self) -> "Flow":
        f = Flow.__new__(Flow)
        f.__dict__.update(self.__dict__)
        return f


class Flow2D(Flow):
    """Flow with velocity components (U, V) (libFlow/flow2d.hpp:13-110)."""

    def __init__(self, mu: float = None, lam: float = None, Cp: float = None,
                 T: float = None, P: float = None, R: float = None,
                 u: float = 0.0, v: float = 0.0, flow: Flow = None):
        if flow is not None:
            super().__init__(flow.C, flow._t0, flow._p0, flow._r,
                             flow.lam, flow.mu)
            self._lambda = flow._lambda
        elif Cp is not None:
            super().__init__(Cp, T, P, R, lam, mu)
        else:
            super().__init__()
        self._u = u
        self._v = v
        if flow is not None or Cp is not None:
            w = math.sqrt(u * u + v * v + 1.e-12)
            Flow.Wg(self, w)
        else:
            self._u = Flow.Wg(self)
            self._v = 0.0

    def U(self, u: float = None) -> float:
        if u is not None:
            self._u = u
            Flow.Wg(self, math.sqrt(self._u ** 2 + self._v ** 2 + 1.e-12))
        return self._u

    def V(self, v: float = None) -> float:
        if v is not None:
            self._v = v
            Flow.Wg(self, math.sqrt(self._u ** 2 + self._v ** 2 + 1.e-12))
        return self._v

    def Wg(self, u: float = None, v: float = None) -> float:
        if u is not None and v is not None:
            self._u, self._v = u, v
            return Flow.Wg(self, math.sqrt(u * u + v * v + 1.e-12))
        if u is not None:
            return Flow.Wg(self, u)
        # flow2d.hpp:68-70: Wg() returns sqrt(U^2+V^2+1e-5)
        return math.sqrt(self._u ** 2 + self._v ** 2 + 1.e-5)

    def MACH(self, m: float = None) -> float:
        if m is None:
            return Flow.MACH(self)
        # flow2d.hpp:46-66: preserve the flow angle when resetting Mach.
        if self._v != 0.0:
            angle = math.atan(self._v / self._u)
            Flow.MACH(self, m)
            self._u = Flow.Wg(self) * math.cos(angle)
            self._v = Flow.Wg(self) * math.sin(angle)
        else:
            Flow.MACH(self, m)
            if self._v == 0.0:
                self._u = Flow.Wg(self)
            elif self._u == 0.0:
                self._v = Flow.Wg(self)
        return Flow.MACH(self)

    def correct_flow(self, T: float, p: float, ref_val: float,
                     fv: int = FV_MACH) -> None:
        Flow.correct_flow(self, T, p, ref_val, fv)

    CorrectFlow = correct_flow
