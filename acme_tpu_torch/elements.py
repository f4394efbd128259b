"""Element library: every device model of the reference, rebuilt trace-friendly.

The port's own copy of ``acme_tpu/elements.py``: the same code and names, numpy
only; it imports nothing of ``acme_tpu``.

Coefficient-matrix conventions follow ACME.jl/src/elements.jl (cited
per element below).  Each nonlinearity is written once against an array
namespace ``xp`` (numpy on the host, jax.numpy on TPU) and must be pure and
branch-free in the *runtime* variables: data-dependent branches of the
reference are rewritten with ``xp.where`` and guarded so that both branches
stay finite (required for XLA tracing and vmap over lanes).  Branches on
*parameters* (static Python numbers) remain ordinary ``if``s.
"""

from __future__ import annotations

import math

import numpy as np

from .element import Element, NLFunc
from .utils.units import magnitude as _mag
from .utils.units import magnitude_poly as _mag_poly

__all__ = [
    "resistor", "potentiometer", "capacitor", "inductor", "transformer",
    "voltagesource", "currentsource", "voltageprobe", "currentprobe",
    "diode", "bjt", "mosfet", "opamp",
]

_INF = float("inf")



# Junction-limiting knee and linear-tail extent.  The knee must satisfy
# exp(knee)*(1 + TAIL) < 8.3e34: double-float arithmetic (ops/dfmath.py)
# Dekker-splits every product operand as 4097*a, which overflows float32
# (and NaN-poisons the EFT) beyond ~8.3e34 -- see dfmath._split.  The
# production kernel's compensated verdict runs the SAME element physics
# in df, so the limited exponential must stay representable there:
# exp(73)*(1+512) = 2.6e34 leaves a 3x margin, and exp(73) = 5e31 is
# still ~30 decades beyond any physical junction operating point.
_EXP_KNEE = 73.0
_EXP_TAIL = 512.0


def _exp(xp, arg):
    """exp, linearly extrapolated above arg = _EXP_KNEE (junction
    limiting): exp(K) * (1 + (arg - K)) -- C^1-continuous, finite in
    float32 AND under the double-float Dekker-split operand bound (see
    _EXP_KNEE above), and beyond any physical operating point.
    See _exp_pair for why a flat clamp here was a measured solver trap."""
    ex = xp.exp(xp.minimum(arg, _EXP_KNEE))
    return xp.where(arg > _EXP_KNEE,
                    ex * (1.0 + xp.minimum(arg - _EXP_KNEE, _EXP_TAIL)), ex)


def _exp_pair(xp, arg):
    """(value, derivative) of the limited exponential _exp -- the
    derivative is the TRUE slope of the limited function (exp(K),
    constant, on the linear tail), NOT vt_inv*value.

    This is the actual SPICE junction-limiting trick and it matters for
    Newton: on a pure (or flat-clamped) exponential an overshooting
    iterate walks back at ~vt per step because value/derivative == vt
    everywhere -- a multi-volt overshoot then costs ~40-100 'no progress'
    iterations, which the fused kernel's plateau exit (6 strikes) reads
    as a stall and dumps into rescue tiers that starve the same way (the
    round-4 pots-grid traversal fails, _diag_fails.py; the f64 host only
    survived by its 500-iteration patience, solvers.jl:205).  With the
    tail's true constant derivative, Newton solves the linear tail
    EXACTLY: one step lands at the knee, one or two more finish.
    Solutions never sit above the knee, so converged results are
    identical."""
    ex = xp.exp(xp.minimum(arg, _EXP_KNEE))
    over = arg > _EXP_KNEE
    val = xp.where(over,
                   ex * (1.0 + xp.minimum(arg - _EXP_KNEE, _EXP_TAIL)), ex)
    return val, xp.where(over, ex, val)

def _evalpoly(xp, x, coeffs):
    """Horner evaluation of sum(coeffs[k] * x**k)."""
    if len(coeffs) == 0:
        return xp.zeros(()) * x if hasattr(x, "shape") else 0.0
    acc = coeffs[-1] * xp.ones_like(x)
    for c in reversed(coeffs[:-1]):
        acc = acc * x + c
    return acc


# ---------------------------------------------------------------------------
# linear one- and two-ports


def resistor(r):
    """Ohm's-law resistor (ref elements.jl:16).  Pins: 1, 2.

    Accepts a plain number (Ohm) or a units Quantity (utils.units),
    mirroring the reference's Unitful extension (ext/UnitfulExt.jl)."""
    return Element(mv=-1, mi=_mag(r, "resistance"))


def potentiometer(r, pos=None):
    """Potentiometer of total resistance ``r``.

    With ``pos`` given: two fixed partial resistors (ref elements.jl:18-19).
    Without: the wiper position becomes a circuit *input*, and the element is
    nonlinear with q = (v1, v2, i1, i2, pos) (ref elements.jl:20-31).
    Pins: 1, 2 (wiper), 3.
    """
    r = _mag(r, "resistance")
    if pos is not None:
        return Element(mv=[[-1, 0], [0, -1]],
                       mi=[[r * pos, 0], [0, r * (1 - pos)]],
                       ports=[(1, 2), (2, 3)])
    r = float(r)

    def fn(xp, q):
        v1, v2, i1, i2, pos = q[0], q[1], q[2], q[3], q[4]
        res = xp.stack([v1 - r * pos * i1, v2 - r * (1 - pos) * i2])
        one = xp.ones_like(v1)
        zero = xp.zeros_like(v1)
        J = xp.stack([
            xp.stack([one, zero, -r * pos, zero, -r * i1]),
            xp.stack([zero, one, zero, -r * (1 - pos), -r * i2]),
        ])
        return res, J

    return Element(mv=[[1, 0], [0, 1], [0, 0], [0, 0], [0, 0]],
                   mi=[[0, 0], [0, 0], [1, 0], [0, 1], [0, 0]],
                   mq=(-np.eye(5)).tolist(),
                   mu=[[0], [0], [0], [0], [-1]],
                   nonlinear_eq=NLFunc(nn=2, nq=5, fn=fn, sig=("pot", r)),
                   ports=[(1, 2), (2, 3)])


def capacitor(c):
    """Capacitor with charge state (ref elements.jl:40).  Pins: 1, 2."""
    c = _mag(c, "capacitance")
    return Element(mv=[[c], [0]], mi=[[0], [1]], mx=[[-1], [0]], mxd=[[0], [-1]])


def inductor(l=None, model=None, **kwargs):
    """Inductor.  ``inductor(l)`` is linear (ref elements.jl:49).

    ``inductor(model='JA', n=..., ...)`` gives the Jiles-Atherton nonlinear
    inductor (ref elements.jl:167-168), a 1-winding JA transformer.
    Pins: 1, 2.
    """
    if model is not None:
        if str(model).upper() != "JA":
            raise ValueError(f"unknown inductor model {model!r}")
        n = kwargs.pop("n", 230)
        return transformer(model="JA", ns=[n], **kwargs)
    if l is None:
        raise TypeError("inductor(l) requires an inductance")
    l = _mag(l, "inductance")
    return Element(mv=[[1], [0]], mi=[[0], [l]], mx=[[0], [-1]], mxd=[[-1], [0]])


def transformer(l1=None, l2=None, *, coupling_coefficient=1,
                mutual_coupling=None, model=None, **ja_kwargs):
    """Two-winding linear transformer (ref elements.jl:63-68) or, with
    ``model='JA'``, the Jiles-Atherton nonlinear transformer
    (ref elements.jl:100-135).

    Linear pins: primary1/primary2, secondary1/secondary2.
    JA pins: 1, 2 (primary), 3, 4 (secondary), ...
    """
    if model is not None:
        if str(model).upper() != "JA":
            raise ValueError(f"unknown transformer model {model!r}")
        return _transformer_ja(**ja_kwargs)
    l1 = _mag(l1, "inductance")
    l2 = _mag(l2, "inductance")
    if mutual_coupling is None:
        mutual_coupling = coupling_coefficient * math.sqrt(l1 * l2)
    mutual_coupling = _mag(mutual_coupling, "inductance")
    return Element(
        mv=[[1, 0], [0, 1], [0, 0], [0, 0]],
        mi=[[0, 0], [0, 0], [l1, mutual_coupling], [mutual_coupling, l2]],
        mx=[[0, 0], [0, 0], [-1, 0], [0, -1]],
        mxd=[[-1, 0], [0, -1], [0, 0], [0, 0]],
        ports=[("primary1", "primary2"), ("secondary1", "secondary2")])


def _transformer_ja(D=2.4e-2, A=4.54e-5, ns=(), a=14.1, alpha=5e-5, c=0.55,
                    k=17.8, Ms=2.75e5):
    D = _mag(D, "length")
    A = _mag(A, "area")
    a = _mag(a, "field")
    k = _mag(k, "field")
    Ms = _mag(Ms, "field")
    """Jiles-Atherton magnetics; q = (H_eff_scaled, M_irr?, dH, dM)-like vector
    per the reference derivation (ref elements.jl:104-135).  The residual is
    scaled by 1e-4/Ms for error comparability across elements, exactly as the
    reference does."""
    ns = list(ns)
    nw = len(ns)
    mu0 = 1.2566370614e-6
    a = float(a)
    alpha = float(alpha)
    c = float(c)
    k = float(k)
    Ms = float(Ms)
    scale = 1e-4 / Ms

    def fn(xp, q):
        q1, q2, q3, q4 = q[0], q[1], q[2], q[3]
        aq1 = xp.abs(q1)
        # guard the pole at q1 == 0: the series branch is used there, so the
        # guarded value never leaks into the selected result.
        q1g = xp.where(aq1 < 1e-4, xp.ones_like(q1), q1)
        coth = 1.0 / xp.tanh(q1g)
        L = xp.where(aq1 < 1e-4, q1 / 3.0, coth - 1.0 / q1g)
        Ld = xp.where(aq1 < 1e-4, xp.full_like(q1, 1.0 / 3.0),
                      1.0 / q1g ** 2 - coth ** 2 + 1.0)
        q1g3 = xp.where(aq1 < 1e-3, xp.ones_like(q1), q1)
        coth3 = 1.0 / xp.tanh(q1g3)
        Ld2 = xp.where(aq1 < 1e-3, -2.0 / 15.0 * q1,
                       2.0 * coth3 * (coth3 ** 2 - 1.0) - 2.0 / q1g3 ** 3)
        delta = xp.where(q3 > 0, xp.ones_like(q3), -xp.ones_like(q3))
        Man = Ms * L
        deltaM = xp.where(xp.sign(q3) == xp.sign(Man - q2),
                          xp.ones_like(q3), xp.zeros_like(q3))
        den = delta * (k * (1.0 - c)) - alpha * (Man - q2)
        res = xp.stack([scale * ((1.0 - c) * deltaM * (Man - q2) / den * q3
                                 + (c * Ms / a) * (q3 + alpha * q4) * Ld - q4)])
        J11 = scale * (((1.0 - c) ** 2 * k * Ms) * deltaM * Ld * delta / den ** 2 * q3
                       + (c * Ms / a) * (q3 + alpha * q4) * Ld2)
        J12 = scale * -(1.0 - c) ** 2 * k * deltaM * delta / den ** 2 * q3
        J13 = scale * ((1.0 - c) * deltaM * (Man - q2) / den + (c * Ms / a) * Ld)
        J14 = scale * ((c * Ms / a * alpha) * Ld - 1.0)
        J = xp.stack([xp.stack([J11, J12, J13, J14])])
        return res, J

    mv = np.zeros((nw + 5, nw))
    for i in range(nw):
        mv[i, i] = 1
    mi = np.zeros((nw + 5, nw))
    mi[nw, :] = ns
    mx = np.zeros((nw + 5, 2))
    mx[nw, 0] = -math.pi * D
    mx[nw + 1, 0] = -1.0 / a
    mx[nw + 1, 1] = -alpha / a
    mx[nw + 2, 1] = -1.0
    mxd = np.zeros((nw + 5, 2))
    for i in range(nw):
        mxd[i, 0] = -mu0 * A * ns[i]
        mxd[i, 1] = -mu0 * A * ns[i]
    mxd[nw + 3, 0] = -1.0
    mxd[nw + 4, 1] = -1.0
    mq = np.zeros((nw + 5, 4))
    mq[nw + 1:, :] = np.eye(4)
    return Element(mv=mv.tolist(), mi=mi.tolist(), mx=mx.tolist(),
                   mxd=mxd.tolist(), mq=mq.tolist(),
                   nonlinear_eq=NLFunc(nn=1, nq=4, fn=fn,
                                       sig=("ja", D, A, tuple(ns), a,
                                            alpha, c, k, Ms)))


# ---------------------------------------------------------------------------
# sources and probes


def voltagesource(v=None, *, rs=0):
    """Voltage source; without ``v`` the voltage is a circuit input
    (ref elements.jl:180-183).  Pins: +, -."""
    rs = _mag(rs, "resistance")
    if v is None:
        return Element(mv=1, mi=-rs, mu=1, ports=[("+", "-")])
    return Element(mv=1, mi=-rs, u0=_mag(v, "voltage"), ports=[("+", "-")])


def currentsource(i=None, *, gp=0):
    """Current source; without ``i`` the current is a circuit input
    (ref elements.jl:196-199).  Pins: +, -."""
    gp = _mag(gp, "conductance")
    if i is None:
        return Element(mv=gp, mi=-1, mu=1, ports=[("+", "-")])
    return Element(mv=gp, mi=-1, u0=_mag(i, "current"), ports=[("+", "-")])


def voltageprobe(*, gp=0):
    """Voltage probe output row (ref elements.jl:210-211).  Pins: +, -."""
    gp = _mag(gp, "conductance")
    return Element(mv=-gp, mi=1, pv=1, ports=[("+", "-")])


def currentprobe(*, rs=0):
    """Current probe output row (ref elements.jl:223-224).  Pins: +, -."""
    rs = _mag(rs, "resistance")
    return Element(mv=1, mi=-rs, pi=1, ports=[("+", "-")])


# ---------------------------------------------------------------------------
# semiconductor devices


def diode(*, is_=1e-12, eta=1.0, **aliases):
    """Shockley diode, i = is*(exp(v/(eta*25mV)) - 1) (ref elements.jl:235-245).

    Pins: + (anode), - (cathode).
    """
    is_ = _mag(aliases.pop("is", is_), "current")
    eta = float(aliases.pop("η", eta))
    if aliases:
        raise TypeError(f"unknown diode parameters {sorted(aliases)}")
    vt_inv = 1.0 / (25e-3 * eta)

    def fn(xp, q):
        v, i = q[0], q[1]
        ex, exd = _exp_pair(xp, v * vt_inv)
        res = xp.stack([is_ * (ex - 1.0) - i])
        J = xp.stack([xp.stack([is_ * vt_inv * exd, -xp.ones_like(v)])])
        return res, J

    return Element(mv=[[1], [0]], mi=[[0], [1]], mq=[[-1, 0], [0, -1]],
                   ports=[("+", "-")],
                   nonlinear_eq=NLFunc(nn=1, nq=2, fn=fn,
                                       sig=("diode", is_, eta)))


def bjt(typ, *, is_=1e-12, eta=1.0, isc=None, ise=None, etac=None, etae=None,
        bf=1000.0, br=10.0, ile=0.0, ilc=0.0, etacl=None, etael=None,
        vaf=_INF, var=_INF, ikf=_INF, ikr=_INF, re=0.0, rc=0.0, rb=0.0,
        **aliases):
    """Gummel-Poon bipolar transistor (ref elements.jl:307-406).

    Reduces to Ebers-Moll for the default ile=ilc=0, vaf=var=ikf=ikr=inf.
    Static parameter combinations select among four closed-form residual /
    Jacobian variants (branching on *parameters* only, so the runtime function
    stays trace-free).  Unlike the reference, the leakage-diode Jacobian terms
    use the leakage emission coefficients (etael/etacl) -- the reference uses
    etae/etac there (src/elements.jl:384,395), which is an inexact Jacobian;
    converged solutions are identical, Newton convergence is slightly better.

    Pins: base, emitter, collector.
    """
    is_ = _mag(aliases.pop("is", is_), "current")
    eta = float(aliases.pop("η", eta))
    etac = aliases.pop("ηc", etac)
    etae = aliases.pop("ηe", etae)
    etacl = aliases.pop("ηcl", etacl)
    etael = aliases.pop("ηel", etael)
    bf = float(aliases.pop("βf", bf))
    br = float(aliases.pop("βr", br))
    if aliases:
        raise TypeError(f"unknown bjt parameters {sorted(aliases)}")
    isc = is_ if isc is None else _mag(isc, "current")
    ise = is_ if ise is None else _mag(ise, "current")
    ile = _mag(ile, "current")
    ilc = _mag(ilc, "current")
    if ikf != _INF:
        ikf = _mag(ikf, "current")
    if ikr != _INF:
        ikr = _mag(ikr, "current")
    if vaf != _INF:
        vaf = _mag(vaf, "voltage")
    if var != _INF:
        var = _mag(var, "voltage")
    re = _mag(re, "resistance")
    rc = _mag(rc, "resistance")
    rb = _mag(rb, "resistance")
    etac = eta if etac is None else float(etac)
    etae = eta if etae is None else float(etae)
    etacl = etac if etacl is None else float(etacl)
    etael = etae if etael is None else float(etael)

    if typ == "npn":
        polarity = 1
    elif typ == "pnp":
        polarity = -1
    else:
        raise ValueError(f"Unknown bjt type {typ!r}, must be 'npn' or 'pnp'")

    cE = 1.0 / (25e-3 * etae)
    cC = 1.0 / (25e-3 * etac)
    kf = bf / (1.0 + bf) * ise
    kr = br / (1.0 + br) * isc
    has_early = (vaf != _INF) or (var != _INF)
    has_knee = (ikf != _INF) or (ikr != _INF)

    def fn(xp, q):
        vE, vC, iE, iC = q[0], q[1], q[2], q[3]
        expE, exdE = _exp_pair(xp, vE * cE)
        expC, exdC = _exp_pair(xp, vC * cC)
        i_f = kf * (expE - 1.0)
        i_r = kr * (expC - 1.0)
        di_f1 = kf * cE * exdE
        di_r2 = kr * cC * exdC
        if not has_early and not has_knee:
            i_cc = i_f - i_r
            di_cc1 = di_f1
            di_cc2 = -di_r2
        elif has_early and not has_knee:
            q1inv = 1.0 - vE * (1.0 / var) - vC * (1.0 / vaf)
            i_cc = q1inv * (i_f - i_r)
            dq1inv1 = -1.0 / var
            dq1inv2 = -1.0 / vaf
            di_cc1 = dq1inv1 * (i_f - i_r) + q1inv * di_f1
            di_cc2 = dq1inv2 * (i_f - i_r) - q1inv * di_r2
        elif not has_early and has_knee:
            q2 = i_f * (1.0 / ikf) + i_r * (1.0 / ikr)
            qden = 1.0 + xp.sqrt(1.0 + 4.0 * q2)
            qfact = 2.0 / qden
            i_cc = qfact * (i_f - i_r)
            dq21 = di_f1 * (1.0 / ikf)
            dq22 = di_r2 * (1.0 / ikr)
            dqfact1 = -4.0 * dq21 / (qden - 1.0) / qden ** 2
            dqfact2 = -4.0 * dq22 / (qden - 1.0) / qden ** 2
            di_cc1 = dqfact1 * (i_f - i_r) + qfact * di_f1
            di_cc2 = dqfact2 * (i_f - i_r) - qfact * di_r2
        else:
            q1inv = 1.0 - vE * (1.0 / var) - vC * (1.0 / vaf)
            q2 = i_f * (1.0 / ikf) + i_r * (1.0 / ikr)
            qden = 1.0 + xp.sqrt(1.0 + 4.0 * q2)
            qfact = 2.0 * q1inv / qden
            i_cc = qfact * (i_f - i_r)
            dq1inv1 = -1.0 / var
            dq1inv2 = -1.0 / vaf
            dq21 = di_f1 * (1.0 / ikf)
            dq22 = di_r2 * (1.0 / ikr)
            dqfact1 = (2.0 * dq1inv1 * qden - q1inv * 4.0 * dq21 / (qden - 1.0)) / qden ** 2
            dqfact2 = (2.0 * dq1inv2 * qden - q1inv * 4.0 * dq22 / (qden - 1.0)) / qden ** 2
            di_cc1 = dqfact1 * (i_f - i_r) + qfact * di_f1
            di_cc2 = dqfact2 * (i_f - i_r) - qfact * di_r2
        iBE = (1.0 / bf) * i_f
        diBE1 = (1.0 / bf) * di_f1
        if ile != 0.0:
            expEl, exdEl = (_exp_pair(xp, vE * (1.0 / (25e-3 * etael)))
                            if etael != etae else (expE, exdE))
            iBE = iBE + ile * (expEl - 1.0)
            diBE1 = diBE1 + (ile / (25e-3 * etael)) * exdEl
        iBC = (1.0 / br) * i_r
        diBC2 = (1.0 / br) * di_r2
        if ilc != 0.0:
            expCl, exdCl = (_exp_pair(xp, vC * (1.0 / (25e-3 * etacl)))
                            if etacl != etac else (expC, exdC))
            iBC = iBC + ilc * (expCl - 1.0)
            diBC2 = diBC2 + (ilc / (25e-3 * etacl)) * exdCl
        one = xp.ones_like(vE)
        zero = xp.zeros_like(vE)
        res = xp.stack([i_cc + iBE - iE, -i_cc + iBC - iC])
        J = xp.stack([
            xp.stack([di_cc1 + diBE1, di_cc2, -one, zero]),
            xp.stack([-di_cc1, -di_cc2 + diBC2, zero, -one]),
        ])
        return res, J

    mq = (-polarity * np.eye(4)).tolist()
    return Element(mv=[[1, 0], [0, 1], [0, 0], [0, 0]],
                   mi=[[-(re + rb), -rb], [-rb, -(rc + rb)], [1, 0], [0, 1]],
                   mq=mq,
                   ports=[("base", "emitter"), ("base", "collector")],
                   nonlinear_eq=NLFunc(nn=2, nq=4, fn=fn,
                                       sig=("bjt", polarity, ise, isc, etae,
                                            etac, etael, etacl, bf, br, ile,
                                            ilc, vaf, var, ikf, ikr)))


def mosfet(typ, *, vt=0.7, alpha=2e-5, lam=0.0, **aliases):
    """Square-law MOSFET with channel-length modulation (ref elements.jl:433-481).

    ``vt`` and ``alpha`` may be tuples of polynomial coefficients in v_GS.
    The three operating regions of the reference become ``xp.where`` selects
    over everywhere-finite polynomial expressions.

    Pins: gate, source, drain.
    """
    alpha = aliases.pop("α", alpha)
    lam = float(aliases.pop("λ", lam))
    if aliases:
        raise TypeError(f"unknown mosfet parameters {sorted(aliases)}")
    if typ == "n":
        polarity = 1.0
    elif typ == "p":
        polarity = -1.0
    else:
        raise ValueError(f"Unknown mosfet type {typ!r}, must be 'n' or 'p'")
    # polynomial coefficients in v_GS: degree-k coefficient of vt carries
    # V^(1-k), of alpha A/V^(2+k) (ref ext/UnitfulExt.jl:89-110)
    vt = tuple(_mag_poly(v, "voltage", k) if hasattr(v, "dims") else float(v)
               for k, v in enumerate(np.atleast_1d(vt)))
    alpha = tuple(_mag_poly(v, "transconductance", k)
                  if hasattr(v, "dims") else float(v)
                  for k, v in enumerate(np.atleast_1d(alpha)))
    dvt = tuple(c * (i + 1) for i, c in enumerate(vt[1:]))
    dalpha = tuple(c * (i + 1) for i, c in enumerate(alpha[1:]))

    def fn(xp, q):
        vgs, vds, id_ = q[0], q[1], q[2]
        pv = polarity * vgs
        a_ = _evalpoly(xp, pv, alpha)
        da_ = _evalpoly(xp, pv, dalpha) if dalpha else xp.zeros_like(vgs)
        vt_ = _evalpoly(xp, pv, vt)
        dvt_ = _evalpoly(xp, pv, dvt) if dvt else xp.zeros_like(vgs)
        lam_ = xp.where(vds >= 0, xp.full_like(vds, lam), xp.zeros_like(vds))
        ov = vgs - vt_          # overdrive voltage
        one = xp.ones_like(vgs)
        zero = xp.zeros_like(vgs)

        # cutoff: vgs <= vt
        res_off = -id_
        J_off = (zero, zero)
        # triode: vds <= vgs - vt (and vgs > vt)
        clm = 1.0 + lam_ * vds
        res_tri = a_ * (ov - 0.5 * vds) * vds * clm - id_
        J_tri = (a_ * (1.0 - dvt_) * vds * clm + da_ * (ov - 0.5 * vds) * vds * clm,
                 a_ * (ov + vds * (2.0 * lam_ * (ov - 0.75 * vds) - 1.0)))
        # saturation
        res_sat = (a_ / 2.0) * ov ** 2 * clm - id_
        J_sat = (a_ * ov * (1.0 - dvt_) * clm + da_ / 2.0 * ov ** 2 * clm,
                 lam_ * a_ / 2.0 * ov ** 2)

        off = vgs <= vt_
        tri = xp.logical_and(xp.logical_not(off), vds <= ov)
        res0 = xp.where(off, res_off, xp.where(tri, res_tri, res_sat))
        J0 = xp.where(off, zero, xp.where(tri, J_tri[0], J_sat[0]))
        J1 = xp.where(off, zero, xp.where(tri, J_tri[1], J_sat[1]))
        res = xp.stack([res0])
        J = xp.stack([xp.stack([J0, J1, -one])])
        return res, J

    mq = (polarity * np.array([[1.0, 0, 0], [0, 1, 0], [0, 0, 1], [0, 0, 0]])).tolist()
    return Element(mv=[[-1, 0], [0, -1], [0, 0], [0, 0]],
                   mi=[[0, 0], [0, 0], [0, -1], [1, 0]],
                   mq=mq,
                   ports=[("gate", "source"), ("drain", "source")],
                   nonlinear_eq=NLFunc(nn=1, nq=3, fn=fn,
                                       sig=("mosfet", polarity, vt, alpha,
                                            lam)))


def opamp(*, maxgain=_INF, gain_bw_prod=_INF, model=None, gain=None,
          vomin=None, vomax=None):
    """Operational amplifier.

    Default: linear VCVS / nullor with optional finite ``maxgain`` and
    one-pole ``gain_bw_prod`` (ref elements.jl:508-517).
    ``opamp(model='macak', gain=..., vomin=..., vomax=...)``: tanh-clipping
    opamp (ref elements.jl:536-551).

    Pins: in+, in-, out+, out-.
    """
    ports = [("in+", "in-"), ("out+", "out-")]
    if model is not None:
        if str(model).lower() != "macak":
            raise ValueError(f"unknown opamp model {model!r}")
        gain = float(gain)
        vomin = _mag(vomin, "voltage")
        vomax = _mag(vomax, "voltage")
        offset = 0.5 * (vomin + vomax)
        scale = 0.5 * (vomax - vomin)

        def fn(xp, q):
            vi, vo = q[0], q[1]
            vi_scaled = vi * (gain / scale)
            t = xp.tanh(vi_scaled)
            res = xp.stack([t * scale - vo])
            # d/dvi tanh = sech^2 = 1 - tanh^2 (bounded, overflow-free)
            J = xp.stack([xp.stack([gain * (1.0 - t * t), -xp.ones_like(vi)])])
            return res, J

        return Element(mv=[[0, 0], [1, 0], [0, 1]], mi=[[1, 0], [0, 0], [0, 0]],
                       mq=[[0, 0], [-1, 0], [0, -1]],
                       u0=[[0], [0], [offset]],
                       nonlinear_eq=NLFunc(nn=1, nq=2, fn=fn,
                                           sig=("macak", gain, vomin, vomax)),
                       ports=ports)
    if gain_bw_prod == _INF:  # avoid an unnecessary state
        inv_gain = 0.0 if maxgain == _INF else 1.0 / maxgain
        return Element(mv=[[0, 0], [1, -inv_gain]], mi=[[1, 0], [0, 0]],
                       ports=ports)
    g1 = 1.0 if maxgain == _INF else 1.0 / math.sqrt(1.0 - 1.0 / maxgain ** 2)
    g2 = 0.0 if maxgain == _INF else 1.0 / math.sqrt(maxgain ** 2 - 1.0)
    return Element(mv=[[0, 0], [-g1, 0], [0, -1]], mi=[[1, 0], [0, 0], [0, 0]],
                   mx=[[0], [g2], [1]], mxd=[[0], [1.0 / (2 * math.pi * gain_bw_prod)], [0]],
                   ports=ports)
