"""Write the model-specific CUDA header of the fused kernel.

The hand-written kernel (``csrc/step.cuh``) is generic over the model; the
header this module writes supplies everything the JAX kernel baked into
its instruction stream (``FusedRunner._build``, fused.py:852-1003):

* every prepared coefficient as a literal: float32 values for the plain
  dots, (a, rem) splits of the float64 values for the EFT dots, (hi, lo)
  df constants for the df Jacobian -- structural zeros skipped exactly
  where ``_build`` skips them, and the terms summed in the same order;
* per subsystem, the element physics (residual and Jacobian) as
  ``__host__ __device__`` functions in float32 and in df, emitted by
  running the element's own ``nl(xp, q)`` through a *recording* ``xp``.
  The element code is branch-free in runtime values by design
  (``acme_tpu/elements.py:5-9``), so one recording is the whole function.

The file name carries a hash of its own text.
"""

from __future__ import annotations

import hashlib
import os

import numpy as np

from .dfmath import _const

__all__ = ["model_header", "write_header", "op_counts"]


def _f(v):
    """A float32 C literal for the float32 rounding of ``v`` (exact)."""
    v = float(np.float32(v))
    if v != v:
        return "NAN"
    if v in (float("inf"), float("-inf")):
        return "INFINITY" if v > 0 else "(-INFINITY)"
    return "(" + v.hex() + "f)"


def _df(v):
    hi, lo = _const(v)
    return f"df({_f(hi)}, {_f(lo)})"


# -- the recording namespace --------------------------------------------------

class _Graph:
    def __init__(self):
        self.nodes = []   # (op, args, kind) with kind "v" (value) or "b"
        self.consts = {}

    def add(self, op, args, kind="v"):
        self.nodes.append((op, tuple(args), kind))
        return Sym(self, len(self.nodes) - 1, kind)

    def const(self, v):
        v = float(v)
        key = v.hex()
        if key not in self.consts:
            self.consts[key] = self.add("const", (v,))
        return self.consts[key]


def _arg(x):
    return x.i if isinstance(x, Sym) else float(x)


class Sym:
    """One scalar value of the recorded element function."""

    __slots__ = ("g", "i", "kind")
    __array_priority__ = 1000

    def __init__(self, g, i, kind):
        self.g, self.i, self.kind = g, i, kind

    def _bin(self, op, other):
        return self.g.add(op, (self.i, _arg(other)))

    def __add__(self, o):
        return self._bin("add", o)

    __radd__ = __add__

    def __sub__(self, o):
        return self._bin("sub", o)

    def __rsub__(self, o):
        return self._bin("rsub", o)

    def __mul__(self, o):
        return self._bin("mul", o)

    __rmul__ = __mul__

    def __truediv__(self, o):
        return self._bin("div", o)

    def __rtruediv__(self, o):
        return self._bin("rdiv", o)

    def __neg__(self):
        return self.g.add("neg", (self.i,))

    def __pow__(self, n):
        if not isinstance(n, int) or n < 0:
            raise NotImplementedError("only non-negative integer powers")
        return self.g.add("pow", (self.i, n))

    def _cmp(self, op, o):
        return self.g.add(op, (self.i, _arg(o)), "b")

    def __lt__(self, o):
        return self._cmp("lt", o)

    def __le__(self, o):
        return self._cmp("le", o)

    def __gt__(self, o):
        return self._cmp("gt", o)

    def __ge__(self, o):
        return self._cmp("ge", o)

    def __eq__(self, o):
        return self._cmp("eq", o)

    def __ne__(self, o):
        return self._cmp("ne", o)

    __hash__ = object.__hash__

    def __and__(self, o):
        return self.g.add("and", (self.i, _arg(o)), "b")

    def __or__(self, o):
        return self.g.add("or", (self.i, _arg(o)), "b")

    def __invert__(self):
        return self.g.add("not", (self.i,), "b")


class _RecordingXP:
    """The ``xp`` surface of the element library, recording into a graph.
    Arrays are numpy object arrays of :class:`Sym` scalars."""

    def __init__(self, g):
        self.g = g

    def _s(self, x):
        return x if isinstance(x, Sym) else self.g.const(x)

    def _un(self, op, x):
        if isinstance(x, np.ndarray):
            return np.vectorize(lambda v: self._un(op, v), otypes=[object])(x)
        return self.g.add(op, (self._s(x).i,))

    def exp(self, x):
        return self._un("exp", x)

    def expm1(self, x):
        return self._un("expm1", x)

    def tanh(self, x):
        return self._un("tanh", x)

    def sqrt(self, x):
        return self._un("sqrt", x)

    def abs(self, x):
        return self._un("abs", x)

    def sign(self, x):
        return self._un("sign", x)

    def isfinite(self, x):
        return self.g.add("isfinite", (self._s(x).i,), "b")

    def minimum(self, a, b):
        if not isinstance(a, Sym):
            a, b = b, a
        return self.g.add("min", (a.i, _arg(b)))

    def maximum(self, a, b):
        if not isinstance(a, Sym):
            a, b = b, a
        return self.g.add("max", (a.i, _arg(b)))

    def where(self, c, a, b):
        return self.g.add("where", (c.i, _arg(a), _arg(b)))

    def logical_and(self, a, b):
        return self.g.add("and", (a.i, b.i), "b")

    def logical_not(self, a):
        return self.g.add("not", (a.i,), "b")

    def ones_like(self, x):
        return self.g.const(1.0)

    def zeros_like(self, x):
        return self.g.const(0.0)

    def full_like(self, x, v):
        return self.g.const(v)

    def zeros(self, shape, dtype=None):
        out = np.empty(tuple(shape), dtype=object)
        out.fill(self.g.const(0.0))
        return out

    def _arr(self, p):
        if isinstance(p, np.ndarray):
            return p
        a = np.empty((), dtype=object)
        a[()] = self._s(p)
        return a

    def stack(self, parts, axis=0):
        return np.stack([self._arr(p) for p in parts], axis=axis)

    def concatenate(self, parts, axis=0):
        return np.concatenate([self._arr(p) for p in parts], axis=axis)


def record(nl, nq):
    """Run ``nl(xp, q)`` on symbolic inputs; returns (graph, res ids,
    Jq ids (nn, nq))."""
    g = _Graph()
    q = np.empty((nq,), dtype=object)
    for c in range(nq):
        q[c] = g.add("in", (c,))
    xp = _RecordingXP(g)
    res, Jq = nl(xp, q)
    res = [xp._s(v).i for v in np.asarray(res, dtype=object).reshape(-1)]
    Jq = np.asarray(Jq, dtype=object)
    Jq = [[xp._s(v).i for v in row] for row in Jq]
    return g, res, Jq


# -- code generation for one recorded function --------------------------------

def _live(g, outs):
    seen = set()
    stack = list(outs)
    while stack:
        i = stack.pop()
        if i in seen:
            continue
        seen.add(i)
        op, args, _ = g.nodes[i]
        if op in ("const", "in"):
            continue
        for a in args[:3] if op != "pow" else args[:1]:
            if isinstance(a, int) and op != "in":
                stack.append(a)
    return seen


_F32 = {"add": "({a} + {b})", "sub": "({a} - {b})", "rsub": "({b} - {a})",
        "mul": "({a} * {b})", "div": "({a} / {b})", "rdiv": "({b} / {a})",
        "neg": "(-{a})", "exp": "expf({a})", "expm1": "expm1f({a})",
        "tanh": "tanhf({a})", "sqrt": "sqrtf({a})", "abs": "fabsf({a})",
        "sign": "jsign({a})", "min": "jmin({a}, {b})",
        "max": "jmax({a}, {b})", "lt": "({a} < {b})", "le": "({a} <= {b})",
        "gt": "({a} > {b})", "ge": "({a} >= {b})", "eq": "({a} == {b})",
        "ne": "({a} != {b})", "and": "({a} && {b})", "or": "({a} || {b})",
        "not": "(!{a})", "isfinite": "jfinite({a})"}

# dfmath.DF semantics: x - y is x + (-y); c - x is (-x) + c; c / x is
# DF(c) / x; comparisons compare collapsed values
_DF = {"add": "df_add({a}, {b})", "sub": "df_add({a}, df_neg({b}))",
       "rsub": "df_add(df_neg({a}), {b})", "mul": "df_mul({a}, {b})",
       "div": "df_div({a}, {b})", "rdiv": "df_div({b}, {a})",
       "neg": "df_neg({a})", "exp": "df_exp({a})", "expm1": "df_expm1({a})",
       "tanh": "df_tanh({a})", "sqrt": "df_sqrt({a})", "abs": "df_abs({a})",
       "sign": "df_sign({a})", "min": "df_min({a}, {b})",
       "max": "df_max({a}, {b})", "lt": "df_lt({a}, {b})",
       "le": "df_le({a}, {b})", "gt": "df_gt({a}, {b})",
       "ge": "df_ge({a}, {b})", "eq": "(df_val({a}) == df_val({b}))",
       "ne": "(df_val({a}) != df_val({b}))", "and": "({a} && {b})",
       "or": "({a} || {b})", "not": "(!{a})",
       "isfinite": "df_finite({a})"}


def _emit_fn(name, g, res, Jq, nq, mode):
    """C++ body of ``name(q, res, Jq)`` for one recorded subsystem."""
    T = "df" if mode == "df" else "float"
    tab = _DF if mode == "df" else _F32
    nn = len(res)
    outs = list(res) + [i for row in Jq for i in row]
    live = _live(g, outs)
    lines = []
    names = {}

    def ref(a, kind="v"):
        if isinstance(a, float):
            return _df(a) if (mode == "df" and kind == "v") else _f(a)
        return names[a]

    for i, (op, args, kind) in enumerate(g.nodes):
        if i not in live:
            continue
        if op == "in":
            names[i] = f"q[{args[0]}]"
            continue
        if op == "const":
            names[i] = _df(args[0]) if mode == "df" else _f(args[0])
            continue
        ct = "bool" if kind == "b" else T
        if op == "pow":
            # repeated squaring in dfmath.DF.__pow__ order
            base, n = names[args[0]], args[1]
            expr_out, k, step = None, n, 0
            cur = base
            while k:
                if k & 1:
                    expr_out = cur if expr_out is None else \
                        (f"df_mul({expr_out}, {cur})" if mode == "df"
                         else f"({expr_out} * {cur})")
                k >>= 1
                if k:
                    nxt = f"t{i}_{step}"
                    sq = (f"df_mul({cur}, {cur})" if mode == "df"
                          else f"({cur} * {cur})")
                    lines.append(f"  const {T} {nxt} = {sq};")
                    cur = nxt
                    step += 1
            expr = expr_out if expr_out is not None else (
                "df(1.0f)" if mode == "df" else "1.0f")
        elif op == "where":
            c, a, b = args
            a_, b_ = ref(a), ref(b)
            expr = (f"df_sel({names[c]}, {a_}, {b_})" if mode == "df"
                    else f"({names[c]} ? {a_} : {b_})")
        else:
            a = ref(args[0])
            b = ref(args[1]) if len(args) > 1 else None
            if op in ("and", "or"):
                b = names[args[1]]
            expr = tab[op].format(a=a, b=b)
        names[i] = f"t{i}"
        lines.append(f"  const {ct} t{i} = {expr};")
    for a in range(nn):
        lines.append(f"  res[{a}] = {ref(res[a])};")
    for a in range(nn):
        for c in range(nq):
            lines.append(f"  Jq[{a * nq + c}] = {ref(Jq[a][c])};")
    sig = f"const {T}* q, {T}* res, {T}* Jq"
    attr = "ACME_NOINLINE HD static" if mode == "df" else "HD static inline"
    return f"  {attr} void {name}({sig}) {{\n" + "\n".join(
        "  " + ln for ln in lines) + "\n  }\n"


# -- EFT dots and plain dots ---------------------------------------------------

def _nz(cs):
    return cs[0] != 0.0 or cs[3] != 0.0


def _eft_terms(coef_sp, vals, vlos):
    """Lines accumulating sum coef*val into (hi, lo) (fused.py dot_df)."""
    out = []
    for idx, cs in enumerate(coef_sp):
        if not _nz(cs) or vals[idx] is None:
            continue
        has_rem = cs[3] != 0.0
        vlo = vlos[idx] if vlos is not None else None
        out.append(
            f"eft_acc<{str(has_rem).lower()}, {str(vlo is not None).lower()}>"
            f"(hi, lo, {_f(cs[0])}, {_f(cs[3])}, {vals[idx]}, "
            f"{vlo if vlo is not None else '0.0f'});")
    return out


def _dotv_expr(coeffs, vals):
    """Plain float32 dot with structural zeros skipped (fused.py dotv);
    None when every coefficient is zero."""
    acc = None
    for cf, v in zip(coeffs, vals):
        if cf == 0.0 or v is None:
            continue
        term = f"{_f(cf)} * {v}"
        acc = term if acc is None else f"({acc}) + {term}"
    return acc


def _sub_struct(plan, k, s):
    nn, np_, nq = s["nn"], s["np"], s["nq"]
    nu = plan.nu
    xs = [f"x[{i}]" for i in range(plan.nx)]
    xlos = [f"xlo[{i}]" for i in range(plan.nx)]
    us = [f"u[{i}]" for i in range(nu)]
    zs = [f"z[{i}]" for i in range(plan.nn_total)]
    zlos = [f"zlo[{i}]" for i in range(plan.nn_total)]
    o = []
    o.append(f"struct Sub{k} {{")
    o.append(f"  static constexpr int NN = {nn}, NP = {np_}, NQ = {nq};")
    o.append(f"  static constexpr int OFF = {s['off']}, POFF = {s['poff']}, "
             f"DOFF = {s['doff']}, IDX = {k};")
    o.append(f"  static constexpr bool DF_SLV = "
             f"{str(s['df_slv']).lower()}, FOLD = {str(s['fold']).lower()};")
    zc = ", ".join(_f(v) for v in s["zclip"])
    o.append(f"  HD static inline float zclip(int i) {{ const float c[{nn}] = "
             f"{{{zc}}}; return c[i]; }}")
    # p = Dq x + Eq u + Fqprev z as EFT dots (fused.py:1088-1112)
    o.append("  HD static inline void p_of(const float* x, const float* xlo, "
             "const float* u, const float* z, const float* zlo, float* p) {")
    for i in range(np_):
        if s["p_rows"][i]:
            o.append("    { float hi = 0.0f, lo = 0.0f;")
            for ln in (_eft_terms(s["dq_sp"][i], xs, xlos)
                       + _eft_terms(s["eq_sp"][i], us, None)
                       + _eft_terms(s["fqprev_sp"][i], zs, zlos)):
                o.append("      " + ln)
            o.append(f"      p[{i}] = hi + lo; }}")
        else:
            o.append(f"    p[{i}] = 0.0f;")
    o.append("  }")
    # pfull = q0 + Pexp p as an EFT pair (fused.py:1113-1133)
    o.append("  HD static inline void pfull(const float* p, float* pf, "
             "float* pflo) {")
    ps = [f"p[{i}]" for i in range(np_)]
    for ci in range(nq):
        cs0 = s["q0_sp"][ci]
        o.append(f"    {{ float hi = {_f(cs0[0])}, lo = {_f(cs0[3])};")
        for ln in _eft_terms(s["pexp_sp"][ci], ps, None):
            o.append("      " + ln)
        o.append(f"      pf[{ci}] = hi; pflo[{ci}] = lo; }}")
    o.append("  }")
    # homotopy pf = q0 + Pexp pmix, plain float32 (fused.py:1520-1528)
    o.append("  HD static inline void pf_mix(const float* pm, float* pf) {")
    pms = [f"pm[{i}]" for i in range(np_)]
    for ci in range(nq):
        acc = _dotv_expr(s["pexp"][ci], pms)
        base = _f(s["q0"][ci])
        o.append(f"    pf[{ci}] = " + (base if acc is None
                                        else f"({acc}) + {base}") + ";")
    o.append("  }")
    # q = pf + Fq z, plain (fused.py:1213-1219)
    zz = [f"z[{i}]" for i in range(nn)]
    o.append("  HD static inline void q_plain(const float* z, const float* pf,"
             " float* q) {")
    for ci in range(nq):
        acc = _dotv_expr(s["fq"][ci], zz)
        o.append(f"    q[{ci}] = " + (f"pf[{ci}]" if acc is None
                                       else f"({acc}) + pf[{ci}]") + ";")
    o.append("  }")
    # q as an EFT pair (fused.py:1194-1212)
    o.append("  HD static inline void q_comp(const float* z, const float* pf,"
             " const float* pflo, float* q, float* qlo) {")
    for ci in range(nq):
        o.append(f"    {{ float hi = pf[{ci}], lo = pflo[{ci}];")
        for ln in _eft_terms(s["fq_sp"][ci], zz, None):
            o.append("      " + ln)
        o.append(f"      q[{ci}] = hi; qlo[{ci}] = lo; }}")
    o.append("  }")
    # J = Jq Fq in float32 and in df (fused.py:1270-1300)
    o.append("  HD static inline void jac(const float* Jq, float* J) {")
    for a in range(nn):
        for b in range(nn):
            acc = None
            for ci in range(nq):
                cf = s["fq"][ci][b]
                if cf == 0.0:
                    continue
                term = f"Jq[{a * nq + ci}] * {_f(cf)}"
                acc = term if acc is None else f"({acc}) + {term}"
            o.append(f"    J[{a * nn + b}] = {acc or '0.0f'};")
    o.append("  }")
    o.append("  HD static inline void jac_df(const df* Jq, df* J) {")
    for a in range(nn):
        for b in range(nn):
            acc = None
            for ci in range(nq):
                cf = s["fq"][ci][b]
                if cf == 0.0:
                    continue
                term = f"df_mul(Jq[{a * nq + ci}], {_df(cf)})"
                acc = term if acc is None else f"df_add({acc}, {term})"
            o.append(f"    J[{a * nn + b}] = {acc or 'df(0.0f)'};")
    o.append("  }")
    # sensitivity columns Jq Pexp, cols[b*NN + a] (fused.py:1692-1706)
    o.append("  HD static inline void jp(const float* Jq, float* cols) {")
    for b in range(np_):
        for a in range(nn):
            acc = None
            for ci in range(nq):
                cf = s["pexp"][ci][b]
                if cf == 0.0:
                    continue
                term = f"Jq[{a * nq + ci}] * {_f(cf)}"
                acc = term if acc is None else f"({acc}) + {term}"
            o.append(f"    cols[{b * nn + a}] = {acc or '0.0f'};")
    o.append("  }")
    g, res, Jq = record(s["nl"], nq)
    o.append(_emit_fn("nl", g, res, Jq, nq, "f32"))
    o.append(_emit_fn("nl_df", g, res, Jq, nq, "df"))
    o.append("};")
    return "\n".join(o)


def model_header(plan):
    """The header text for one prepared runner (``fused._Plan``)."""
    nu = plan.nu
    o = ["// Generated by acme_tpu_torch/ops/emit.py from a prepared "
         "FusedRunner.", "#pragma once", '#include "df.cuh"', "",
         "namespace acme_model {"]
    o.append(f"constexpr int NX = {plan.nx}, NY = {plan.ny}, "
             f"NNT = {plan.nn_total}, NPT = {plan.np_total}, "
             f"NDZ = {plan.dz_total}, NSUB = {plan.nsub}, NU = {nu}, "
             f"NU_T = {len(plan.time_idx)}, "
             f"NU_L = {len(plan.lane_idx) + len(plan.scale_idx)};")
    o.append(f"constexpr int K_NEWTON = {plan.K}, FAST_ITERS = {plan.fast}, "
             f"P_POL = {plan.P_pol}, P_FIX = {plan.P_fix}, "
             f"REFINE = {plan.refine}, VREFINE = {plan.vrefine};")
    o.append(f"constexpr float STALL_STRIKES = {_f(plan.stall_strikes)}, "
             f"PLATEAU_STRIKES = {_f(plan.plateau_strikes)}, "
             f"VTGT = {_f(0.02 * plan.tol)};")
    # the step configuration: extrapolated start or zw; polish loop
    # evaluation (0 plain, 1 compensated) and target; df verdict for every
    # subsystem (df_polish="final") or only the fragile ones
    o.append(f"constexpr bool EXTRAP_USE = {str(plan.extrap_use).lower()}, "
             f"VERDICT_DF = {str(plan.df_final).lower()};")
    o.append(f"constexpr int POL_MODE = {int(plan.df_final)};")
    o.append(f"constexpr float REL_TOL_POL = {_f(plan.rel_tol_pol)};")
    o.append("HD inline void u_full(const float* ut, const float* lanes, "
             "float* u) {")
    for jj, gi in enumerate(plan.time_idx):
        o.append(f"  u[{gi}] = ut[{jj}];")
    for jj, gi in enumerate(plan.lane_idx):
        o.append(f"  u[{gi}] = lanes[{jj}];")
    for jj, gi in enumerate(plan.scale_idx):
        o.append(f"  u[{gi}] = u[{gi}] * lanes[{len(plan.lane_idx) + jj}];")
    o.append("}")
    for k, s in enumerate(plan.subs):
        o.append(_sub_struct(plan, k, s))
    xs = [f"x[{i}]" for i in range(plan.nx)]
    xlos = [f"xlo[{i}]" for i in range(plan.nx)]
    us = [f"u[{i}]" for i in range(nu)]
    zs = [f"z[{i}]" for i in range(plan.nn_total)]
    zlos = [f"zlo[{i}]" for i in range(plan.nn_total)]
    # EFT output row and state update (fused.py:2273-2322)
    o.append("HD inline void output_row(const float* x, const float* xlo, "
             "const float* u, const float* z, const float* zlo, float* y) {")
    for oi in range(plan.ny):
        cs = plan.y0_sp[oi]
        o.append(f"  {{ float hi = {_f(cs[0])}, lo = {_f(cs[3])};")
        for ln in (_eft_terms(plan.dy_sp[oi], xs, xlos)
                   + _eft_terms(plan.ey_sp[oi], us, None)
                   + _eft_terms(plan.fy_sp[oi], zs, zlos)):
            o.append("    " + ln)
        o.append(f"    y[{oi}] = hi + lo; }}")
    o.append("}")
    o.append("HD inline void state_update(const float* x, const float* xlo, "
             "const float* u, const float* z, const float* zlo, float* xn, "
             "float* xnlo) {")
    for xi in range(plan.nx):
        cs = plan.x0_sp[xi]
        o.append(f"  {{ float hi = {_f(cs[0])}, lo = {_f(cs[3])};")
        for ln in (_eft_terms(plan.a_sp[xi], xs, xlos)
                   + _eft_terms(plan.b_sp[xi], us, None)
                   + _eft_terms(plan.c_sp[xi], zs, zlos)):
            o.append("    " + ln)
        o.append(f"    two_sum(hi, lo, xn[{xi}], xnlo[{xi}]); }}")
    o.append("}")
    o.append("}  // namespace acme_model")
    subs = " ".join(f"F(Sub{k})" for k in range(plan.nsub))
    o.append(f"#define ACME_FOR_EACH_SUB(F) {subs}")
    return "\n".join(o) + "\n"


def write_header(plan, build_dir):
    """Write the model header into ``build_dir``; returns its path.  The
    name carries a hash of the text, so equal models share one file."""
    text = model_header(plan)
    h = hashlib.sha256(text.encode()).hexdigest()[:16]
    os.makedirs(build_dir, exist_ok=True)
    path = os.path.join(build_dir, f"acme_model_{h}.cuh")
    if not os.path.exists(path):
        tmp = f"{path}.{os.getpid()}.tmp"
        with open(tmp, "w") as f:
            f.write(text)
        os.replace(tmp, path)
    return path


# -- operation counts (for the kernel's bound) --------------------------------

EFT_TERM_OPS = 10     # one compensated dot term: product, its error, two_sum


def _solve_ops(n, m):
    """Float operations of the row/column-equilibrated elimination of an
    n x n system with m right-hand sides (linsolve.cuh), pivot compares
    not counted."""
    if n <= 2:
        return {1: 1 + m, 2: 3 + 6 * m}.get(n, 0)
    return 4 * n * n + (2 * n ** 3) // 3 + 2 * n * n * m


def op_counts(plan):
    """Float operations of the fused step, counted from the code this module
    emits: ``(per_sample, per_eval)`` with ``per_sample`` the work every
    lane-sample does once (the EFT dots of p, pfull, the output row and the
    state update) and ``per_eval[k]`` one plain evaluation of subsystem k
    with its Newton step (q = pf + Fq z, the element physics, J = Jq Fq,
    the residual statistics, the elimination).  A lower bound of the
    kernel's work: the verdict's df arithmetic counts as f32."""
    per_sample = 0
    per_eval = []
    for s in plan.subs:
        nn, nq = s["nn"], s["nq"]
        eft = sum(_nz(cs) for row in s["dq_sp"] + s["eq_sp"]
                  + s["fqprev_sp"] + s["pexp_sp"] for cs in row)
        per_sample += EFT_TERM_OPS * eft
        g, res, Jq = record(s["nl"], nq)
        outs = list(res) + [i for row in Jq for i in row]
        nl_ops = sum(1 for i in _live(g, outs)
                     if g.nodes[i][0] not in ("const", "in"))
        nz_fq = sum(1 for row in s["fq"] for v in row if v != 0.0)
        per_eval.append(2 * nz_fq + nl_ops + 2 * nz_fq * nn
                        + 3 * nn * nq + _solve_ops(nn, 1))
    for rows in ((plan.dy_sp, plan.ey_sp, plan.fy_sp),
                 (plan.a_sp, plan.b_sp, plan.c_sp)):
        per_sample += EFT_TERM_OPS * sum(
            _nz(cs) for m in rows for row in m for cs in row)
    return per_sample, per_eval
