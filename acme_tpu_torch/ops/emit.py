"""Write the model-specific CUDA header of the fused kernel.

The hand-written kernel (``csrc/step.cuh``) is generic over the model; the
header this module writes supplies everything the JAX kernel baked into
its instruction stream (``FusedRunner._build``, fused.py:852-1003):

* every prepared coefficient as a literal: float32 values for the plain
  dots, (a, rem) splits of the float64 values for the EFT dots, (hi, lo)
  df constants for the df Jacobian -- structural zeros skipped exactly
  where ``_build`` skips them, and the terms summed in the same order;
  a coefficient that varies between the models of a multi-model runner
  (``fused._Var``) is instead a read of the lane's entry of the (hi, lo)
  coefficient tables (``cv[i]``, ``cvl[i]``), whose values are kernel
  arguments: one build serves every list of models with the same pattern
  of varying entries;
* per subsystem, the element physics (residual and Jacobian) as
  ``__host__ __device__`` functions in float32 and in df, emitted by
  running the element's own ``nl(xp, q)`` through a *recording* ``xp``.
  The element code is branch-free in runtime values by design
  (``acme_tpu/elements.py:5-9``), so one recording is the whole function.

Every function of the header is force-inlined into the step, so its
arrays are the caller's, indexed by constants, and stay in registers (a
call would take their addresses and put them in the thread's local-memory
frame; the Jacobian's constant entries then fold into the step).  The
lane's carry (x, z, their lo parts, the per-lane coefficients and input
values) is read through a view of its place in the block's shared
memory, the template parameter ``C``.

The file name carries a hash of its own text.
"""

from __future__ import annotations

import hashlib
import os

import numpy as np

from .dfmath import _const
from .fused import _Var, _nz

__all__ = ["model_header", "write_header", "op_counts", "engine_layout",
           "engine_header", "write_engine_header", "engine_op_counts"]


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


def _r(v):
    """A literal of the engine's real type R for the float64 ``v``: its
    float64 value, rounded to R by the cast (as a weakly typed scalar
    takes the array's type in numpy, JAX and torch)."""
    v = float(v)
    if v != v:
        return "((R)NAN)"
    if v in (float("inf"), float("-inf")):
        return "((R)INFINITY)" if v > 0 else "((R)(-INFINITY))"
    return f"((R){v.hex()})"


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
        "neg": "(-{a})", "exp": "exp_f32({a})", "expm1": "expm1f({a})",
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


# the float64 scan engine's physics, a template over its real type R
# (float64 or float32; csrc/dense.cuh's e_* helpers)
_REAL = dict(_F32, exp="e_exp({a})", expm1="e_expm1({a})",
             tanh="e_tanh({a})", sqrt="e_sqrt({a})", abs="e_abs({a})",
             sign="e_sign({a})", min="e_min({a}, {b})",
             max="e_max({a}, {b})", isfinite="e_finite({a})")


def _emit_fn(name, g, res, Jq, nq, mode):
    """C++ body of ``name(q, res, Jq)`` for one recorded subsystem; with
    ``res`` or ``Jq`` None, of ``name(q, Jq)`` or ``name(q, res)``, which
    compute only the nodes that output needs.  ``mode``: "f32" (float),
    "df" (double-float pairs) or "real" (the engine's template over its
    real type R, float64 or float32)."""
    T = {"df": "df", "real": "R"}.get(mode, "float")
    tab = {"df": _DF, "real": _REAL}.get(mode, _F32)
    lit = _r if mode == "real" else _f
    outs = list(res or ()) + [i for row in Jq or () for i in row]
    live = _live(g, outs)
    lines = []
    names = {}

    def ref(a, kind="v"):
        if isinstance(a, float):
            return _df(a) if (mode == "df" and kind == "v") else lit(a)
        return names[a]

    for i, (op, args, kind) in enumerate(g.nodes):
        if i not in live:
            continue
        if op == "in":
            names[i] = f"q[{args[0]}]"
            continue
        if op == "const":
            names[i] = _df(args[0]) if mode == "df" else lit(args[0])
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
                {"df": "df(1.0f)", "real": lit(1.0)}.get(mode, "1.0f"))
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
    for a, i in enumerate(res or ()):
        lines.append(f"  res[{a}] = {ref(i)};")
    for a, row in enumerate(Jq or ()):
        for c in range(nq):
            lines.append(f"  Jq[{a * nq + c}] = {ref(row[c])};")
    sig = ", ".join([f"const {T}* q"] + [f"{T}* res"] * (res is not None)
                    + [f"{T}* Jq"] * (Jq is not None))
    attr = {"real": "template <class R> HD static inline"}.get(
        mode, "ACME_FORCEINLINE HD static")
    return f"  {attr} void {name}({sig}) {{\n" + "\n".join(
        "  " + ln for ln in lines) + "\n  }\n"


# -- EFT dots and plain dots ---------------------------------------------------

# the parameters through which the generated functions read the lane's
# per-lane coefficients (hi and lo rows of the tables): views of the
# lane's carry (csrc/step.cuh Col), a template parameter C of every
# function that takes them, which also reads x, xlo, z, zlo and the
# lane's input values there
CV = "const C& cv, const C& cvl"
# the attributes of a generated function that takes them: force-inlined,
# so no array of the caller has its address taken by a call
FN = "template <class C> ACME_FORCEINLINE HD static"
GFN = "template <class C> ACME_FORCEINLINE HD"
# those that also take a subsystem's pfull pair: a view of the lane's
# carry (the sample's) or a pointer to an array (the homotopy's), P
FNP = "template <class C, class P> ACME_FORCEINLINE HD static"


def _czero(cf):
    """Structural zero: only a constant can be skipped (fused.py czero)."""
    return not isinstance(cf, _Var) and cf == 0.0


def _cval(cf):
    """A coefficient in a float32 expression: its literal, or the lane's
    table entry (fused.py cval)."""
    return f"cv[{cf.i}]" if isinstance(cf, _Var) else _f(cf)


def _cval_df(cf):
    """A coefficient as a df operand: the (hi, lo) constant, or the lane's
    float32 table entry with a zero lo (dfmath coerces a tensor so)."""
    return f"df(cv[{cf.i}])" if isinstance(cf, _Var) else _df(cf)


def _hi_lo(cs):
    """The (hi, lo) initializer of an EFT accumulation (fused.py
    coef_hi_lo)."""
    if isinstance(cs, _Var):
        return f"cv[{cs.i}]", f"cvl[{cs.i}]"
    return _f(cs[0]), _f(cs[3])


def _eft_terms(coef_sp, vals, vlos):
    """Lines accumulating sum coef*val into (hi, lo) (fused.py dot_df)."""
    out = []
    for idx, cs in enumerate(coef_sp):
        if not _nz(cs) or vals[idx] is None:
            continue
        # a per-lane coefficient always adds its lo * v (fused.py prod_coef)
        has_rem = isinstance(cs, _Var) or cs[3] != 0.0
        a, rem = _hi_lo(cs)
        vlo = vlos[idx] if vlos is not None else None
        out.append(
            f"eft_acc<{str(has_rem).lower()}, {str(vlo is not None).lower()}>"
            f"(hi, lo, {a}, {rem}, {vals[idx]}, "
            f"{vlo if vlo is not None else '0.0f'});")
    return out


def _dotv_expr(coeffs, vals, acc=None):
    """Plain float32 dot with structural zeros skipped (fused.py dotv),
    continuing the sum ``acc``; None when every coefficient is zero."""
    for cf, v in zip(coeffs, vals):
        if _czero(cf) or v is None:
            continue
        term = f"{_cval(cf)} * {v}"
        acc = term if acc is None else f"({acc}) + {term}"
    return acc


def _dotv_rows(rows, base=None):
    """One plain float32 sum over several (coefficient row, values) pairs
    in order, then ``+ base`` (fused.py:2292-2296): the expression, "0.0f"
    when it is empty."""
    acc = None
    for coeffs, vals in rows:
        acc = _dotv_expr(coeffs, vals, acc)
    if base is not None:
        acc = base if acc is None else f"({acc}) + {base}"
    return acc or "0.0f"


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
    o.append(f"  ACME_FORCEINLINE HD static float zclip(int i) {{ "
             f"const float c[{nn}] = "
             f"{{{zc}}}; return c[i]; }}")
    # p = Dq x + Eq u + Fqprev z as EFT dots (fused.py:1088-1112)
    o.append(f"  {FN} void p_of({CV}, const C& x, const C& xlo, "
             "const float* u, const C& z, const C& zlo, float* p) {")
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
    # the same p as one plain float32 sum, for df_state=False
    # (fused.py:1107-1110)
    o.append(f"  {FN} void p_plain({CV}, const C& x, const float* u, "
             "const C& z, float* p) {")
    for i in range(np_):
        expr = _dotv_rows([(s["dq"][i], xs), (s["eq"][i], us),
                           (s["fqprev"][i], zs)])
        o.append(f"    p[{i}] = {expr};")
    o.append("  }")
    # pfull = q0 + Pexp p as an EFT pair (fused.py:1113-1133)
    o.append(f"  {FNP} void pfull({CV}, const float* p, "
             "P pf, P pflo) {")
    ps = [f"p[{i}]" for i in range(np_)]
    for ci in range(nq):
        hi0, lo0 = _hi_lo(s["q0_sp"][ci])
        o.append(f"    {{ float hi = {hi0}, lo = {lo0};")
        for ln in _eft_terms(s["pexp_sp"][ci], ps, None):
            o.append("      " + ln)
        o.append(f"      pf[{ci}] = hi; pflo[{ci}] = lo; }}")
    o.append("  }")
    # pf = q0 + Pexp p, plain float32: the homotopy's at its mixed p
    # (fused.py:1520-1528) and, with compensated=False, the sample's
    # (fused.py:1134-1140)
    o.append(f"  {FNP} void pf_mix({CV}, const float* pm, "
             "P pf) {")
    pms = [f"pm[{i}]" for i in range(np_)]
    for ci in range(nq):
        acc = _dotv_expr(s["pexp"][ci], pms)
        base = _cval(s["q0"][ci])
        o.append(f"    pf[{ci}] = " + (base if acc is None
                                        else f"({acc}) + {base}") + ";")
    o.append("  }")
    # q = pf + Fq z, plain (fused.py:1213-1219)
    zz = [f"z[{i}]" for i in range(nn)]
    o.append(f"  {FNP} void q_plain({CV}, const float* z, "
             "P pf, float* q) {")
    for ci in range(nq):
        acc = _dotv_expr(s["fq"][ci], zz)
        o.append(f"    q[{ci}] = " + (f"pf[{ci}]" if acc is None
                                       else f"({acc}) + pf[{ci}]") + ";")
    o.append("  }")
    # q as an EFT pair (fused.py:1194-1212)
    o.append(f"  {FNP} void q_comp({CV}, const float* z, "
             "P pf, P pflo, float* q, float* qlo) {")
    for ci in range(nq):
        o.append(f"    {{ float hi = pf[{ci}], lo = pflo[{ci}];")
        for ln in _eft_terms(s["fq_sp"][ci], zz, None):
            o.append("      " + ln)
        o.append(f"      q[{ci}] = hi; qlo[{ci}] = lo; }}")
    o.append("  }")
    # J = Jq Fq in float32 and in df (fused.py:1270-1300)
    o.append(f"  {FN} void jac({CV}, const float* Jq, "
             "float* J) {")
    for a in range(nn):
        for b in range(nn):
            acc = None
            for ci in range(nq):
                cf = s["fq"][ci][b]
                if _czero(cf):
                    continue
                term = f"Jq[{a * nq + ci}] * {_cval(cf)}"
                acc = term if acc is None else f"({acc}) + {term}"
            o.append(f"    J[{a * nn + b}] = {acc or '0.0f'};")
    o.append("  }")
    o.append(f"  {FN} void jac_df({CV}, const df* Jq, "
             "df* J) {")
    for a in range(nn):
        for b in range(nn):
            acc = None
            for ci in range(nq):
                cf = s["fq"][ci][b]
                if _czero(cf):
                    continue
                term = f"df_mul(Jq[{a * nq + ci}], {_cval_df(cf)})"
                acc = term if acc is None else f"df_add({acc}, {term})"
            o.append(f"    J[{a * nn + b}] = {acc or 'df(0.0f)'};")
    o.append("  }")
    # sensitivity columns Jq Pexp, cols[b*NN + a] (fused.py:1692-1706)
    o.append(f"  {FN} void jp({CV}, const float* Jq, "
             "float* cols) {")
    for b in range(np_):
        for a in range(nn):
            acc = None
            for ci in range(nq):
                cf = s["pexp"][ci][b]
                if _czero(cf):
                    continue
                term = f"Jq[{a * nq + ci}] * {_cval(cf)}"
                acc = term if acc is None else f"({acc}) + {term}"
            o.append(f"    cols[{b * nn + a}] = {acc or '0.0f'};")
    o.append("  }")
    g, res, Jq = record(s["nl"], nq)
    o.append(_emit_fn("nl", g, res, Jq, nq, "f32"))
    o.append(_emit_fn("nl_df", g, res, Jq, nq, "df"))
    if plan.verdict == "df_res":
        # the df_res evaluation's two halves: the df residual alone and
        # the plain Jacobian alone (fused.py:1240-1254)
        o.append(_emit_fn("nl_df_res", g, res, None, nq, "df"))
        o.append(_emit_fn("nl_jq", g, None, Jq, nq, "f32"))
    o.append("};")
    return "\n".join(o)


# the evaluation modes of fused._Plan as the kernel's Mode values
_MODES = {None: -1, False: 0, True: 1, "df": 2, "df_res": 3}


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
             f"NU_L = {len(plan.lane_idx) + len(plan.scale_idx)}, "
             f"NVAR = {plan.nvar};")
    o.append(f"constexpr int K_NEWTON = {plan.K}, FAST_ITERS = {plan.fast}, "
             f"P_POL = {plan.P_pol}, P_FIX = {plan.P_fix}, "
             f"REFINE = {plan.refine}, VREFINE = {plan.vrefine};")
    o.append(f"constexpr float STALL_STRIKES = {_f(plan.stall_strikes)}, "
             f"PLATEAU_STRIKES = {_f(plan.plateau_strikes)}, "
             f"VTGT = {_f(0.02 * plan.tol)};")
    # the step configuration (fused._Plan): compensated pfull; df state;
    # maintain / use the extrapolated start; pivoted main-path solves; the
    # fast path (POLISH_ONLY: zero unguarded steps) with its keep test at
    # the polish target (KEEP_TOL) and its redo for every lane
    # (VERIFY_ALWAYS) or for every lane of a lane group with a lane that
    # fails it (VERIFY_GROUP); the evaluation modes (0 plain, 1 compensated, 2 df,
    # 3 df residual with a plain Jacobian; VERDICT -1: none) of the polish
    # loop, the verdict and the df rescue; the relative tolerances
    b = lambda v: str(bool(v)).lower()
    o.append(f"constexpr bool COMP = {b(plan.comp)}, "
             f"DF_STATE = {b(plan.dfs)}, EXTRAP = {b(plan.extrap)}, "
             f"EXTRAP_USE = {b(plan.extrap_use)}, PIVOT = {b(plan.pivot)}, "
             f"POLISH_ONLY = {b(plan.fast_path and not plan.fast)}, "
             f"VERIFY_ALWAYS = {b(plan.verify_always)}, "
             f"VERIFY_GROUP = {b(plan.verify_group)}, "
             f"KEEP_TOL = {b(plan.keep_tol)};")
    o.append(f"constexpr int POL_MODE = {_MODES[plan.pol_mode]}, "
             f"VERDICT = {_MODES[plan.verdict]}, "
             f"RESCUE_MODE = {_MODES[plan.rescue_mode]};")
    o.append(f"constexpr float REL_TOL = {_f(plan.rel_tol)}, "
             f"REL_GATE = {_f(plan.rel_gate)}, "
             f"REL_GATE_F = {_f(plan.rel_gate_f)}, "
             f"REL_TOL_POL = {_f(plan.rel_tol_pol)};")
    o.append(f"{GFN} void u_full(const float* ut, const C& lanes, "
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
    o.append(f"{GFN} void output_row({CV}, const C& x, const C& xlo, "
             "const float* u, const C& z, const C& zlo, float* y) {")
    for oi in range(plan.ny):
        hi0, lo0 = _hi_lo(plan.y0_sp[oi])
        o.append(f"  {{ float hi = {hi0}, lo = {lo0};")
        for ln in (_eft_terms(plan.dy_sp[oi], xs, xlos)
                   + _eft_terms(plan.ey_sp[oi], us, None)
                   + _eft_terms(plan.fy_sp[oi], zs, zlos)):
            o.append("    " + ln)
        o.append(f"    y[{oi}] = hi + lo; }}")
    o.append("}")
    o.append(f"{GFN} void state_update({CV}, const C& x, const C& xlo, "
             "const float* u, const C& z, const C& zlo, float* xn, "
             "float* xnlo) {")
    for xi in range(plan.nx):
        hi0, lo0 = _hi_lo(plan.x0_sp[xi])
        o.append(f"  {{ float hi = {hi0}, lo = {lo0};")
        for ln in (_eft_terms(plan.a_sp[xi], xs, xlos)
                   + _eft_terms(plan.b_sp[xi], us, None)
                   + _eft_terms(plan.c_sp[xi], zs, zlos)):
            o.append("    " + ln)
        o.append(f"    two_sum(hi, lo, xn[{xi}], xnlo[{xi}]); }}")
    o.append("}")
    # plain float32 read-outs for df_state=False (fused.py:2291-2334)
    o.append(f"{GFN} void output_plain({CV}, const C& x, const float* u, "
             "const C& z, float* y) {")
    for oi in range(plan.ny):
        expr = _dotv_rows([(plan.dy[oi], xs), (plan.ey[oi], us),
                           (plan.fy[oi], zs)], _cval(plan.y0[oi]))
        o.append(f"  y[{oi}] = {expr};")
    o.append("}")
    o.append(f"{GFN} void state_plain({CV}, const C& x, const float* u, "
             "const C& z, float* xn) {")
    for xi in range(plan.nx):
        expr = _dotv_rows([(plan.a[xi], xs), (plan.b[xi], us),
                           (plan.c[xi], zs)], _cval(plan.x0[xi]))
        o.append(f"  xn[{xi}] = {expr};")
    o.append("}")
    o.append("}  // namespace acme_model")
    subs = " ".join(f"F(Sub{k})" for k in range(plan.nsub))
    o.append(f"#define ACME_FOR_EACH_SUB(F) {subs}")
    return "\n".join(o) + "\n"


def write_header(plan, build_dir):
    """Write the model header into ``build_dir``; returns its path.  The
    name carries a hash of the text, so equal models share one file."""
    return _write(model_header(plan), build_dir, "acme_model")


def _write(text, build_dir, prefix):
    """Write ``text`` into ``build_dir`` as ``<prefix>_<hash>.cuh`` (once);
    returns its path."""
    h = hashlib.sha256(text.encode()).hexdigest()[:16]
    os.makedirs(build_dir, exist_ok=True)
    path = os.path.join(build_dir, f"{prefix}_{h}.cuh")
    if not os.path.exists(path):
        tmp = f"{path}.{os.getpid()}.tmp"
        with open(tmp, "w") as f:
            f.write(text)
        os.replace(tmp, path)
    return path


# -- operation counts (for the kernel's bound) --------------------------------

EFT_TERM_OPS = 10     # one compensated dot term: product, its error, two_sum
VAR_TERM_OPS = 2      # more for a per-lane coefficient: its lo * v, added
PLAIN_TERM_OPS = 2    # one plain dot term: product and sum
# float operations of one df operation of the element physics, counted in
# csrc/df.cuh (two_sum 6, quick_two_sum 3, two_prod 2; exp's 12-term
# polynomial 240); a comparison or select of collapsed values 3
DF_OPS = {"add": 11, "sub": 11, "rsub": 11, "mul": 9, "div": 12,
          "rdiv": 12, "neg": 2, "exp": 270, "expm1": 290, "tanh": 322,
          "sqrt": 12, "abs": 3, "sign": 2, "min": 3, "max": 3, "lt": 3,
          "le": 3, "gt": 3, "ge": 3, "eq": 3, "ne": 3, "and": 1, "or": 1,
          "not": 1, "isfinite": 2, "where": 2}
# the mean float operations of a df operation inside the df elimination
DF_SOLVE_OP = 10


def _eft_ops(rows):
    """Operations of the EFT dot terms of the split-coefficient rows."""
    return sum(EFT_TERM_OPS + VAR_TERM_OPS * isinstance(cs, _Var)
               for row in rows for cs in row if _nz(cs))


def _plain_ops(rows):
    """Operations of plain dots over the coefficient rows."""
    return sum(PLAIN_TERM_OPS for row in rows for cf in row
               if not _czero(cf))


def _solve_ops(n, m):
    """Float operations of the row/column-equilibrated elimination of an
    n x n system with m right-hand sides (linsolve.cuh), pivot compares
    not counted."""
    if n <= 2:
        return {1: 1 + m, 2: 3 + 6 * m}.get(n, 0)
    return 4 * n * n + (2 * n ** 3) // 3 + 2 * n * n * m


def _physics_ops(s, df, res=True, jq=True):
    """Operations of one call of the subsystem's element physics, in
    float32 (every operation 1) or in df (``DF_OPS``), over the nodes that
    the residual (``res``) and the Jacobian (``jq``) need."""
    g, r, Jq = record(s["nl"], s["nq"])
    outs = list(r) * res + [i for row in Jq for i in row] * jq
    n = 0
    for i in _live(g, outs):
        op, args, _ = g.nodes[i]
        if op in ("const", "in"):
            continue
        if not df:
            n += 1
        elif op == "pow":
            n += DF_OPS["mul"] * (2 * args[1].bit_length() - 2)
        else:
            n += DF_OPS[op]
    return n


def _eval_ops(plan, s, mode, cols=False, dfsys=False):
    """Operations of one evaluation of subsystem ``s`` in ``mode`` (False
    plain, True compensated, "df", "df_res") with its Newton step: q, the
    physics, J = Jq Fq, the residual statistics and the elimination (with
    the sensitivity columns; in df for a df-solve subsystem's df system)."""
    nn, nq, np_ = s["nn"], s["nq"], s["np"]
    nz_fq = sum(1 for row in s["fq"] for v in row if not _czero(v))
    ops = 2 * nz_fq * nn + 3 * nn * nq
    if mode is False:
        ops += 2 * nz_fq + _physics_ops(s, False)
    else:
        ops += _eft_ops(s["fq_sp"])
        if mode is True:
            ops += _physics_ops(s, False) + 2 * nn * nq
        else:
            if mode == "df_res":
                ops += (_physics_ops(s, True, jq=False)
                        + _physics_ops(s, False, res=False) + nn)
            else:
                ops += _physics_ops(s, True) + nn + nn * nq
    m = 1
    if cols and np_:
        m += np_
        ops += 2 * nn * sum(1 for row in s["pexp"] for v in row
                            if not _czero(v))
    if dfsys:
        ops += (DF_OPS["mul"] + DF_OPS["add"]) * nz_fq * nn \
            + DF_SOLVE_OP * _solve_ops(nn, m)
    else:
        ops += _solve_ops(nn, m)
    return ops


def op_counts(plan):
    """Float operations of the fused step, counted from the code this module
    emits and the configuration of ``plan``: ``(per_sample, per_eval)``.
    ``per_sample`` is the work every lane-sample does once: the dots of p,
    pfull, the output row and the state update (EFT or plain), and per
    subsystem what the configuration adds to its evaluations for certain --
    the verdict's evaluation in its tier (compensated, df or df residual,
    with the df elimination of a df-solve subsystem) and the polish loop's
    mandatory first evaluation in the loop's tier -- counted beyond a plain
    evaluation.  ``per_eval[k]`` is one plain evaluation of subsystem k
    with its Newton step.  The measured evaluations per lane-sample times
    ``per_eval`` plus ``per_sample`` is a lower bound of the kernel's
    work."""
    dots = _eft_ops if plan.dfs else _plain_ops
    coef = (lambda sp, raw: sp) if plan.dfs else (lambda sp, raw: raw)
    per_sample = 0
    per_eval = []
    for s in plan.subs:
        per_sample += dots(coef(s["dq_sp"], s["dq"])
                           + coef(s["eq_sp"], s["eq"])
                           + coef(s["fqprev_sp"], s["fqprev"]))
        per_sample += (_eft_ops(s["pexp_sp"]) if plan.comp
                       else _plain_ops(s["pexp"]) + s["nq"])
        plain = _eval_ops(plan, s, False)
        per_eval.append(plain)
        with_cols = plan.extrap
        if plan.pol_mode is not False:
            per_sample += _eval_ops(
                plan, s, plan.pol_mode,
                cols=with_cols and plan.verdict is None,
                dfsys=plan.pol_mode == "df" and s["df_slv"]) - plain
        if plan.verdict is not None:
            vmode = "df" if s["df_slv"] else plan.verdict
            per_sample += _eval_ops(plan, s, vmode, cols=with_cols,
                                    dfsys=s["df_slv"]) - plain
    per_sample += dots(coef(plan.dy_sp, plan.dy) + coef(plan.ey_sp, plan.ey)
                       + coef(plan.fy_sp, plan.fy) + coef(plan.a_sp, plan.a)
                       + coef(plan.b_sp, plan.b) + coef(plan.c_sp, plan.c))
    return per_sample, per_eval


# -- the float64 scan engine's header (csrc/scan.cu) ---------------------------

def engine_layout(nx, nu, ny, subs):
    """The layout of one lane's model block and state for the scan engine:
    ``subs`` the (nn, np, nq) of each subsystem.  Every matrix row-major,
    in the order a, b, c, x0, dy, ey, fy, y0, then per subsystem dq, eq,
    fqprev, fq, pexp, q0; the state x, then per subsystem the warm start's
    p, z and dz/dp (nn, np).  Returns {"mats": [(name, shape, offset)],
    "nmat": the block's size, "subs": per subsystem a dict of its
    offsets (matrices "m_*", warm start "s_*" after x, "off" in z),
    "ns": the state's size, "nn_total"}."""
    nnt = sum(nn for nn, _, _ in subs)
    mats, off = [], 0

    def put(name, shape):
        nonlocal off
        mats.append((name, shape, off))
        off += int(np.prod(shape))
        return mats[-1][2]

    for name, shape in (("a", (nx, nx)), ("b", (nx, nu)), ("c", (nx, nnt)),
                        ("x0", (nx,)), ("dy", (ny, nx)), ("ey", (ny, nu)),
                        ("fy", (ny, nnt)), ("y0", (ny,))):
        put(name, shape)
    out, zoff, soff = [], 0, 0
    for k, (nn, np_, nq) in enumerate(subs):
        s = {"nn": nn, "np": np_, "nq": nq, "off": zoff}
        for name, shape in (("dq", (np_, nx)), ("eq", (np_, nu)),
                            ("fqprev", (np_, nnt)), ("fq", (nq, nn)),
                            ("pexp", (nq, np_)), ("q0", (nq,))):
            s["m_" + name] = put(f"{name}{k}", shape)
        s["s_p"], s["s_z"], s["s_d"] = soff, soff + np_, soff + np_ + nn
        soff += np_ + nn + nn * np_
        zoff += nn
        out.append(s)
    return {"mats": mats, "nmat": off, "subs": out, "ns": nx + soff,
            "nn_total": nnt}


def engine_header(nx, nu, ny, subs, nls):
    """The scan engine's header for a model of these sizes (``subs`` the
    (nn, np, nq) of each subsystem, ``nls`` their element physics
    ``nl(xp, q)``): the sizes, the layout of ``engine_layout`` and per
    subsystem a struct with its sizes, offsets and physics, a template
    over the real type R.  The matrices' values are not in it: they are
    kernel arguments."""
    lay = engine_layout(nx, nu, ny, subs)
    off = {name: o for name, _, o in lay["mats"]}
    o = ["// Generated by acme_tpu_torch/ops/emit.py for the scan engine.",
         "#pragma once", '#include "dense.cuh"', "",
         "namespace acme_engine {"]
    o.append(f"constexpr int NX = {nx}, NU = {nu}, NY = {ny}, "
             f"NNT = {lay['nn_total']}, NSUB = {len(subs)}, "
             f"NS = {lay['ns']}, NMAT = {lay['nmat']};")
    o.append("constexpr int " + ", ".join(
        f"M_{n.upper()} = {off[n]}"
        for n in ("a", "b", "c", "x0", "dy", "ey", "fy", "y0")) + ";")
    for k, (s, nl) in enumerate(zip(lay["subs"], nls)):
        o.append(f"struct ESub{k} {{")
        o.append(f"  static constexpr int NN = {s['nn']}, NP = {s['np']}, "
                 f"NQ = {s['nq']}, OFF = {s['off']}, IDX = {k};")
        o.append(f"  static constexpr int S_P = {s['s_p']}, "
                 f"S_Z = {s['s_z']}, S_D = {s['s_d']};")
        o.append("  static constexpr int " + ", ".join(
            f"M_{n.upper()} = {s['m_' + n]}"
            for n in ("dq", "eq", "fqprev", "fq", "pexp", "q0")) + ";")
        g, res, Jq = record(nl, s["nq"])
        o.append(_emit_fn("nl", g, res, Jq, s["nq"], "real"))
        # the entries of Jq (row-major) that the physics sets to a constant
        # 0: J = Jq Fq and Jq Pexp skip their products
        zeros = [i * s["nq"] + c for i, row in enumerate(Jq)
                 for c, n in enumerate(row)
                 if g.nodes[n][0] == "const" and g.nodes[n][1][0] == 0.0]
        test = " || ".join(f"k == {k}" for k in zeros)
        o.append("  HD static constexpr bool jq_nonzero(int k) { return "
                 + (f"!({test})" if zeros else "true") + "; }")
        o.append("};")
    o.append("}  // namespace acme_engine")
    subs_ = " ".join(f"F(acme_engine::ESub{k})" for k in range(len(subs)))
    o.append(f"#define ACME_ENGINE_FOR_EACH_SUB(F) {subs_}")
    return "\n".join(o) + "\n"


def write_engine_header(text, build_dir):
    """Write an engine header's ``text`` into ``build_dir``; returns its
    path (named by a hash of the text)."""
    return _write(text, build_dir, "acme_engine")


def _dense_ops(n, m):
    """Float operations of Gaussian elimination on an n x n system with m
    right-hand sides (2n^3/3 + 2n^2 m, the textbook count: a lower bound
    of csrc/dense.cuh's, which updates every row at every step)."""
    return (2 * n ** 3) // 3 + 2 * n * n * m


def engine_op_counts(subs, nls, nx, nu, ny):
    """Float operations of the scan engine: ``(per_sample, per_iter)``.
    ``per_sample`` is the work every lane-sample does once: per subsystem
    p, the extrapolated start, pfull and the origin's update at the
    solution (one evaluation, Jq Pexp and an elimination with np
    right-hand sides), and y and x'.  ``per_iter[k]`` is one Newton
    iteration of subsystem k: q, the physics (every operation 1), J = Jq
    Fq, max |res| and the elimination.  The measured iterations per
    lane-sample times ``per_iter`` plus ``per_sample`` is a lower bound of
    the kernel's work (homotopy steps add evaluations it does not count)."""
    nnt = sum(nn for nn, _, _ in subs)
    per_sample = 2 * (ny + nx) * (nx + nu + nnt) + ny + nx
    per_iter = []
    for (nn, np_, nq), nl in zip(subs, nls):
        phys = _physics_ops({"nl": nl, "nq": nq}, False)
        evaluation = 2 * nq * nn + phys + 2 * nn * nn * nq
        per_iter.append(evaluation + nn + _dense_ops(nn, 1) + nn)
        per_sample += (2 * np_ * (nx + nu + nnt) + np_ + 2 * nn * np_
                       + 2 * nq * np_ + evaluation + 2 * nn * nq * np_
                       + _dense_ops(nn, np_))
    return per_sample, per_iter
