"""The fused sweep runner on PyTorch: the whole run loop in one CUDA kernel.

Port of ``acme_tpu/ops/fused.py`` (``FusedRunner``): a compiled
``DiscreteModel`` runs thousands of circuit instances ("lanes", e.g. a
drive x tone pot grid) through the complete per-sample pipeline of the
reference's step -- ordered subsystem Newton solves, output row, state
update -- with

  * operating-point centering and power-of-two state balancing, computed
    once in float64 on the host (the preparation below is the JAX
    package's, line for line);
  * a float32 state carried as unevaluated (hi, lo) pairs, read out and
    updated with error-free-transform (EFT) dot products;
  * the two-tier Newton of the JAX kernel in every configuration of its
    knobs: unguarded fast steps or the robust path every sample, a polish
    loop in plain,
    compensated or double-float ("df") physics, no verdict or a
    compensated, df or df-residual one with df eliminations, and the
    gated Newton -> homotopy -> df-Newton rescue ladder;
  * the two-phase power-up of a cold run: its first samples go through a
    sibling runner whose step enters through that ladder every sample,
    starts at the last solution and ends in a df verdict.
  * per-lane models: a list of same-topology models, whose differing
    coefficients reach the step as two per-lane (hi, lo) tables (``_Var``
    entries) while the equal ones stay literals.

Two implementations of that step share one preparation (``_Plan``):

  * the kernel, ``csrc/fused.cu``: one CUDA thread per lane runs the whole
    time loop with its state in registers (built by ``build.py`` from the
    hand-written sources plus the model header ``emit.py`` writes);
  * the plain version, :func:`plain_run`: the same step in torch ops
    vectorised over lanes, with every loop masked per lane.

:func:`fused_step` launches the kernel for CUDA tensors and takes the
plain version only for CPU tensors.  Loops are per lane in both (the JAX
kernel's group-wide early exits give the same per-lane results, except for
the iteration counts, which here count each lane's own trips), so a lane's
result depends on its neighbours in one configuration only, as in the JAX
kernel: ``fast_verify="group"`` with a fast path, whose keep test is one
decision for a whole lane group (``group_lanes``, partitioned as the JAX
runner partitions its grid, :func:`_group_S`): when any lane of the group
fails it, every lane of the group takes the redo.
"""

from __future__ import annotations

import collections
import contextlib
import copy
import ctypes
import warnings
from typing import NamedTuple, Sequence

import numpy as np
import torch

from . import dfmath as dfm
from .. import trace
from .. import xp as txp
from .linsolve_tiny import solve_rows

__all__ = ["FusedRunner", "FusedInfo", "fused_step", "plain_run",
           "host_step", "resident_lanes", "LAUNCHES", "LAUNCH_EVENTS"]

# launches of the CUDA kernel made by fused_step (and nowhere else), by
# library (the file name of the build, one per model and configuration;
# ``_Plan.kernel_name`` says which configuration)
LAUNCHES = collections.Counter()
# set to a list to time each launch: fused_step appends its (start, end)
# CUDA events, recorded on the launch stream just around the kernel
LAUNCH_EVENTS = None

# the lanes of one (sublane) block of the JAX kernel's grid; lane groups
# are whole blocks
LANE = 128
# the conservative configuration of the two-phase power-up (fused.py:406-416)
_POWERUP_SAFE = dict(fast_iters=0, extrapolate="track", polish_only=False,
                     df_polish="final")
# the integer power-up overrides and the runner attribute each sets
# (fused.py:2831-2846)
_POWERUP_INTS = {"newton_iters": "K", "fast_iters": "fast_iters",
                 "polish_iters": "polish_iters",
                 "polish_fixed": "polish_fixed",
                 "stall_strikes": "stall_strikes",
                 "plateau_strikes": "plateau_strikes",
                 "verdict_refine": "verdict_refine"}
_POWERUP_BOOLS = ("compensated", "pivot", "df_state", "polish_only")


def _device(d):
    """``torch.device(d)``, a CUDA device without an index as the current
    card's."""
    d = torch.device(d)
    if d.type == "cuda" and d.index is None and torch.cuda.is_available():
        d = torch.device("cuda", torch.cuda.current_device())
    return d


def _mesh_devices(mesh):
    """``mesh`` as a tuple of torch devices of one type (ValueError
    otherwise)."""
    try:
        devs = tuple(_device(d) for d in mesh)
    except (TypeError, RuntimeError) as e:
        raise ValueError(f"mesh must be a sequence of torch devices: {e}")
    if not devs or len({d.type for d in devs}) != 1 \
            or devs[0].type not in ("cuda", "cpu"):
        raise ValueError("mesh must be a non-empty sequence of CUDA "
                         f"devices or of CPU devices, got {devs}")
    return devs


def _cast_df_polish(v, compensated):
    """The JAX package's cast of ``df_polish`` (fused.py:492-495): a verdict
    tier by name, else a bool; without the compensated pipeline, False."""
    if v in ("final", "plain_final", "comp_final"):
        return v if compensated else False
    return bool(v) and compensated


def _check_choice(knob, v, choices):
    if v not in choices:
        raise ValueError(f"{knob} must be {'|'.join(choices)}, got {v!r}")


def _check_step(compensated, df_polish):
    """Raise for the step configurations no kernel can run."""
    if df_polish is not False and not compensated:
        # the JAX kernel would evaluate a compensated q it never built
        raise ValueError("df_polish needs compensated=True")


def _powerup_overrides(cfg, r):
    """The sibling runner's attributes for the power-up configuration
    ``cfg`` (a dict of overrides) of runner ``r``, cast as the JAX package
    casts them (fused.py:2831-2864, in its order: ``df_polish`` degrades
    to False without ``r``'s compensated pipeline, ``verdict_jac`` to "df"
    with a df solve); unknown keys raise ValueError."""
    cfg = dict(cfg)
    out = {}
    for key in list(cfg):
        if key in _POWERUP_INTS:
            out[_POWERUP_INTS[key]] = int(cfg.pop(key))
    if "df_polish" in cfg:
        out["df_polish"] = _cast_df_polish(cfg.pop("df_polish"),
                                           r.compensated)
    for key, choices in (("fast_verify", ("group", "merge", "always")),
                         ("fast_keep", ("gate", "tol"))):
        if key in cfg:
            out[key] = str(cfg.pop(key))
            _check_choice(key, out[key], choices)
    if "extrapolate" in cfg:
        v = cfg.pop("extrapolate")
        out["extrapolate"] = "track" if v == "track" else bool(v)
    for key in _POWERUP_BOOLS:
        if key in cfg:
            out[key] = bool(cfg.pop(key))
    if "verdict_jac" in cfg:
        v = str(cfg.pop("verdict_jac"))
        _check_choice("verdict_jac", v, ("df", "plain"))
        out["verdict_jac"] = "df" if r.df_solve else v
    if cfg:
        raise ValueError(f"unknown powerup override(s): {sorted(cfg)}")
    return out


class FusedInfo(NamedTuple):
    """Per-lane run statistics (see ``acme_tpu.ops.fused.FusedInfo``).

    ``fails`` (L,): samples on which any subsystem missed its acceptance
    gate.  ``iters`` (L, nsub): Newton evaluations per subsystem, counting
    each lane's own loop trips.  ``floored`` (L,): samples accepted above
    the gate through the polish floor-stall certificate.  ``tiers``
    (counters, nsub, L) int64, while tracing is on and the runner is on a
    card (None otherwise): the kernel's tier counters (``trace.COUNTERS``)
    summed over every traced call of the runner's build at this lane count,
    this call's included (the recorder's buffer, which later calls add to;
    a mesh run's entries' gathered; a cold run's the power-up sibling's
    and the runner's added)."""
    fails: torch.Tensor
    iters: torch.Tensor
    floored: torch.Tensor = None
    tiers: torch.Tensor = None


# -- EFT helpers (fused.py:120-155) -------------------------------------------

def _two_sum(a, b):
    sm = a + b
    bb = sm - a
    err = (a - (sm - bb)) + (b - bb)
    return sm, err


def _split_rt(a):
    """Dekker split of a runtime float32 tensor."""
    c = 4097.0 * a
    hi = c - (c - a)
    return hi, a - hi


def _const_split(c):
    """(a, ah, al, rem): a = float32(c), (ah, al) its Dekker split and
    rem = float32(c - a) the truncation remainder."""
    a = np.float32(c)
    t = np.float32(np.float32(4097.0) * a)
    ah = np.float32(t - np.float32(t - a))
    al = np.float32(a - ah)
    rem = np.float32(float(c) - float(a))
    return float(a), float(ah), float(al), float(rem)


def _prod_const(cs, v, vh, vl):
    """Error-free product of a pre-split constant with a pre-split tensor,
    plus the constant's f64 truncation remainder."""
    a, ah, al, rem = cs
    pr = a * v
    err = ((ah * vh - pr) + ah * vl + al * vh) + al * vl
    if rem != 0.0:
        err = err + rem * v
    return pr, err


class _Var:
    """Per-lane-varying coefficient: index into the runtime (hi, lo)
    coefficient tables (multi-model FusedRunner, fused.py:157-166)."""
    __slots__ = ("i",)

    def __init__(self, i):
        self.i = i

    def __repr__(self):
        return f"_Var({self.i})"


def _nz(cs):
    """Not a structural zero: only constants can be skipped."""
    return isinstance(cs, _Var) or cs[0] != 0.0 or cs[3] != 0.0


# -- runner -------------------------------------------------------------------

class FusedRunner:
    """Compile a DiscreteModel into a fused sweep runner.

    ``run(u_time (nu_t, T), lane_values (L, nu_l), state=None)``
    -> ``(y (L, ny, T), state, FusedInfo)``.

    Inputs listed in ``lane_input_idx`` are per-lane constants (the sweep
    axis); the rest come from the shared time series, those listed in
    ``lane_scale_idx`` multiplied by a per-lane scale (``lane_values``
    holds the constants, then the scales).  ``model`` may be a list of
    models of one topology (same dimensions and decomposition): lane i
    then runs ``models[i % len(models)]``, every prepared matrix
    coefficient that differs between them is read from two per-lane
    (hi, lo) tables that the kernel takes as arguments, and the rest stay
    literals of its code; the element physics is ``models[0]``'s, so only
    matrix coefficients may differ (component values, pot positions that
    keep the topology).  ``device`` holds
    the state and outputs: a CUDA device (the default; without a card the
    constructor raises) runs the kernel, ``device="cpu"`` the plain
    version.  Every other keyword and its default is the JAX package's
    (``acme_tpu.ops.fused.FusedRunner``): the robust path every sample
    (``fast_iters=0``), an early-exit polish loop (``polish_fixed=0``) in
    double-float physics (``df_polish=True``).  The JAX bench's production
    configuration is ``acme_tpu_torch.sweeps.PRODUCTION``.

    Lane groups: with a fast path (``fast_iters > 0`` or ``polish_only``)
    and ``fast_verify="group"`` (the default), the keep test of each
    sample and subsystem is one decision per lane group: if any lane of
    the group fails it, every lane of the group takes the redo (the
    robust path from its fast-path point, then the polish) and counts its
    evaluations, so a passing lane's result depends on its neighbours.
    The groups are the JAX runner's grid blocks: L must be a multiple of
    128 (``run`` raises ValueError otherwise), and ``group_lanes`` is
    partitioned as the JAX runner partitions it (:meth:`_group_S`, whose
    caps came from the TPU's memory and here define which lanes share a
    redo): one group holds at most 8192 lanes, a split run at most 4096,
    and a request under 1024 lanes becomes 1024 (or the whole run when it
    cannot be split in blocks of 8 x 128); ``group_size(L)`` gives the
    result.  ``group_lanes`` is read by that configuration only.

    Lanes split across devices: ``mesh`` is a sequence of torch devices of
    one type (``acme_tpu_torch.parallel.lane_mesh()``: the visible cards;
    an entry may repeat, as ``(cuda:0, cuda:0)`` or the CPU tests'
    ``(cpu,) * 8``).  ``run`` then takes L a multiple of 128 whose
    128-lane blocks divide by the mesh size (ValueError, "not divisible",
    otherwise) and gives entry d the contiguous lanes
    ``[d L/n, (d+1) L/n)``: their inputs, tolerances, coefficient tables
    and state, sliced from the whole run's, and one launch of the kernel
    on a stream of its own (CPU entries: the plain version, one after
    another); outputs and state are gathered on the runner's device, the
    mesh's first entry (``device`` may only name that one), as the JAX
    runner's ``shard_map`` does with no collectives.  Each entry
    partitions its own lanes into lane groups (``group_size``).
    ``mesh_axis`` is accepted for the JAX package's signature and read
    nowhere: a sequence has one axis.
    """

    def __init__(self, model, lane_input_idx: Sequence[int] = (), *,
                 device=None, lane_scale_idx: Sequence[int] = (),
                 newton_iters: int = 192, tol: float = 1e-9,
                 step_clip: float = 1.0, center: bool = True,
                 center_u=None, extrapolate: bool = True, refine: int = 1,
                 compensated: bool = True, df_state: bool = True,
                 rel_tol: float = None, rel_gate: float = None,
                 rel_tol_polish: float = None, polish_iters: int = 10,
                 polish_fixed: int = 0, df_polish: bool = True,
                 df_solve="auto", verdict_jac: str = "df",
                 verdict_refine: int = None, pivot: bool = True,
                 group_lanes: int = 2048, fast_iters: int = 0, fast_verify: str = "group",
                 polish_only: bool = False, fast_keep: str = "gate",
                 stall_strikes: int = 2, plateau_strikes: int = 6,
                 powerup=None, powerup_samples: int = 4096, mesh=None,
                 mesh_axis: str = "dp"):
        # per-lane model matrices (fused.py:331-348): a list of
        # same-topology models; every prepared coefficient that differs
        # between them becomes a per-lane (hi, lo) table entry, equal ones
        # stay literals of the kernel.  Lane i runs models[i % len(models)].
        models = list(model) if isinstance(model, (list, tuple)) else [model]
        m0 = models[0]
        for m in models[1:]:
            if (m.nx, m.nu, m.ny, m.nsubsystems) != \
                    (m0.nx, m0.nu, m0.ny, m0.nsubsystems) or any(
                    (m.nn(k), m.np(k)) != (m0.nn(k), m0.np(k))
                    for k in range(m0.nsubsystems)):
                raise ValueError(
                    "per-lane models must share dimensions/decomposition")
        self.models = models
        model = m0
        _check_choice("fast_verify", fast_verify, ("group", "merge", "always"))
        _check_choice("fast_keep", fast_keep, ("gate", "tol"))
        _check_choice("verdict_jac", verdict_jac, ("df", "plain"))
        self.mesh = None if mesh is None else _mesh_devices(mesh)
        if device is None:
            device = "cuda" if mesh is None else self.mesh[0]
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"FusedRunner(device={str(device)!r}): no CUDA card found; "
                'pass device="cpu" for the plain version')
        if self.mesh is not None:
            if _device(self.device) != self.mesh[0]:
                raise ValueError(
                    f"FusedRunner(device={str(device)!r}) is not the mesh's "
                    f"first entry ({self.mesh[0]}), where the state and the "
                    "outputs are gathered")
            self.device = self.mesh[0]
        # one stream per mesh entry, made at the first run on CUDA
        self._mesh_streams = None
        self.model = model
        self.K = int(newton_iters)
        # the step configuration, cast as the JAX package casts it
        # (fused.py:349-547); fast_iters=0 enters the robust path (gated
        # Newton, homotopy, df Newton) every sample
        self.fast_iters = int(fast_iters)
        self.polish_only = bool(polish_only)
        self.fast_verify = fast_verify
        # the requested group in blocks of LANE lanes (fused.py:456)
        self.group_S = max(1, int(group_lanes) // LANE)
        self.fast_keep = fast_keep
        # "track": start Newton at zw but keep (zw, wp, dzdp) up to date
        # for a sibling that extrapolates; False: neither use nor maintain
        self.extrapolate = "track" if extrapolate == "track" \
            else bool(extrapolate)
        self.compensated = bool(compensated)
        self.df_state = bool(df_state)
        self.pivot = bool(pivot)
        self.rel_tol = rel_tol
        self.rel_gate = rel_gate
        self.rel_tol_polish = rel_tol_polish
        self.df_polish = _cast_df_polish(df_polish, self.compensated)
        if df_solve == "auto":
            self.df_solve = "auto" if self.df_polish in (
                True, "final", "plain_final", "comp_final") else False
        else:
            self.df_solve = bool(df_solve) and \
                self.df_polish in (True, "final", "plain_final")
        self.verdict_jac = "df" if self.df_solve is True else verdict_jac
        # two-phase power-up: the first powerup_samples of a cold run go
        # through a sibling runner with the conservative configuration
        # (fused.py:384-418); "steady" starts every lane at its own steady
        # state instead
        self.powerup_steady = powerup == "steady"
        self._pw_overrides = None
        if powerup is not None and not self.powerup_steady:
            self._pw_overrides = _powerup_overrides(
                _POWERUP_SAFE if powerup == "safe" else powerup, self)
        self.powerup_samples = int(powerup_samples)
        self._pw_runner = None
        self.stall_strikes = int(stall_strikes)
        self.plateau_strikes = int(plateau_strikes)
        self.tol = float(tol)
        self.step_clip = float(step_clip)
        self.refine = int(refine)
        self.polish_iters = max(1, int(polish_iters))
        self.polish_fixed = max(0, int(polish_fixed))
        self.verdict_refine = int(refine if verdict_refine is None
                                  else verdict_refine)
        step = ("compensated", "df_polish")
        _check_step(*(getattr(self, k) for k in step))
        if self._pw_overrides is not None:
            _check_step(*(self._pw_overrides.get(k, getattr(self, k))
                          for k in step))
        self.lane_idx = tuple(int(i) for i in lane_input_idx)
        # lane-scaled inputs: time rows multiplied by a per-lane constant
        # (one audio stream fanned out at many input levels)
        self.scale_idx = tuple(int(i) for i in lane_scale_idx)
        self.time_idx = tuple(i for i in range(model.nu)
                              if i not in self.lane_idx)
        self.nx = model.nx
        self.ny = model.ny
        self.nn_total = model.nn()
        self.nsub = model.nsubsystems
        self.np_total = sum(model.np(k) for k in range(self.nsub))
        self.dz_total = sum(model.nn(k) * model.np(k)
                            for k in range(self.nsub))
        self._steady_floors = None
        # (hi, lo) coefficient tables by lane count, shared with the sibling
        self._coef_cache = {}
        self._prepare(center, center_u)
        self.plan = _Plan(self)

    # -- preparation (fused.py:563-815, float64 numpy) ------------------------
    def _prepare(self, center, center_u):
        m0 = self.model
        self.u_ss = np.zeros(m0.nu)
        if center_u is not None:
            self.u_ss = np.asarray(center_u, float).copy()
        elif self.lane_idx:
            for i in self.lane_idx:
                self.u_ss[i] = 0.5  # pots at mid travel
        # one entry per model, each with its own centering; the state
        # balancing scales are shared (from models[0]) so that the state
        # carries stay comparable lane to lane (fused.py:591-676)
        self._prep = []
        self.Tx = None
        for m in self.models:
            self._prep.append(self._prepare_model(m, center))
        p0 = self.prep = self._prep[0]
        self.x_ss, self.z_ss = p0["x_ss"], p0["z_ss"]
        self.q0_c = p0["q0"]
        self.tols = [max(p["tols"][k] for p in self._prep)
                     for k in range(self.nsub)]
        self.gates = [max(p["gates"][k] for p in self._prep)
                      for k in range(self.nsub)]
        self.dzdp0 = p0["dzdp0"]
        # structural conditioning per subsystem (fused.py:692-737): the
        # equilibrated cond(J) at the operating point, the largest over the
        # models; above 100 the verdict runs df physics and a df
        # elimination (sub_fragile)
        self.sub_fragile = []
        self.sub_cond_eq = []
        for kk in range(self.nsub):
            ce_max = 0.0
            for m, p in zip(self.models, self._prep):
                if not m.nn(kk):
                    continue
                with np.errstate(all="ignore"):
                    _, Jq0 = m.nl_funcs[kk](np, p["q0"][kk])
                    Je = np.asarray(Jq0 @ np.asarray(m.fqs[kk], float),
                                    float)
                    for _ in range(4):
                        r = np.sqrt(np.abs(Je).max(1))
                        r[(r == 0) | ~np.isfinite(r)] = 1.0
                        Je = Je / r[:, None]
                        c2 = np.sqrt(np.abs(Je).max(0))
                        c2[(c2 == 0) | ~np.isfinite(c2)] = 1.0
                        Je = Je / c2[None, :]
                    try:
                        ce = np.linalg.cond(Je)
                    except np.linalg.LinAlgError:
                        ce = np.inf
                ce_max = max(ce_max, float(ce)) if np.isfinite(ce) \
                    else np.inf
            self.sub_cond_eq.append(ce_max)
            self.sub_fragile.append(ce_max > 100.0)
        self._merge_coefficients()

    def _prepare_model(self, m, center):
        """One model's centered, balanced coefficients (fused.py:599-676)."""
        x_ss, z_ss = self._center_of(m, center)
        a = np.asarray(m.a, float)
        b = np.asarray(m.b, float)
        c = np.asarray(m.c, float)
        x0_c = (np.asarray(m.x0, float) + a @ x_ss
                + b @ self.u_ss + c @ z_ss - x_ss)
        y0_c = (np.asarray(m.y0, float)
                + np.asarray(m.dy, float) @ x_ss
                + np.asarray(m.ey, float) @ self.u_ss
                + np.asarray(m.fy, float) @ z_ss)
        dy = np.asarray(m.dy, float)
        dq_list = [np.asarray(m.dqs[k], float) for k in range(self.nsub)]
        if self.Tx is None:
            self.Tx = self._balance_states(a, b, c, dy, dq_list)
        Tc_ = self.Tx[:, None] if m.nx else np.ones((0, 1))
        Tr_ = self.Tx[None, :] if m.nx else np.ones((1, 0))
        p = dict(
            x_ss=x_ss, z_ss=z_ss,
            a=a * (Tr_ / Tc_) if m.nx else a,
            b=b / Tc_ if m.nx else b,
            c=c / Tc_ if m.nx else c,
            x0=(x0_c / self.Tx if m.nx else x0_c),
            dy=dy * Tr_, ey=np.asarray(m.ey, float),
            fy=np.asarray(m.fy, float), y0=y0_c,
            dq=[d * Tr_ for d in dq_list],
            eq=[np.asarray(m.eqs[k], float) for k in range(self.nsub)],
            fqprev=[np.asarray(m.fqprevs[k], float)
                    for k in range(self.nsub)],
            fq=[np.asarray(m.fqs[k], float) for k in range(self.nsub)],
            pexp=[np.asarray(m.pexps[k], float) for k in range(self.nsub)],
            q0=[], dzdp0=[], tols=[], gates=[])
        off = 0
        for kk in range(self.nsub):
            nn_k, np_k = m.nn(kk), m.np(kk)
            q0 = (np.asarray(m.q0s[kk], float)
                  + np.asarray(m.pexps[kk], float)
                  @ (np.asarray(m.dqs[kk], float) @ x_ss
                     + np.asarray(m.eqs[kk], float) @ self.u_ss
                     + np.asarray(m.fqprevs[kk], float) @ z_ss)
                  + np.asarray(m.fqs[kk], float) @ z_ss[off:off + nn_k])
            p["q0"].append(q0)
            off += nn_k
            floor = float(self._floor_measure(kk, q0[:, None], model=m)
                          .max()) if nn_k else 0.0
            p["tols"].append(max(self.tol, 8.0 * floor))
            p["gates"].append(max(96.0 * floor, 32.0 * self.tol))
            res, Jq = m.nl_funcs[kk](np, q0)
            J = Jq @ np.asarray(m.fqs[kk], float)
            Jp = Jq @ np.asarray(m.pexps[kk], float)
            try:
                d0 = -np.linalg.solve(J, Jp)
            except np.linalg.LinAlgError:
                d0 = np.zeros((nn_k, np_k))
            p["dzdp0"].append(d0)
        return p

    def _merge_coefficients(self):
        """Compare every prepared coefficient across the models: equal ones
        stay literals (floats), differing ones become ``_Var`` indices into
        the per-lane (hi, lo) tables (fused.py:759-798)."""
        preps = self._prep
        n = len(preps)
        var_vals = []

        def mk(get):
            arrs = [np.asarray(get(p), float) for p in preps]
            a0 = arrs[0]
            if n == 1:
                return a0.tolist()
            stack = np.stack(arrs)
            eq = np.all(stack == stack[0:1], axis=0)
            out = np.empty(a0.shape, object)
            for idx in np.ndindex(a0.shape):
                if eq[idx]:
                    out[idx] = float(a0[idx])
                else:
                    out[idx] = _Var(len(var_vals))
                    var_vals.append(stack[(slice(None),) + idx])
            return out.tolist()

        self.P = dict(
            a=mk(lambda p: p["a"]), b=mk(lambda p: p["b"]),
            c=mk(lambda p: p["c"]), x0=mk(lambda p: p["x0"]),
            dy=mk(lambda p: p["dy"]), ey=mk(lambda p: p["ey"]),
            fy=mk(lambda p: p["fy"]), y0=mk(lambda p: p["y0"]),
            subs=[dict(
                dq=mk(lambda p, k=k: p["dq"][k]),
                eq=mk(lambda p, k=k: p["eq"][k]),
                fqprev=mk(lambda p, k=k: p["fqprev"][k]),
                fq=mk(lambda p, k=k: p["fq"][k]),
                pexp=mk(lambda p, k=k: p["pexp"][k]),
                q0=mk(lambda p, k=k: p["q0"][k]))
                for k in range(self.nsub)])
        self.nvar = len(var_vals)
        self.var_tab = (np.stack(var_vals) if var_vals
                        else np.zeros((0, n)))

    def _lane_model_idx(self, L):
        """Lane -> model mapping (cyclic)."""
        return np.arange(L) % len(self.models)

    def _coef_tables(self, L):
        """The per-lane coefficient tables for ``L`` lanes: (hi, lo) float32
        tensors of shape (max(nvar, 1), L) on the runner's device, lane l
        holding the values of ``models[l % len(models)]`` (fused.py:804-815,
        there reshaped to (nvar, S, 128))."""
        if L not in self._coef_cache:
            nv = max(self.nvar, 1)
            hi = np.zeros((nv, L), np.float32)
            lo = np.zeros((nv, L), np.float32)
            if self.nvar:
                vals = self.var_tab[:, self._lane_model_idx(L)]
                hi[:self.nvar] = vals.astype(np.float32)
                lo[:self.nvar] = (vals - hi[:self.nvar].astype(np.float64)
                                  ).astype(np.float32)
            self._coef_cache[L] = (self._tensor(hi), self._tensor(lo))
        return self._coef_cache[L]

    def _center_of(self, m, center):
        if not (center and (m.nx or self.nn_total)):
            return np.zeros(m.nx), np.zeros(self.nn_total)
        from ..runtime import operating_point, steadystate
        try:
            return steadystate(m, self.u_ss, return_z=True)
        except Exception:
            # the strict steady state fails on the chain-decomposed
            # superover (ref runtests.jl:763-764); centering is exact for
            # any center point, so the run-in operating point will do
            try:
                return operating_point(m, self.u_ss)
            except Exception:
                return np.zeros(m.nx), np.zeros(self.nn_total)

    def _floor_measure(self, kk, q64, comp=None, model=None):
        """Empirical float32 residual floor at the points ``q64`` (nq, L),
        from the element physics in simulated kernel arithmetic, with the
        first-order q_lo compensation when ``comp`` (default: the runner's
        ``compensated``, fused.py:740-757)."""
        if comp is None:
            comp = self.compensated
        nl = (model or self.model).nl_funcs[kk]
        res64, _ = nl(np, q64)
        qhi = q64.astype(np.float32)
        res32, Jq32 = nl(np, qhi)
        if comp:
            qlo = (q64 - qhi.astype(np.float64)).astype(np.float32)
            corr = np.einsum("ac...,c...->a...", Jq32, qlo)
            res32 = res32 + corr
        err = np.abs(res32.astype(np.float64) - res64)
        return err.max(axis=0) if err.size else np.zeros(q64.shape[1:])

    @staticmethod
    def _balance_states(a, b, c, dy, dq_list, sweeps: int = 25):
        """Per-state power-of-two scales equalizing writer and reader
        coefficient magnitudes (fused.py:817-849)."""
        nx = a.shape[0]
        T = np.ones(nx)
        if nx == 0:
            return T
        readers = [dy] + list(dq_list)
        for _ in range(sweeps):
            changed = False
            for j in range(nx):
                outs = [np.abs(a[i, j]) * T[j] / T[i]
                        for i in range(nx) if i != j and a[i, j] != 0]
                outs += [np.abs(r[i, j]) * T[j]
                         for r in readers for i in range(r.shape[0])
                         if r[i, j] != 0]
                ins = [np.abs(a[j, k]) * T[k] / T[j]
                       for k in range(nx) if k != j and a[j, k] != 0]
                ins += [np.abs(v) / T[j]
                        for v in np.concatenate([b[j, :], c[j, :]])
                        if v != 0]
                if not outs or not ins:
                    continue
                f = np.sqrt(max(outs) / max(ins))
                k = int(np.round(np.log2(f)))
                if k != 0:
                    T[j] /= 2.0 ** k
                    changed = True
            if not changed:
                break
        return T

    # -- state ----------------------------------------------------------------
    def _tensor(self, arr):
        return torch.as_tensor(np.ascontiguousarray(arr, np.float32),
                               device=self.device)

    def initial_state(self, lanes: int, at_steady: bool = False):
        """Initial carry, (n, L) float32 tensors on the runner's device
        (fused.py:2534-2598): x = 0, z = the initial operating point, and a
        consistent extrapolation origin (wp, zw); ``at_steady`` starts at
        the centering steady state instead (x, z and wp zero in centered
        coordinates), skipping the power-up transient.  With per-lane
        models, each lane starts at its own model's."""
        midx = self._lane_model_idx(lanes)
        rows = {k: [] for k in ("x", "xlo", "z", "wp", "dz")}
        for m, p in zip(self.models, self._prep):
            x0v = (np.zeros(max(self.nx, 1)) if at_steady or self.nx == 0
                   else -p["x_ss"] / self.Tx)
            xlo_v = x0v - x0v.astype(np.float32).astype(np.float64)
            if self.nn_total:
                z0 = (np.zeros(self.nn_total) if at_steady
                      else np.concatenate([np.asarray(z, float)
                                           for z in m.init_zs]) - p["z_ss"])
            else:
                z0 = np.zeros(1)
            dz0 = (np.concatenate([d.reshape(-1) for d in p["dzdp0"]])
                   if self.dz_total else np.zeros(1))
            wp0 = np.zeros(max(self.np_total, 1))
            if self.np_total and not at_steady:
                u_c = -self.u_ss
                off = 0
                for kk in range(self.nsub):
                    npk = m.np(kk)
                    wp0[off:off + npk] = (
                        p["dq"][kk] @ x0v[:self.nx]
                        + np.asarray(m.eqs[kk], float) @ u_c
                        + np.asarray(m.fqprevs[kk], float)
                        @ z0[:self.nn_total])
                    off += npk
            for key, v in zip(("x", "xlo", "z", "wp", "dz"),
                              (x0v, xlo_v, z0, wp0, dz0)):
                rows[key].append(v)

        def per_lane(key):
            return self._tensor(np.asarray(rows[key], float)[midx].T)

        zeros = lambda n: torch.zeros((n, lanes), dtype=torch.float32,
                                      device=self.device)
        return {"x": per_lane("x"), "xlo": per_lane("xlo"),
                "z": per_lane("z"), "zlo": zeros(max(self.nn_total, 1)),
                "zw": per_lane("z"), "wp": per_lane("wp"),
                "dzdp": per_lane("dz"), "pmode": zeros(max(self.nsub, 1))}

    def steady_initial_state(self, lane_values, runin: int = 4096,
                             rounds: int = 12):
        """Per-lane steady start (fused.py:2600-2754): every lane begins at
        the steady state of its own model and constant inputs, computed on
        the host by :func:`acme_tpu_torch.runtime.steadystate_sweep`.  Also
        installs the certified per-subsystem residual floors for
        ``_lane_tolerances``."""
        from ..runtime import steadystate_sweep
        lane_values = np.asarray(lane_values, float)
        nu_l0 = len(self.lane_idx)
        L = self._lanes(lane_values)
        midx = self._lane_model_idx(L)
        xs_l = np.zeros((L, self.nx))
        zs_l = np.zeros((L, self.nn_total))
        floors_l = np.zeros((L, max(self.nsub, 1)))
        conv = np.ones(L, bool)
        for mi, m in enumerate(self.models):
            sel = np.nonzero(midx == mi)[0]
            if sel.size == 0:
                continue
            u_lanes = self._lane_inputs(m, lane_values, sel, nu_l0)
            uu, inv = np.unique(u_lanes, axis=0, return_inverse=True)
            inv = np.asarray(inv).reshape(-1)
            if uu.shape[0] < u_lanes.shape[0]:
                xs, zs, cv, fl = steadystate_sweep(m, uu, runin=runin,
                                                   rounds=rounds,
                                                   return_floors=True)
                if not cv.all() and uu.shape[0] <= 64:
                    bad = np.nonzero(~cv)[0]
                    xs2, zs2, cv2, fl2 = steadystate_sweep(
                        m, uu[bad], runin=max(runin, 65536), rounds=rounds,
                        return_floors=True)
                    xs[bad], zs[bad] = xs2, zs2
                    cv[bad], fl[bad] = cv2, fl2
                xs, zs, cv, fl = xs[inv], zs[inv], cv[inv], fl[inv]
            else:
                xs, zs, cv, fl = steadystate_sweep(m, u_lanes, runin=runin,
                                                   rounds=rounds,
                                                   return_floors=True)
            conv[sel] = np.asarray(cv, bool)
            floors_l[sel, :fl.shape[1]] = fl
            xs_l[sel], zs_l[sel] = xs, zs
        n_bad = int((~conv).sum())
        floors_l[~conv] = 0.0
        self._steady_floors = floors_l
        if n_bad:
            warnings.warn(f"steady_initial_state: {n_bad}/{L} lanes did "
                          "not certify steady; they start COLD and power "
                          "up dynamically.")
        return self._state_at(xs_l, zs_l, lane_values, conv)

    def _lane_inputs(self, m, lane_values, sel, nu_l0):
        """The constant inputs of the lanes ``sel``: the centre's, with the
        lane inputs set to the lanes' values."""
        u_lanes = np.broadcast_to(self.u_ss,
                                  (sel.size, m.nu)).astype(float).copy()
        if nu_l0 and lane_values.size:
            u_lanes[:, list(self.lane_idx)] = lane_values[sel, :nu_l0]
        return u_lanes

    def _state_at(self, xs, zs, lane_values, conv=None):
        """The carry of lanes at the states ``xs`` (L, nx) and ``zs`` (L, nn)
        in the model's coordinates, under their constant inputs
        (``lane_values`` as ``run`` takes them, every other input at the
        centre's): x and z centred and balanced, each as a float32 (hi, lo)
        pair, the extrapolation origin wp and each subsystem's dz/dp there.
        Lanes where ``conv`` is False start cold (``initial_state``)."""
        lane_values = np.asarray(lane_values, float)
        nu_l0 = len(self.lane_idx)
        L = self._lanes(lane_values)
        midx = self._lane_model_idx(L)
        x_l = np.zeros((L, max(self.nx, 1)))
        z_l = np.zeros((L, max(self.nn_total, 1)))
        wp_l = np.zeros((L, max(self.np_total, 1)))
        dz_l = np.zeros((L, max(self.dz_total, 1)))
        for mi, (m, p) in enumerate(zip(self.models, self._prep)):
            sel = np.nonzero(midx == mi)[0]
            if sel.size == 0:
                continue
            u_lanes = self._lane_inputs(m, lane_values, sel, nu_l0)
            xs_m, zs_m = xs[sel], zs[sel]
            if self.nx:
                x_l[sel, :self.nx] = (xs_m - p["x_ss"]) / self.Tx
            if self.nn_total:
                z_l[sel, :self.nn_total] = zs_m - p["z_ss"]
            uc = u_lanes - self.u_ss
            off = doff = zoff = 0
            for kk in range(self.nsub):
                npk, nnk = m.np(kk), m.nn(kk)
                if self.np_total:
                    wp_l[sel, off:off + npk] = (
                        x_l[sel, :self.nx] @ p["dq"][kk].T
                        + uc @ np.asarray(m.eqs[kk], float).T
                        + z_l[sel, :self.nn_total]
                        @ np.asarray(m.fqprevs[kk], float).T)
                if nnk and npk:
                    p_phys = (np.asarray(m.dqs[kk], float) @ xs_m.T
                              + np.asarray(m.eqs[kk], float) @ u_lanes.T
                              + np.asarray(m.fqprevs[kk], float) @ zs_m.T)
                    fq = np.asarray(m.fqs[kk], float)
                    pexp = np.asarray(m.pexps[kk], float)
                    q = (np.asarray(m.q0s[kk], float)[:, None]
                         + pexp @ p_phys + fq @ zs_m.T[zoff:zoff + nnk])
                    with np.errstate(all="ignore"):
                        _, Jq = m.nl_funcs[kk](np, q)
                        J = np.einsum("ijl,jk->lik", Jq, fq)
                        Jp = np.einsum("ijl,jk->lik", Jq, pexp)
                        d = -np.linalg.pinv(J) @ Jp
                    bad = ~np.isfinite(d).all(axis=(1, 2))
                    if bad.any():
                        d[bad] = p["dzdp0"][kk]
                    steep = np.abs(d).max(axis=(1, 2)) > 1e3
                    d[steep] = 0.0
                    dz_l[sel, doff:doff + nnk * npk] = d.reshape(sel.size,
                                                                 -1)
                off += npk
                doff += nnk * npk
                zoff += nnk
        xlo = x_l - x_l.astype(np.float32).astype(np.float64)
        zlo = z_l - z_l.astype(np.float32).astype(np.float64)
        state = {"x": self._tensor(x_l.T), "xlo": self._tensor(xlo.T),
                 "z": self._tensor(z_l.T), "zlo": self._tensor(zlo.T),
                 "zw": self._tensor(z_l.T), "wp": self._tensor(wp_l.T),
                 "dzdp": self._tensor(dz_l.T),
                 "pmode": torch.zeros((max(self.nsub, 1), L),
                                      dtype=torch.float32,
                                      device=self.device)}
        if conv is not None and not conv.all():
            base = self.initial_state(L)
            ok = torch.as_tensor(conv, device=self.device)[None]
            state = {k: torch.where(ok, v, base[k]) for k, v in state.items()}
        return state

    def _group_S(self, S: int) -> int:
        """The blocks of LANE lanes in one lane group of a run over S
        blocks: the largest divisor of S up to the requested group, with
        the JAX runner's caps (fused.py:2373-2394): at most 8192 lanes in
        one group, at most 4096 in each group of a split run, and a split
        smaller than 8 blocks taken to 8 blocks (or to the whole run when S
        is not a multiple of 8)."""
        Sg = min(self.group_S, S)
        Sg = min(Sg, 8192 // LANE)
        if Sg < S:
            Sg = min(Sg, 4096 // LANE)
        while S % Sg:
            Sg -= 1
        if Sg < 8 and Sg != S:
            Sg = 8 if S % 8 == 0 else S
        return Sg

    def group_size(self, L: int) -> int:
        """The lanes of one lane group of a run over L lanes (a multiple of
        LANE, else ValueError as the JAX runner raises, fused.py:2934).
        With a mesh, each entry partitions its own L/n lanes
        (``_group_S(S / n)``, fused.py:2406-2411), so 4096 lanes at
        ``group_lanes=2048`` are two groups of 2048 unsplit and on a mesh
        of two, four of 1024 on a mesh of four."""
        return LANE * self._group_S(self._mesh_split(L) // LANE)

    def _mesh_split(self, L: int) -> int:
        """The lanes of each mesh entry of a run over L lanes (L without a
        mesh, where only a build that couples lane groups needs L a
        multiple of LANE): ValueError unless L is whole blocks of LANE
        lanes that divide by the mesh size (fused.py:2406-2409)."""
        if L % LANE:
            raise ValueError(f"lanes ({L}) must be a multiple of {LANE}"
                             + ("" if self.mesh is None else
                                ": not divisible into lane blocks"))
        n = 1 if self.mesh is None else len(self.mesh)
        if (L // LANE) % n:
            raise ValueError(f"lane blocks ({L // LANE}) not divisible by "
                             f"the mesh size ({n})")
        return L // n

    def _group(self, L):
        """The group size to hand the step: ``group_size(L)`` when the
        runner's build couples a lane group, else None."""
        return self.group_size(L) if self.plan.verify_group else None

    def _lanes(self, lane_values):
        lane_values = np.asarray(lane_values)
        if lane_values.ndim == 2 and lane_values.shape[0] > 0:
            return lane_values.shape[0]
        return 128

    @trace.spanned("acme.lane_tolerances")
    def _lane_tolerances(self, lane_values_centered, L):
        """Per-lane loop tolerance/gate and acceptance gate
        (fused.py:2756-2817): (tol (nsub, L), gates (3 nsub, L)) float32."""
        nsub = max(self.nsub, 1)
        tol_l = np.full((nsub, L), max(self.tol, 1e-9), np.float32)
        gate_l = np.full((3 * nsub, L), 32.0 * self.tol, np.float32)
        gate_l[2 * nsub:] = max(self.tol, 1e-9)
        lv = np.asarray(lane_values_centered, float)
        midx = self._lane_model_idx(L)
        for kk in range(self.nsub):
            floor_l = np.zeros(L)
            floor_f = np.zeros(L)
            for mi, (m, p) in enumerate(zip(self.models, self._prep)):
                sel = np.nonzero(midx == mi)[0]
                if sel.size == 0:
                    continue
                q = np.broadcast_to(p["q0"][kk][:, None],
                                    (len(p["q0"][kk]), sel.size)).copy()
                if self.lane_idx and lv.size:
                    eq_lane = np.asarray(m.eqs[kk], float)[
                        :, list(self.lane_idx)]
                    q += np.asarray(m.pexps[kk], float) \
                        @ (eq_lane @ lv[sel, :len(self.lane_idx)].T)
                floor_l[sel] = self._floor_measure(kk, q, comp=False,
                                                   model=m)
                floor_f[sel] = self._floor_measure(kk, q, model=m)
            tol_l[kk] = np.maximum(self.tol, 8.0 * floor_l)
            gate_l[kk] = np.maximum(96.0 * floor_l, 32.0 * self.tol)
            gate_l[nsub + kk] = np.maximum(96.0 * floor_f, 32.0 * self.tol)
            gate_l[2 * nsub + kk] = np.maximum(self.tol, 8.0 * floor_f)
        fl = self._steady_floors
        if fl is not None and fl.shape[0] == L and self.nsub:
            flT = np.asarray(fl, np.float32).T
            for kk in range(self.nsub):
                tol_l[kk] = np.maximum(tol_l[kk], 2.0 * flT[kk])
                gate_l[kk] = np.maximum(gate_l[kk], 4.0 * flT[kk])
                gate_l[nsub + kk] = np.maximum(gate_l[nsub + kk],
                                               4.0 * flT[kk])
                gate_l[2 * nsub + kk] = np.maximum(gate_l[2 * nsub + kk],
                                                   2.0 * flT[kk])
        return tol_l, gate_l

    # -- run ------------------------------------------------------------------
    @trace.spanned("acme.prepare_inputs")
    def prepare_inputs(self, u_time, lane_values):
        """Centered float32 kernel inputs on the runner's device:
        (u (T, nu_t), lanes (nu_l, L), tol (nsub, L), gates (3 nsub, L)).
        ``lane_values`` holds the lane inputs' constants, then the scales
        of the lane-scaled inputs (fused.py:2921-2932)."""
        u_time = np.asarray(u_time, float) \
            - self.u_ss[list(self.time_idx)][:, None]
        lane_values = np.array(lane_values, float, copy=True)
        nu_l0 = len(self.lane_idx)
        nu_l = nu_l0 + len(self.scale_idx)
        if nu_l and (lane_values.ndim != 2 or lane_values.shape[1] != nu_l):
            raise ValueError(
                f"lane_values must be 2-D with {nu_l} columns ({nu_l0} "
                f"constants + {len(self.scale_idx)} scales), got shape "
                f"{lane_values.shape}")
        if nu_l0:
            lane_values[:, :nu_l0] -= self.u_ss[list(self.lane_idx)]
        lane_values = lane_values.astype(np.float32)
        L = self._lanes(lane_values)
        lv = lane_values.T if nu_l else np.zeros((1, L), np.float32)
        tol_l, gate_l = self._lane_tolerances(lane_values, L)
        u = u_time.T if len(self.time_idx) else \
            np.zeros((u_time.shape[1], 1))
        return (self._tensor(u), self._tensor(lv), self._tensor(tol_l),
                self._tensor(gate_l))

    def _powerup_runner(self):
        """The sibling runner with the power-up configuration
        (fused.py:2819-2866): it shares the prepared coefficients and
        centering with this runner, read-only, and has its own ``_Plan``
        (so its own kernel build, ``fused_sweep_powerup``)."""
        if self._pw_runner is None:
            r = copy.copy(self)
            r._pw_runner = None
            r._pw_overrides = None
            for attr, v in self._pw_overrides.items():
                setattr(r, attr, v)
            r.plan = _Plan(r, "fused_sweep_powerup")
            self._pw_runner = r
        return self._pw_runner

    @trace.spanned("acme.check_outputs")
    def _check_outputs(self, y, info):
        """Raise on non-finite output, warn on fails (fused.py:2868-2886):
        one device-side reduction, two scalars to the host (each an
        ``acme.wait`` span)."""
        finite = torch.isfinite(y).all()
        with trace.span("acme.wait"):
            finite = bool(finite)
        if not finite:
            raise RuntimeError(
                "fused run produced non-finite output; inspect "
                "FusedInfo.fails for the offending lanes (reference "
                "semantics: ACME.jl:692-694)")
        nfail = info.fails.sum()
        with trace.span("acme.wait"):
            nfail = int(nfail)
        if nfail:
            warnings.warn(
                f"fused run: {nfail} subsystem solve(s) across all lanes "
                "and samples missed the acceptance gate (solution kept, "
                "output may be degraded on those lanes; see "
                "FusedInfo.fails). Reference warn path: ACME.jl:688-691.")

    @trace.spanned("acme.run")
    def run(self, u_time, lane_values, state=None, check=True):
        """u_time: (nu_t, T); lane_values: (L, nu_l).  Returns
        (y (L, ny, T), state, FusedInfo), all tensors on the runner's
        device.  ``state`` holds (n, L) tensors under the JAX package's
        keys; None starts cold (with ``powerup="steady"`` at each lane's
        own steady state; with ``powerup="safe"`` or a dict, the first
        ``powerup_samples`` run through the power-up sibling, whose state
        this runner takes over, fused.py:2898-2917).  A build that couples
        lane groups, or a mesh, takes L a multiple of 128 (with a mesh, its
        blocks divisible by the mesh size); ValueError otherwise, before any
        step runs.  A state without ``zlo`` or ``pmode`` gets zeros there,
        as the JAX runner fills them (fused.py:2967-2970)."""
        if self.mesh is not None:
            self._mesh_split(self._lanes(lane_values))
        if state is None and self.powerup_steady:
            state = self.steady_initial_state(lane_values)
        if state is None and self._pw_overrides is not None:
            return self._run_powerup(u_time, lane_values, check)
        u, lv, tol_l, gate_l = self.prepare_inputs(u_time, lane_values)
        L = lv.shape[1]
        if state is None:
            state = self.initial_state(L)
        state = _complete_state(self.plan, state, lv)
        args = (u, lv, tol_l, gate_l, state, self._coef_tables(L),
                self._group(L))
        stats = self._tier_buffers(L) if lv.device.type == "cuda" else None
        if self.mesh is None:
            out = fused_step(self.plan, *args, stats=stats)
            tiers = stats
        else:
            out = self._mesh_step(fused_step, *args, stats=stats)
            tiers = None if stats is None else torch.cat(
                [t.to(self.device) for t in stats], dim=2)
        y, state, fails, iters, floored = out
        y = y.permute(2, 1, 0)[:, :self.ny, :]
        info = FusedInfo(fails=fails, iters=iters.T, floored=floored,
                         tiers=tiers)
        if check:
            self._check_outputs(y, info)
        return y, state, info

    def _tier_buffers(self, L):
        """The recorder's stats buffer for a run over L lanes (with a mesh,
        one per entry); None while tracing is off."""
        if self.mesh is None:
            return trace.tier_buffer(self.plan, L, self.device)
        Ld = L // len(self.mesh)
        bufs = [trace.tier_buffer(self.plan, Ld, d, i * Ld)
                for i, d in enumerate(self.mesh)]
        return None if bufs[0] is None else bufs

    @trace.spanned("acme.powerup")
    def _run_powerup(self, u_time, lane_values, check):
        """A cold ``run`` with a power-up: its first ``powerup_samples``
        through the sibling, the rest through this runner from the state
        the sibling left, the outputs joined."""
        ut = np.asarray(u_time, float)
        T0 = ut.shape[1]
        W = min(self.powerup_samples, T0)
        pr = self._powerup_runner()
        if self.plan.verify_group or pr.plan.verify_group:
            self.group_size(self._lanes(lane_values))
        if W >= T0:
            return pr.run(ut, lane_values, state=None, check=check)
        y1, state, info1 = pr.run(ut[:, :W], lane_values, state=None,
                                  check=False)
        y2, state, info2 = self.run(ut[:, W:], lane_values, state=state,
                                    check=False)
        y = torch.cat([y1, y2], dim=2)
        info = FusedInfo(*(None if a is None else a + b
                           for a, b in zip(info1, info2)))
        if check:
            self._check_outputs(y, info)
        return y, state, info

    def _streams(self):
        """One CUDA stream per mesh entry, on the entry's card (a card
        named twice gets two), made once."""
        if self._mesh_streams is None:
            self._mesh_streams = [torch.cuda.Stream(device=d)
                                  for d in self.mesh]
        return self._mesh_streams

    def _mesh_step(self, step, u, lv, tol, gate, state, coef, group,
                   stats=None):
        """``step`` (``fused_step``, or ``plain_run`` to hold the kernel
        against) once per mesh entry over the entry's contiguous lanes,
        sliced from the whole run's inputs, state and tables; the outputs
        gathered on the runner's device in lane order (fused.py:2517-2528:
        the kernel shard_map-ed over the lane axis, no collectives).  CUDA
        entries each launch on a stream of their own, made to wait for the
        runner's current stream, so that the launches overlap; the runner's
        stream waits for every entry before the gather.  CPU entries run
        one after another.  ``stats``: one stats buffer per entry, on the
        entry's device, which its launch adds to; or None."""
        n = len(self.mesh)
        Ld = lv.shape[1] // n
        lane_args = [lv, tol, gate, *coef] + [state[k] for k in STATE_KEYS]
        cuda = self.device.type == "cuda"
        main = torch.cuda.current_stream(self.device) if cuda else None
        parts = []
        for d, dev in enumerate(self.mesh):
            sl = slice(d * Ld, (d + 1) * Ld)
            with contextlib.ExitStack() as ctx:
                if cuda:
                    s = self._streams()[d]
                    ctx.enter_context(torch.cuda.device(dev))
                    ctx.enter_context(torch.cuda.stream(s))
                    s.wait_stream(main)
                    for t in [u] + lane_args:
                        # read on s: not freed for reuse before s is done
                        t.record_stream(s)
                # copies made here belong to s (or live on the CPU)
                uu = u.to(dev)
                lv_d, tol_d, gate_d, ch, cl, *st = [
                    t[:, sl].to(dev).contiguous() for t in lane_args]
                kw = {} if stats is None else {"stats": stats[d]}
                out = step(self.plan, uu, lv_d, tol_d, gate_d,
                           dict(zip(STATE_KEYS, st)), (ch, cl), group, **kw)
                if cuda:
                    done = torch.cuda.Event()
                    done.record(s)
                    parts.append((out, done))
                else:
                    parts.append((out, None))
        outs = []
        for out, done in parts:
            if done is not None:
                main.wait_event(done)
                y, st, fails, iters, floored = out
                for t in [y, fails, iters, floored, *st.values()]:
                    # read by the gather on the runner's stream
                    t.record_stream(main)
            outs.append(out)
        dev = self.device
        cat = lambda ts, dim: torch.cat([t.to(dev) for t in ts], dim=dim)
        ys, sts, fails, iters, floored = zip(*outs)
        return (cat(ys, 2), {k: cat([st[k] for st in sts], 1)
                             for k in STATE_KEYS},
                cat(fails, 0), cat(iters, 1), cat(floored, 0))


STATE_KEYS = ("x", "xlo", "z", "zlo", "zw", "wp", "dzdp", "pmode")
# the state keys a caller may leave out, filled with zeros as the JAX
# runner fills them (fused.py:2967-2970)
_ZERO_FILLED = ("zlo", "pmode")


def _complete_state(plan, state, like):
    """``state`` with each key of ``_ZERO_FILLED`` it lacks as zeros of
    its shape (its rows by ``plan``, ``like.shape[1]`` lanes, on
    ``like``'s device)."""
    missing = [k for k in _ZERO_FILLED if k not in state]
    if not missing:
        return state
    dims = _state_dims(plan)
    return {**state, **{k: torch.zeros((dims[k], like.shape[1]),
                                       dtype=torch.float32,
                                       device=like.device)
                        for k in missing}}


# -- the prepared step (shared by the plain version and emit.py) --------------

class _Plan:
    """Everything the per-sample step reads, resolved once per runner:
    float64 coefficients, their (a, ah, al, rem) splits, subsystem
    offsets, and the solver configuration (``_build``, fused.py:852-1003)."""

    def __init__(self, r: FusedRunner, kernel_name="fused_sweep"):
        P, m = r.P, r.model
        # a constant is split here; a _Var stays a handle and is split at
        # run time (fused.py:870-874)
        SP = lambda v: v if isinstance(v, _Var) else _const_split(v)
        spl = lambda rows: [[SP(v) for v in row] for row in rows]
        self.nx, self.ny, self.nsub = r.nx, r.ny, r.nsub
        self.nn_total, self.np_total = r.nn_total, r.np_total
        self.dz_total = r.dz_total
        self.nu = m.nu
        # entries of the per-lane coefficient tables (0 for one model)
        self.nvar = r.nvar
        self.time_idx, self.lane_idx = r.time_idx, r.lane_idx
        self.scale_idx = r.scale_idx
        self.K, self.fast = r.K, max(0, r.fast_iters)
        # the step configuration (fused.py:857-867, :1339-1371, :2018-2151)
        comp = self.comp = r.compensated
        dfp = r.df_polish
        plain_pol = dfp in ("plain_final", "comp_final")
        self.df_final = dfp in ("final", "plain_final", "comp_final")
        self.dfs = r.df_state
        # maintain the (zw, wp, dzdp) origin; start at the extrapolated
        # point (True) or at zw ("track")
        self.extrap = bool(r.extrapolate)
        self.extrap_use = r.extrapolate is True
        self.pivot = r.pivot
        # the fast path: fast unguarded steps (none with polish_only), the
        # polish, the keep test (at the gate or the polish target) and the
        # redo of the robust path for the lanes that fail it, or for all
        # ("always")
        self.fast_path = self.fast > 0 or r.polish_only
        self.verify_always = r.fast_verify == "always"
        # the redo for every lane of a lane group when one of them fails
        # (the launch is handed the group's size)
        self.verify_group = self.fast_path and r.fast_verify == "group"
        self.keep_tol = r.fast_keep == "tol"
        # relative tolerances, each capped at its anchor
        self.rel_tol = 3.0e-7 if r.rel_tol is None else float(r.rel_tol)
        self.rel_gate = 4.0e-6 if r.rel_gate is None else float(r.rel_gate)
        self.rel_gate_f = (float(r.rel_gate) if r.rel_gate is not None
                           else (2.0e-6 if comp else 4.0e-6))
        self.rel_tol_pol = (float(r.rel_tol_polish)
                            if r.rel_tol_polish is not None
                            else 3.0e-7 if plain_pol
                            else 3.0e-8 if self.df_final
                            else 3.0e-9 if dfp
                            else (3.0e-8 if comp else 3.0e-7))
        # evaluation modes: False plain, True compensated, "df" double-float
        # physics, "df_res" a df residual with a plain Jacobian.  The
        # polish loop's; the verdict's (None: no verdict; a df-solve
        # subsystem's is always "df"); the df rescue's
        self.pol_mode = False if plain_pol else (
            comp if self.df_final else ("df" if dfp else comp))
        self.verdict = None if not self.df_final else (
            True if dfp == "comp_final" else
            ("df" if r.verdict_jac == "df" else "df_res"))
        self.rescue_mode = "df" if dfp else self.pol_mode
        # the build's name: "fused_sweep", "fused_sweep_powerup" for the
        # power-up sibling's plan; "_group" for a build that couples lane
        # groups
        self.kernel_name = kernel_name + ("_group" if self.verify_group
                                          else "")
        self.P_pol = r.polish_iters if comp else 1
        self.P_fix = r.polish_fixed if comp else 0
        self.refine, self.vrefine = r.refine, r.verdict_refine
        self.stall_strikes = float(r.stall_strikes)
        self.plateau_strikes = float(r.plateau_strikes)
        self.tol = r.tol
        # the kernel's library and its file name, set by build.load_kernel
        self.cuda_lib = self.cuda_name = None
        self.a, self.b, self.c = P["a"], P["b"], P["c"]
        self.x0, self.y0 = P["x0"], P["y0"]
        self.dy, self.ey, self.fy = P["dy"], P["ey"], P["fy"]
        self.a_sp, self.b_sp, self.c_sp = (spl(self.a), spl(self.b),
                                           spl(self.c))
        self.dy_sp, self.ey_sp, self.fy_sp = (spl(self.dy), spl(self.ey),
                                              spl(self.fy))
        self.x0_sp = [SP(v) for v in self.x0]
        self.y0_sp = [SP(v) for v in self.y0]
        self.subs = []
        zoff = poff = doff = 0
        for k in range(r.nsub):
            nn, np_, nq = m.nn(k), m.np(k), m.nq(k)
            PS = P["subs"][k]
            # the element physics is models[0]'s: the models of a list
            # differ in matrix coefficients only (fused.py:898)
            s = dict(
                dq=PS["dq"], eq=PS["eq"], fqprev=PS["fqprev"], fq=PS["fq"],
                pexp=PS["pexp"], q0=PS["q0"],
                nl=m.nl_funcs[k], nn=nn, np=np_, nq=nq,
                off=zoff, poff=poff, doff=doff,
                zclip=[r.step_clip] * nn)
            # the df solve of the verdict: every subsystem with
            # df_solve=True, the structurally ill-conditioned ones with
            # "auto"; the fold loop above cond_eq 1e4 (fused.py:1350-1352,
            # :1953)
            s["df_slv"] = bool(r.df_solve is True or (
                r.df_solve == "auto" and r.sub_fragile[k]))
            s["fold"] = s["df_slv"] and r.sub_cond_eq[k] > 1e4
            for key in ("dq", "eq", "fqprev", "fq", "pexp"):
                s[key + "_sp"] = spl(s[key])
            s["q0_sp"] = [SP(v) for v in s["q0"]]
            s["p_rows"] = [any(_nz(cs) for row in (s["dq_sp"][i],
                                                   s["eq_sp"][i],
                                                   s["fqprev_sp"][i])
                               for cs in row) for i in range(np_)]
            self.subs.append(s)
            zoff += nn
            poff += np_
            doff += nn * np_


# -- dispatch -----------------------------------------------------------------

def fused_step(plan, u, lv, tol, gate, state, coef=None, group=None,
               stats=None):
    """Run the fused step over the whole time axis.

    Inputs are float32 tensors on one device: u (T, nu_t), lv (nu_l, L),
    tol (nsub, L), gate (3 nsub, L), the state dict of (n, L) tensors and
    ``coef``, the (hi, lo) per-lane coefficient tables of a multi-model
    runner, each (nvar, L) (``FusedRunner._coef_tables``; None for a plan
    without varying coefficients).  ``group``: the lanes of one lane group
    (``FusedRunner.group_size(L)``), which a plan that couples lane groups
    (``plan.verify_group``) needs and every other plan ignores.
    ``stats``: an int64 (counters, max(nsub, 1), L) tensor on the card to
    which the kernel adds its tier counters (``trace.COUNTERS``), or None;
    the plain version counts none.
    Returns (y (T, ny, L), new state, fails (L,), iters (nsub, L),
    floored (L,)).  CUDA tensors go through the kernel (or raise); the
    plain torch version runs only for CPU tensors.  A state without
    ``zlo`` or ``pmode`` gets zeros there."""
    dev = u.device
    if dev.type == "cuda":
        return _launch_kernel(plan, u, lv, tol, gate, state, coef, group,
                              stats)
    if stats is not None:
        raise ValueError("the plain version counts no tiers: stats must be "
                         "None on the CPU")
    if dev.type == "cpu":
        return plain_run(plan, u, lv, tol, gate, state, coef, group)
    raise ValueError(f"unsupported device {dev}")


def _group_lanes(plan, L, group):
    """The lanes of one lane group for a run of ``plan`` over L lanes:
    ``group`` when the plan couples lane groups (a multiple of LANE that
    divides L, else ValueError), L for every other plan."""
    if not plan.verify_group:
        return L
    if group is None or group <= 0 or group % LANE or L % group:
        raise ValueError(
            f"this plan couples lane groups: pass group=runner.group_size(L)"
            f" (a multiple of {LANE} dividing L = {L}), got {group!r}")
    return int(group)


def _coef_pair(plan, coef, like):
    """The (hi, lo) tables to hand on: ``coef``, or for a plan without
    varying coefficients one row of zeros each (never read)."""
    if coef is not None:
        return tuple(coef)
    if plan.nvar:
        raise ValueError(
            f"this plan reads {plan.nvar} per-lane coefficients: pass "
            "coef=runner._coef_tables(L)")
    z = torch.zeros((1, like.shape[1]), dtype=torch.float32,
                    device=like.device)
    return z, z


@trace.spanned("acme.launch")
def _library_call(lib, entry, plan, u, lv, tol, gate, state, coef, group,
                  *extra, stats=None):
    """Check the inputs, allocate the outputs and call the entry ``entry``
    of library ``lib`` (the CUDA launch or its host twin) on them.  A plan
    that couples lane groups gets the group's size and, for the card, each
    group's barrier words, zeroed: (G, 4) int32 (two flag slots, the
    arrival count and the generation).  ``stats``: the tier counters'
    int64 (counters, max(nsub, 1), L) buffer the launch adds to, or
    None."""
    L = lv.shape[1]
    Lg = _group_lanes(plan, L, group)
    T = u.shape[0]
    dev = u.device
    dims = _state_dims(plan)
    state = _complete_state(plan, state, lv)
    ch, cl = _coef_pair(plan, coef, lv)
    args = [u, lv, tol, gate, ch, cl] + [state[k] for k in STATE_KEYS]
    shapes = [(T, max(len(plan.time_idx), 1)),
              (max(len(plan.lane_idx) + len(plan.scale_idx), 1), L),
              (max(plan.nsub, 1), L), (3 * max(plan.nsub, 1), L),
              (max(plan.nvar, 1), L), (max(plan.nvar, 1), L)] \
        + [(dims[k], L) for k in STATE_KEYS]
    for name, t, shp in zip(("u", "lanes", "tol", "gate", "coef hi",
                             "coef lo") + STATE_KEYS, args, shapes):
        if t.device != dev or t.dtype != torch.float32 \
                or tuple(t.shape) != shp or not t.is_contiguous():
            raise ValueError(
                f"kernel input {name}: expected a contiguous float32 "
                f"{shp} tensor on {dev}, got {t.dtype} "
                f"{tuple(t.shape)} on {t.device}")
    shp = (len(trace.COUNTERS), max(plan.nsub, 1), L)
    if stats is not None and (stats.device != dev
                              or stats.dtype != torch.int64
                              or tuple(stats.shape) != shp
                              or not stats.is_contiguous()):
        raise ValueError(
            f"stats: expected a contiguous int64 {shp} tensor on {dev}, got "
            f"{stats.dtype} {tuple(stats.shape)} on {stats.device}")
    y = torch.empty((T, max(plan.ny, 1), L), dtype=torch.float32,
                    device=dev)
    out = {k: torch.empty((dims[k], L), dtype=torch.float32, device=dev)
           for k in STATE_KEYS}
    fails = torch.empty((L,), dtype=torch.int32, device=dev)
    iters = torch.empty((max(plan.nsub, 1), L), dtype=torch.int32,
                        device=dev)
    floored = torch.empty((L,), dtype=torch.int32, device=dev)
    words = (torch.zeros((L // Lg, 4), dtype=torch.int32, device=dev)
             if plan.verify_group else None)
    ptrs = [t.data_ptr() for t in args] \
        + [y.data_ptr()] + [out[k].data_ptr() for k in STATE_KEYS] \
        + [fails.data_ptr(), iters.data_ptr(), floored.data_ptr()]
    rc = getattr(lib, entry)(*[ctypes.c_void_p(p) for p in ptrs],
                             ctypes.c_int(T), ctypes.c_int(L),
                             ctypes.c_void_p(None if words is None
                                             else words.data_ptr()),
                             ctypes.c_int(Lg),
                             ctypes.c_void_p(None if stats is None
                                             else stats.data_ptr()), *extra)
    if rc != 0:
        # a CUDA build names its error; a host build fails only in a
        # lane group's threads or on a batch of partial groups
        if entry == "acme_fused_launch":
            what = lib.acme_cuda_error(rc).decode()
            if what == "cudaErrorCooperativeLaunchTooLarge":
                what += (f": one lane group of {Lg} lanes does not fit "
                         "resident on the card, which holds "
                         f"{resident_lanes(plan, dev, Lg, stats is not None)}"
                         " lanes of whole "
                         "groups of this build")
        else:
            what = _HOST_ERRORS.get(rc, "unknown")
        raise RuntimeError(f"fused kernel failed: error {rc} ({what})")
    return y, out, fails, iters, floored


# the host build's error codes (csrc/fused.cu acme_fused_host)
_HOST_ERRORS = {1: "a lane group's threads did not all start",
                2: "a lane group's barrier was stuck",
                3: "a batch that is not whole lane groups"}


def resident_lanes(plan, device, group, traced=False):
    """The lanes of whole lane groups of ``group`` lanes that CUDA
    ``device`` holds resident at once for ``plan``'s build: the batch its
    group launches take (``csrc/fused.cu`` ``acme_resident_lanes``; 0 when
    not one group fits); ``traced``: those of its traced step, which a
    launch with a stats buffer runs."""
    from .build import load_kernel
    lib = load_kernel(plan)
    device = torch.device(device)
    index = torch.cuda.current_device() if device.index is None \
        else device.index
    lanes = ctypes.c_int(0)
    rc = lib.acme_resident_lanes(index, int(group), int(bool(traced)),
                                 ctypes.byref(lanes))
    if rc != 0:
        raise RuntimeError(f"acme_resident_lanes failed: error {rc} "
                           f"({lib.acme_cuda_error(rc).decode()})")
    return lanes.value


def _launch_kernel(plan, u, lv, tol, gate, state, coef=None, group=None,
                   stats=None):
    from .build import load_kernel
    lib = load_kernel(plan)
    with torch.cuda.device(u.device):
        stream = torch.cuda.current_stream(u.device)
        timed = LAUNCH_EVENTS is not None
        if timed:
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record(stream)
        result = _library_call(lib, "acme_fused_launch", plan, u, lv, tol,
                               gate, state, coef, group,
                               ctypes.c_int(u.device.index),
                               ctypes.c_void_p(stream.cuda_stream),
                               stats=stats)
        if timed:
            ev[1].record(stream)
            LAUNCH_EVENTS.append(tuple(ev))
    LAUNCHES[plan.cuda_name] += 1
    return result


def host_step(lib, plan, u, lv, tol, gate, state, coef=None, group=None,
              batch=0, stats=None):
    """The kernel's own step compiled for the host (``build.load_host``),
    lane by lane on CPU tensors (a build that couples lane groups: each
    lane of a group on its own thread, one group after another), in
    batches of ``batch`` lanes at their lane offsets as the card launches
    them (0: one batch; a group build's batches are whole groups): the
    CPU tests' view of ``csrc``.  ``stats`` as for ``fused_step``: the
    host build counts every event as the card does, and no cycles."""
    return _library_call(lib, "acme_fused_host", plan, u, lv, tol, gate,
                         state, coef, group, ctypes.c_int(int(batch)),
                         stats=stats)


def _state_dims(plan):
    return {"x": max(plan.nx, 1), "xlo": max(plan.nx, 1),
            "z": max(plan.nn_total, 1), "zlo": max(plan.nn_total, 1),
            "zw": max(plan.nn_total, 1), "wp": max(plan.np_total, 1),
            "dzdp": max(plan.dz_total, 1), "pmode": max(plan.nsub, 1)}


# -- the plain version --------------------------------------------------------

def _clip(x, lo, hi):
    """jnp.clip: maximum then minimum, NaN-propagating, tensor bounds."""
    return torch.minimum(torch.maximum(x, lo), hi)


def _maxabs(vals):
    out = torch.abs(vals[0])
    for v in vals[1:]:
        out = torch.maximum(out, torch.abs(v))
    return out


def _all_finite(vals):
    out = torch.isfinite(vals[0])
    for v in vals[1:]:
        out = out & torch.isfinite(v)
    return out


def _sel(c, a, b):
    """Per-lane select over lists (or nested lists) of tensors."""
    if isinstance(a, list):
        return [_sel(c, x, y) for x, y in zip(a, b)]
    return torch.where(c, a, b)


class _Env:
    """The per-lane coefficients of one plain run: the rows of the (hi, lo)
    tables and the Dekker splits of the hi rows, made once per run as the
    JAX kernel makes them at its start (fused.py:925-997, :1037-1040), and
    the coefficient arithmetic for either kind of coefficient."""

    def __init__(self, nvar, ch, cl):
        self.v = [ch[j] for j in range(nvar)]
        self.lo = [cl[j] for j in range(nvar)]
        self.sp = [_split_rt(v) for v in self.v]

    @staticmethod
    def czero(cf):
        """Structural-zero test: only constants can be skipped."""
        return (not isinstance(cf, _Var)) and cf == 0.0

    def cval(self, cf):
        """A coefficient's value: a float (constant) or the lanes' row."""
        return self.v[cf.i] if isinstance(cf, _Var) else cf

    def coef_hi_lo(self, cs):
        """(hi, lo) initializer parts of a split coefficient."""
        if isinstance(cs, _Var):
            return self.v[cs.i], self.lo[cs.i]
        return cs[0], cs[3]

    def prod_coef(self, cs, v, vh, vl):
        """Error-free coefficient * value product for either coefficient
        kind; returns (product, error, coefficient hi)."""
        if isinstance(cs, _Var):
            av = self.v[cs.i]
            ah, al = self.sp[cs.i]
            pr = av * v
            err = ((ah * vh - pr) + ah * vl + al * vh) + al * vl \
                + self.lo[cs.i] * v
            return pr, err, av
        pr, err = _prod_const(cs, v, vh, vl)
        return pr, err, cs[0]

    def dot_df(self, coef_sp, vals, vlos=None, init=(0.0, 0.0)):
        """Compensated dot: float64 coefficients (pre-split constants or
        per-lane table entries) times (hi, lo) values, accumulated with
        error-free transforms (fused.py:965-985)."""
        hi, lo = init
        for idx, cs in enumerate(coef_sp):
            if not _nz(cs):
                continue
            v = vals[idx]
            if v is None:
                continue
            vh, vl = _split_rt(v)
            pr, err, c0 = self.prod_coef(cs, v, vh, vl)
            if vlos is not None and vlos[idx] is not None:
                err = err + c0 * vlos[idx]
            hi, e2 = _two_sum(hi, pr)
            lo = lo + (err + e2)
        return hi, lo

    def dotv(self, coeffs, vecs, init=None):
        """sum_j coeffs[j] * vecs[j], structural zeros skipped
        (fused.py:987-997)."""
        acc = init
        for cf, v in zip(coeffs, vecs):
            if self.czero(cf) or v is None:
                continue
            term = self.cval(cf) * v
            acc = term if acc is None else acc + term
        return acc


def _full(v, like):
    return v if isinstance(v, torch.Tensor) else torch.full_like(like, v)


class _SubSolver:
    """One subsystem's per-sample solve for all lanes (the body of the JAX
    kernel's subsystem loop, fused.py:1072-2266), with per-lane loops."""

    def __init__(self, plan, s, ksub, lanes_like, tol, gate, env, group):
        self.plan, self.s, self.env = plan, s, env
        self.group = group
        nsub = plan.nsub
        self.ltol = tol[ksub]
        self.lgate = gate[ksub]
        self.gate_v = gate[nsub + ksub]
        self.ptol = gate[2 * nsub + ksub]
        self.like = lanes_like
        self.dev = lanes_like.device

    def on_device(self):
        # the element composition allocates padding with xp.zeros, which
        # takes torch's default device
        if self.dev.type == "cpu":
            return contextlib.nullcontext()
        return torch.device(self.dev)

    # eval_at (fused.py:1174-1320)
    def eval_at(self, z, cmode, stats=True, pf=None, want_dfsys=False):
        s, env = self.s, self.env
        nn, nq = s["nn"], s["nq"]
        like = self.like
        q_lo = None
        if pf is not None:
            q = []
            for ci in range(nq):
                acc = env.dotv(s["fq"][ci], z)
                q.append(_full(pf[ci] if acc is None else acc + pf[ci], like))
        elif cmode:
            z_sp = [_split_rt(zz) for zz in z]
            q, q_lo = [], []
            for ci in range(nq):
                hi, lo = self.pfull[ci], self.pfull_lo[ci]
                for mi in range(nn):
                    cs = s["fq_sp"][ci][mi]
                    if not _nz(cs):
                        continue
                    pr, err, _ = env.prod_coef(cs, z[mi], *z_sp[mi])
                    hi, e2 = _two_sum(hi, pr)
                    lo = lo + (err + e2)
                q.append(hi)
                q_lo.append(lo)
        else:
            q = []
            for ci in range(nq):
                acc = env.dotv(s["fq"][ci], z)
                q.append(self.pfull[ci] if acc is None
                         else acc + self.pfull[ci])
        qv = torch.stack(q)
        Jq_df = res_df = None
        if cmode == "df":
            with self.on_device():
                res_df, Jq_df = s["nl"](dfm, dfm.DF(qv, torch.stack(q_lo)))
            res = res_df.hi + res_df.lo
            Jq = Jq_df.hi + Jq_df.lo
        elif cmode == "df_res":
            # the df residual with the plain Jacobian of the same point
            # (verdict_jac="plain", fused.py:1240-1254)
            with self.on_device():
                res_df, _ = s["nl"](dfm, dfm.DF(qv, torch.stack(q_lo)))
                _, Jq = s["nl"](txp, qv)
            res = res_df.hi + res_df.lo
        else:
            with self.on_device():
                res, Jq = s["nl"](txp, qv)
        if cmode and cmode not in ("df", "df_res"):
            corr = []
            for ai in range(nn):
                acc = res[ai]
                for ci in range(nq):
                    acc = acc + Jq[ai, ci] * q_lo[ci]
                corr.append(acc)
            res = torch.stack(corr)
        J = [[None] * nn for _ in range(nn)]
        for ai in range(nn):
            for bi in range(nn):
                acc = None
                for ci in range(nq):
                    cf = s["fq"][ci][bi]
                    if env.czero(cf):
                        continue
                    term = Jq[ai, ci] * env.cval(cf)
                    acc = term if acc is None else acc + term
                J[ai][bi] = acc if acc is not None else torch.zeros_like(like)
        dfsys = None
        if want_dfsys and cmode == "df":
            Jd = [[None] * nn for _ in range(nn)]
            for ai in range(nn):
                for bi in range(nn):
                    acc = None
                    for ci in range(nq):
                        cf = s["fq"][ci][bi]
                        if env.czero(cf):
                            continue
                        term = Jq_df[ai, ci] * env.cval(cf)
                        acc = term if acc is None else acc + term
                    Jd[ai][bi] = acc if acc is not None \
                        else dfm.DF(torch.zeros_like(like))
            dfsys = ([res_df[ai] for ai in range(nn)], Jd)
        res = [res[ai] for ai in range(nn)]
        if not stats:
            return res, J, Jq, None, None, dfsys
        resmax = _maxabs(res)
        scale = None
        for ai in range(nn):
            acc = None
            for ci in range(nq):
                t2 = torch.abs(Jq[ai, ci]) * torch.abs(qv[ci])
                acc = t2 if acc is None else acc + t2
            scale = acc if scale is None else torch.maximum(scale, acc)
        return res, J, Jq, resmax, scale, dfsys

    def clipdz(self, dz):
        zc = self.s["zclip"]
        return [torch.clamp(d, -zc[ai], zc[ai]) for ai, d in enumerate(dz)]

    # gated Newton loop (fused.py:1373-1483)
    def run_newton(self, zs0):
        plan = self.plan
        nn = self.s["nn"]
        K = plan.K
        z = list(zs0)
        big = torch.full_like(self.like, 3e38)
        zero = torch.zeros_like(self.like)
        prev, strikes, strikes_hi = big, zero, zero
        zlast, rlast, glast = list(zs0), big, self.lgate.clone()
        itv = torch.full_like(self.like, float(K))
        plat = zero
        live = torch.ones_like(self.like, dtype=torch.bool)
        it = 0
        while it < K and bool(live.any()):
            res, J, _, resmax, scale, _ = self.eval_at(z, False)
            tol_eff = _clip(plan.rel_tol * scale, self.ltol, 1e4 * self.ltol)
            gate_eff = _clip(plan.rel_gate * scale, self.lgate,
                             1e4 * self.lgate)
            dz = solve_rows(J, [res], refine=0, pivot=plan.pivot)[0]
            stall_any = resmax >= 0.995 * prev
            stalled = stall_any & (resmax < gate_eff)
            strikes_n = torch.where(stalled, strikes + 1.0, zero)
            strikes_hi_n = torch.where(stall_any & (resmax >= gate_eff),
                                       strikes_hi + 1.0, zero)
            struck = strikes_n >= plan.stall_strikes
            plat_n = strikes_hi_n >= plan.plateau_strikes
            done = (resmax < tol_eff) | struck | plat_n
            bad = ~torch.isfinite(resmax) | ~_all_finite(dz)
            move = ~(done | bad)
            dz = self.clipdz(dz)
            z_new = [torch.where(move, z[ai] - dz[ai], z[ai])
                     for ai in range(nn)]
            zlast = _sel(live, z, zlast)
            rlast = torch.where(live, resmax, rlast)
            glast = torch.where(live, gate_eff, glast)
            plat = torch.where(live, plat_n.float(), plat)
            itv = torch.where(live & done, float(it + 1), itv)
            z = _sel(live, z_new, z)
            prev = torch.where(live, resmax, prev)
            strikes = torch.where(live, strikes_n, strikes)
            strikes_hi = torch.where(live, strikes_hi_n, strikes_hi)
            live = live & ~done
            it += 1
        return zlast, rlast, glast, itv, plat

    # homotopy continuation rescue (fused.py:1485-1583)
    def homotopy_rescue(self, zs0, r0, g0, it0):
        s = self.s
        nn, np_, nq = s["nn"], s["np"], s["nq"]
        need = ~(r0 < g0) | ~torch.isfinite(r0)
        zw, wp = self.zw, self.wp
        K2, TRIPS = 16, 6 * 16
        z_h = list(zs0)
        z_good = [zw[s["off"] + i] for i in range(nn)]
        zero = torch.zeros_like(self.like)
        a_good, a_try, k_in = zero, torch.ones_like(self.like), zero
        solved = torch.zeros_like(self.like, dtype=torch.bool)
        trips = zero
        while True:
            act = need & ~solved & (trips < TRIPS)
            if not bool(act.any()):
                break
            pmix = [wp[s["poff"] + i2] + a_try
                    * (self.p[i2] - wp[s["poff"] + i2]) for i2 in range(np_)]
            pf = []
            for ci in range(nq):
                acc = self.env.dotv(s["pexp"][ci], pmix)
                base = self.env.cval(s["q0"][ci])
                pf.append(base if acc is None else acc + base)
            res, J, _, resmax, scale, _ = self.eval_at(z_h, False, pf=pf)
            gate_eff = _clip(self.plan.rel_gate * scale, self.lgate,
                             1e4 * self.lgate)
            ok = resmax < gate_eff
            dz = solve_rows(J, [res], refine=0, pivot=True)[0]
            bad = ~torch.isfinite(resmax) | ~_all_finite(dz)
            move = act & ~(ok | bad)
            dz = self.clipdz(dz)
            z_new = [torch.where(move, z_h[ai] - dz[ai], z_h[ai])
                     for ai in range(nn)]
            commit = act & ok
            z_good = _sel(commit, z_h, z_good)
            a_good = torch.where(commit, a_try, a_good)
            solved = solved | (commit & (a_try >= 1.0))
            k_next = torch.where(commit, 0.0, k_in + 1.0)
            exh = act & (k_next >= K2) & ~ok
            a_next = torch.where(commit, 1.0,
                                 torch.where(exh, 0.5 * (a_good + a_try),
                                             a_try))
            z_new = _sel(exh, z_good, z_new)
            k_next = torch.where(exh, 0.0, k_next)
            z_h = z_new
            a_try = torch.where(act, a_next, a_try)
            k_in = torch.where(act, k_next, k_in)
            trips = trips + act.float()
        take = need & solved
        return (_sel(take, z_h, zs0), torch.where(take, 0.5 * g0, r0), g0,
                it0 + torch.where(need, trips, 0.0))

    # double-float Newton rescue (fused.py:1585-1637)
    def df_rescue(self, zs0, r0, g0, it0):
        nn = self.s["nn"]
        need = ~(r0 < g0) | ~torch.isfinite(r0)
        K3 = 24
        zs = list(zs0)
        rm = torch.full_like(self.like, 3e38)
        k = torch.zeros_like(self.like)
        for _ in range(K3):
            act = need & ~(rm < g0)
            if not bool(act.any()):
                break
            res, J, _, resmax, _, _ = self.eval_at(zs,
                                                   self.plan.rescue_mode)
            ok = resmax < g0
            dz = solve_rows(J, [res], refine=self.plan.refine, pivot=True)[0]
            bad = ~torch.isfinite(resmax) | ~_all_finite(dz)
            move = act & ~(ok | bad)
            dz = self.clipdz(dz)
            zs = [torch.where(move, zs[ai] - dz[ai], zs[ai])
                  for ai in range(nn)]
            rm = torch.where(act, resmax, rm)
            k = k + act.float()
        take = need & ((rm < r0) | ~torch.isfinite(r0))
        return (_sel(take, zs, zs0), torch.where(take, rm, r0), g0,
                it0 + torch.where(need, k, 0.0))

    def full_solve(self, zs):
        """Gated Newton, then homotopy, then df Newton (fused.py:1642)."""
        z, r, g, itv, _ = self.run_newton(zs)
        if not bool((r < g).all()):
            z, r, g, itv = self.homotopy_rescue(z, r, g, itv)
        if not bool((r < g).all()):
            z, r, g, itv = self.df_rescue(z, r, g, itv)
        return z, r, g, itv

    # polish_eval (fused.py:1652-1748)
    def polish_eval(self, zs, mode=False, light=False, verdict=False):
        s, plan = self.s, self.plan
        nn, np_, nq = s["nn"], s["np"], s["nq"]
        res_c, J, Jq, resmax_c, scale_c, dfsys = self.eval_at(
            zs, mode, want_dfsys=(mode == "df" and s["df_slv"]))
        lgate_eff = _clip(plan.rel_gate * scale_c, self.lgate,
                          1e4 * self.lgate)
        gate_eff_f = _clip(plan.rel_gate_f * scale_c, self.gate_v,
                           1e4 * self.gate_v)
        tol_pol = _clip(plan.rel_tol_pol * scale_c, self.ptol,
                        1e4 * self.ptol)
        ltol_eff = _clip(plan.rel_tol * scale_c, self.ltol, 1e4 * self.ltol)
        # the sensitivity columns J \ Jp ride along when the origin is
        # maintained (extrapolate True or "track")
        with_cols = plan.extrap and np_
        rhs = [res_c]
        if with_cols and not light:
            for bi in range(np_):
                col = []
                for ai in range(nn):
                    acc = None
                    for ci in range(nq):
                        cf = s["pexp"][ci][bi]
                        if self.env.czero(cf):
                            continue
                        term = Jq[ai, ci] * self.env.cval(cf)
                        acc = term if acc is None else acc + term
                    col.append(acc if acc is not None
                               else torch.zeros_like(self.like))
                rhs.append(col)
        if dfsys is not None:
            res_d, Jd = dfsys
            rhs_d = [res_d] + [[dfm.DF(cv) for cv in cc] for cc in rhs[1:]]
            Xd = solve_rows(Jd, rhs_d, refine=0, pivot=True, xp=dfm)
            X = [[v.value() for v in row] for row in Xd]
        else:
            rf = 0 if light else (plan.vrefine if verdict else plan.refine)
            X = solve_rows(J, rhs, refine=rf, pivot=True)
        dz = X[0]
        fin = torch.isfinite(resmax_c) & _all_finite(dz)
        if with_cols and not light:
            cols = [[X[1 + bi][ai] for ai in range(nn)] for bi in range(np_)]
        elif with_cols:
            nan = torch.full_like(self.like, float("nan"))
            cols = [[nan] * nn for _ in range(np_)]
        else:
            cols = []
        return (dz, cols, resmax_c, lgate_eff, gate_eff_f, tol_pol,
                ltol_eff, fin)

    # polish_all: the polish loop with its unrolled prefix, then the
    # verdict (comp, df or df_res) and the fold loop (fused.py:1750-2016)
    def polish_all(self, zs):
        s, plan = self.s, self.plan
        nn, np_ = s["nn"], s["np"]
        like = self.like
        big = torch.full_like(like, 3e38)
        zero = torch.zeros_like(like)
        zc = s["zclip"]
        ncols = np_ if plan.extrap else 0
        st = dict(z=list(zs), cols=[[zero] * nn for _ in range(ncols)],
                  rm=big, rm1=big, tl1=self.ltol.clone(),
                  lg=self.lgate.clone(), gf=self.gate_v.clone(),
                  tp=self.ptol.clone(), pfrz=zero, pstall=zero, k=zero)
        P_pol = plan.P_pol
        n_fix = min(plan.P_fix, P_pol)
        it = 0
        while True:
            if it < n_fix:
                act_l = torch.ones_like(like, dtype=torch.bool)
            else:
                act_l = (st["k"] < P_pol) & ~((st["rm"] < st["tp"])
                                              | (st["pfrz"] > 0.5))
                if not bool(act_l.any()):
                    break
            (dz, cols, resmax_c, lgate_eff, gate_eff_f, tol_pol, ltol_eff,
             fin) = self.polish_eval(st["z"], plan.pol_mode,
                                     light=plan.df_final)
            not_contracting = fin & (resmax_c >= 0.7 * st["rm"])
            pfrz = torch.maximum(st["pfrz"], not_contracting.float())
            unclip = None
            for ai in range(nn):
                u_i = torch.abs(dz[ai]) < 0.9 * zc[ai]
                unclip = u_i if unclip is None else unclip & u_i
            pstall = torch.maximum(
                st["pstall"], (not_contracting & unclip
                               & (resmax_c >= tol_pol)
                               & (resmax_c < 1e3 * gate_eff_f)).float())
            first = st["k"] == 0
            act = fin & (resmax_c >= tol_pol) & (first | (pfrz < 0.5))
            dzc = self.clipdz(dz)
            zp = [torch.where(act, st["z"][ai] - dzc[ai], st["z"][ai])
                  for ai in range(nn)]
            new = dict(z=zp, cols=cols, rm=resmax_c,
                       rm1=torch.where(first, resmax_c, st["rm1"]),
                       tl1=torch.where(first, ltol_eff, st["tl1"]),
                       lg=lgate_eff, gf=gate_eff_f, tp=tol_pol, pfrz=pfrz,
                       pstall=pstall, k=st["k"] + 1.0)
            st = {key: _sel(act_l, new[key], st[key]) for key in st}
            it += 1
        st["zlo"] = [zero] * nn
        if plan.verdict is None:
            return st
        # the verdict: one evaluation and guarded final step, in df for a
        # df-solve subsystem, else in the configured tier
        vmode = "df" if s["df_slv"] else plan.verdict

        def vd_pass(st):
            (dzf, colsf, rm_df, lgf, gff, tpf, _tl, finf) = self.polish_eval(
                st["z"], vmode, verdict=True)
            out = dict(st)
            out["tp"] = torch.where(finf, tpf, st["tp"])
            vstep = finf if s["df_slv"] else finf & (rm_df >= tpf)
            zp_n, zlo_n = [], []
            for ai in range(nn):
                dzc = torch.clamp(dzf[ai], -zc[ai], zc[ai])
                hi2, lo2 = _two_sum(st["z"][ai], -dzc)
                zp_n.append(torch.where(vstep, hi2, st["z"][ai]))
                zlo_n.append(torch.where(vstep, lo2, zero))
            out["z"], out["zlo"] = zp_n, zlo_n
            out["rm"] = torch.where(finf, rm_df, st["rm"])
            out["lg"] = torch.where(finf, lgf, st["lg"])
            out["gf"] = torch.where(finf, gff, st["gf"])
            out["cols"] = _sel(finf, colsf, st["cols"])
            out["k"] = st["k"] + 1.0
            return out, rm_df

        st, rm_df0 = vd_pass(st)
        if s["fold"]:
            vtgt = float(np.float32(0.02 * plan.tol))
            rm_prev = rm_df0
            for _ in range(9):
                go = (rm_prev >= vtgt) & torch.isfinite(rm_prev)
                if not bool(go.any()):
                    break
                st2, rm_df = vd_pass(st)
                act = go & (rm_df <= 0.9 * rm_prev)
                rm_prev = torch.where(go, torch.where(act, rm_df, zero),
                                      rm_prev)
                st2["k"] = st["k"] + 1.0
                st = {key: _sel(go, _sel(act, st2[key], st[key])
                                if key != "k" else st2[key], st[key])
                      for key in st}
        return st

    def fast_entry(self, z0):
        """The fast path: ``fast`` unguarded steps with the
        already-converged guard (none with polish_only), the polish, the
        keep test, and the robust path redone for the lanes that fail it
        ("merge"), for every lane of a lane group with a lane that fails it
        ("group") or for every lane ("always") (fused.py:2018-2146)."""
        plan, nn = self.plan, self.s["nn"]
        zs_cur = z0
        for _ in range(plan.fast):
            res_f, J_f, _, _, _, _ = self.eval_at(zs_cur, False, stats=False)
            rmf = _maxabs(res_f)
            dzf = solve_rows(J_f, [res_f], refine=0, pivot=plan.pivot)[0]
            okf = _all_finite(dzf) & (rmf >= self.ltol)
            dzf = self.clipdz(dzf)
            zs_cur = [torch.where(okf, zs_cur[ai] - dzf[ai], zs_cur[ai])
                      for ai in range(nn)]
        st = self.polish_all(zs_cur)
        itv = float(plan.fast) + st["k"]
        keep_thr = st["tp"] if plan.keep_tol else st["gf"]
        ok1 = (st["rm"] < keep_thr) | ((st["rm1"] < st["tl1"])
                                       & (st["pstall"] > 0.5))
        if plan.verify_always:
            need = torch.ones_like(ok1)
        elif plan.verify_group:
            # jax.lax.cond(jnp.all(ok1), keep, redo) over each group
            g = self.group
            need = (~ok1).view(-1, g).any(1).repeat_interleave(g)
        else:
            need = ~ok1
        if bool(need.any()):
            zs4, _, _, itv4 = self.full_solve(zs_cur)
            st2 = self.polish_all(zs4)
            for key in ("z", "zlo", "cols", "rm", "gf", "pstall"):
                st[key] = _sel(need, st2[key], st[key])
            itv = itv + torch.where(need, itv4 + st2["k"], 0.0)
        return st, itv

    def solve(self, p, zw, wp, dzdp):
        """The subsystem's per-sample solve given its p (fused.py:2018-2266).
        Returns (z, zlo, fail, floor, pstall, itv, new zw/wp/dzdp parts)."""
        s, plan, env = self.s, self.plan, self.env
        nn, np_, nq = s["nn"], s["np"], s["nq"]
        o, po, do = s["off"], s["poff"], s["doff"]
        zc = s["zclip"]
        self.p, self.zw, self.wp = p, zw, wp
        self.pfull, self.pfull_lo = [], []
        if plan.comp:
            # pfull = q0 + Pexp p as an unevaluated (hi, lo) pair
            p_sp = [_split_rt(pi) for pi in p]
            for ci in range(nq):
                hi, lo = (_full(v, self.like)
                          for v in env.coef_hi_lo(s["q0_sp"][ci]))
                for i in range(np_):
                    cs = s["pexp_sp"][ci][i]
                    if not _nz(cs):
                        continue
                    pr, err, _ = env.prod_coef(cs, p[i], *p_sp[i])
                    hi, e2 = _two_sum(hi, pr)
                    lo = lo + (err + e2)
                self.pfull.append(hi)
                self.pfull_lo.append(lo)
        else:
            # plain float32 (fused.py:1134-1140)
            for ci in range(nq):
                acc = env.dotv(s["pexp"][ci], p)
                base = env.cval(s["q0"][ci])
                self.pfull.append(_full(base if acc is None else acc + base,
                                        self.like))
        # extrapolated warm start, jump capped at 4 trust regions (with
        # extrapolate "track" or False the start is zw itself)
        if np_ and plan.extrap_use:
            dp = [p[i] - wp[po + i] for i in range(np_)]
            z0 = []
            for i1 in range(nn):
                acc = None
                for i2 in range(np_):
                    term = dzdp[do + i1 * np_ + i2] * dp[i2]
                    acc = term if acc is None else acc + term
                z0.append(zw[o + i1] + torch.clamp(acc, -4.0 * zc[i1],
                                                   4.0 * zc[i1]))
        else:
            z0 = [zw[o + i1] for i1 in range(nn)]
        if plan.fast_path:
            st, itv = self.fast_entry(z0)
        else:
            # the robust path from the warm start, then the polish
            # (fused.py:2147-2151)
            zs4, _, _, itv4 = self.full_solve(z0)
            st = self.polish_all(zs4)
            itv = itv4 + st["k"]
        zp, zlo, cols = st["z"], st["zlo"], st["cols"]
        resmax_c, gate_eff_f, pstall = st["rm"], st["gf"], st["pstall"]
        # acceptance, floor certificate, plausibility (fused.py:2153-2266)
        z_implaus = None
        for i1 in range(nn):
            bad_i = ~torch.isfinite(zp[i1]) | (torch.abs(zp[i1]) > 1e4)
            z_implaus = bad_i if z_implaus is None else (z_implaus | bad_i)
        conv = (resmax_c < gate_eff_f) | ((pstall > 0.5) & ~z_implaus)
        fail_k = ~conv
        implaus = z_implaus | ~torch.isfinite(resmax_c)
        floor_k = conv & ~(resmax_c < gate_eff_f)
        zsub = fail_k & implaus
        z_out = [torch.where(zsub, zw[o + i1], zp[i1]) for i1 in range(nn)]
        zlo_out = [torch.where(zsub, torch.zeros_like(zlo[i1]), zlo[i1])
                   for i1 in range(nn)]
        ok = ~implaus
        zw_n = [torch.where(ok, zp[i1], zw[o + i1]) for i1 in range(nn)]
        wp_n = [torch.where(ok, p[i2], wp[po + i2]) for i2 in range(np_)]
        dz_n = [dzdp[do + i] for i in range(nn * np_)]
        if np_ and plan.extrap:
            okd = ok & conv
            for bi in range(np_):
                for ai in range(nn):
                    okd = okd & (torch.abs(cols[bi][ai]) < 1e6)
            for i1 in range(nn):
                for i2 in range(np_):
                    di = i1 * np_ + i2
                    dz_n[di] = torch.where(okd, -cols[i2][i1], dz_n[di])
        return (z_out, zlo_out, fail_k, floor_k, pstall, itv, zw_n, wp_n,
                dz_n)


def plain_run(plan, u, lv, tol, gate, state, coef=None, group=None):
    """The plain torch version of the kernel: same inputs and outputs as
    :func:`fused_step`, vectorised over lanes, per-lane loop semantics (and
    the keep test's redo per lane group where the plan couples them)."""
    T = u.shape[0]
    L = lv.shape[1]
    Lg = _group_lanes(plan, L, group)
    nsub = plan.nsub
    env = _Env(plan.nvar, *_coef_pair(plan, coef, lv))
    state = _complete_state(plan, state, lv)
    st = {k: state[k].clone() for k in STATE_KEYS}
    x = [st["x"][i] for i in range(plan.nx)]
    xlo = [st["xlo"][i] for i in range(plan.nx)]
    z = [st["z"][i] for i in range(plan.nn_total)]
    zlo = [st["zlo"][i] for i in range(plan.nn_total)]
    zw = [st["zw"][i] for i in range(plan.nn_total)]
    wp = [st["wp"][i] for i in range(plan.np_total)]
    dzdp = [st["dzdp"][i] for i in range(plan.dz_total)]
    pmode = [st["pmode"][i] for i in range(max(nsub, 1))]
    like = lv[0]
    ys = torch.empty((T, max(plan.ny, 1), L), dtype=torch.float32,
                     device=u.device)
    fails = torch.zeros(L, dtype=torch.int32, device=u.device)
    floored = torch.zeros(L, dtype=torch.int32, device=u.device)
    iters = torch.zeros((max(nsub, 1), L), dtype=torch.int32,
                        device=u.device)
    solvers = [_SubSolver(plan, s, k, like, tol, gate, env, Lg)
               for k, s in enumerate(plan.subs)]
    for t in range(T):
        u_full = [None] * plan.nu
        for jj, g in enumerate(plan.time_idx):
            u_full[g] = u[t, jj].expand(L)
        for jj, g in enumerate(plan.lane_idx):
            u_full[g] = lv[jj]
        for jj, g in enumerate(plan.scale_idx):
            u_full[g] = u_full[g] * lv[len(plan.lane_idx) + jj]
        z_all, z_lo_all = list(z), list(zlo)
        any_fail = any_floor = None
        for k, (s, sv) in enumerate(zip(plan.subs, solvers)):
            p = []
            for i in range(s["np"]):
                if not plan.dfs:
                    # plain float32 dots (fused.py:1107-1110)
                    acc = env.dotv(s["dq"][i], x)
                    acc = env.dotv(s["eq"][i], u_full, acc)
                    acc = env.dotv(s["fqprev"][i], z_all, acc)
                    p.append(torch.zeros_like(like) if acc is None
                             else _full(acc, like))
                elif s["p_rows"][i]:
                    hi, lo = env.dot_df(s["dq_sp"][i], x, xlo)
                    hi, lo = env.dot_df(s["eq_sp"][i], u_full, init=(hi, lo))
                    hi, lo = env.dot_df(s["fqprev_sp"][i], z_all, z_lo_all,
                                        init=(hi, lo))
                    p.append(_full(hi + lo, like))
                else:
                    p.append(torch.zeros_like(like))
            (zk, zlok, fail_k, floor_k, pstall, itv, zw_n, wp_n,
             dz_n) = sv.solve(p, zw, wp, dzdp)
            o, po, do = s["off"], s["poff"], s["doff"]
            z_all[o:o + s["nn"]] = zk
            z_lo_all[o:o + s["nn"]] = zlok
            zw[o:o + s["nn"]] = zw_n
            wp[po:po + s["np"]] = wp_n
            dzdp[do:do + s["nn"] * s["np"]] = dz_n
            pmode[k] = pstall
            iters[k] += itv.to(torch.int32)
            any_fail = fail_k if any_fail is None else any_fail | fail_k
            any_floor = floor_k if any_floor is None else any_floor | floor_k
        if plan.dfs:
            # EFT output row and state update (fused.py:2268-2322)
            for oi in range(plan.ny):
                hi, lo = env.dot_df(plan.dy_sp[oi], x, xlo,
                                    init=env.coef_hi_lo(plan.y0_sp[oi]))
                hi, lo = env.dot_df(plan.ey_sp[oi], u_full, init=(hi, lo))
                hi, lo = env.dot_df(plan.fy_sp[oi], z_all, z_lo_all,
                                    init=(hi, lo))
                ys[t, oi] = _full(hi + lo, like)
            x_new = []
            for xi in range(plan.nx):
                hi, lo = env.dot_df(plan.a_sp[xi], x, xlo,
                                    init=env.coef_hi_lo(plan.x0_sp[xi]))
                hi, lo = env.dot_df(plan.b_sp[xi], u_full, init=(hi, lo))
                hi, lo = env.dot_df(plan.c_sp[xi], z_all, z_lo_all,
                                    init=(hi, lo))
                x_new.append(_two_sum(_full(hi, like), _full(lo, like)))
            x = [h for h, _ in x_new]
            xlo = [lo_ for _, lo_ in x_new]
            z, zlo = z_all, z_lo_all
        else:
            # plain float32 read-outs, state and z without lo parts
            # (fused.py:2291-2334)
            for oi in range(plan.ny):
                acc = env.dotv(plan.dy[oi], x)
                acc = env.dotv(plan.ey[oi], u_full, acc)
                acc = env.dotv(plan.fy[oi], z_all, acc)
                y0 = env.cval(plan.y0[oi])
                ys[t, oi] = _full(y0 if acc is None else acc + y0, like)
            x_new = []
            for xi in range(plan.nx):
                acc = env.dotv(plan.a[xi], x)
                acc = env.dotv(plan.b[xi], u_full, acc)
                acc = env.dotv(plan.c[xi], z_all, acc)
                x0 = env.cval(plan.x0[xi])
                x_new.append(_full(x0 if acc is None else acc + x0, like))
            x = x_new
            xlo = [torch.zeros_like(like)] * plan.nx
            z = z_all
            zlo = [torch.zeros_like(like)] * plan.nn_total
        if any_fail is not None:
            fails += any_fail.to(torch.int32)
            floored += any_floor.to(torch.int32)
    dims = _state_dims(plan)

    def pack(key, rows):
        if not rows:
            return state[key].clone()
        return torch.stack(rows).reshape(dims[key], L).contiguous()

    out = {"x": pack("x", x), "xlo": pack("xlo", xlo), "z": pack("z", z),
           "zlo": pack("zlo", zlo), "zw": pack("zw", zw),
           "wp": pack("wp", wp), "dzdp": pack("dzdp", dzdp),
           "pmode": pack("pmode", pmode if nsub else [])}
    return ys, out, fails, iters, floored
