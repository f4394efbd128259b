"""The float64 scan engine (``acme_tpu/engine.py``) on PyTorch and CUDA.

The JAX package runs a compiled model as ``lax.scan`` over time, vmapped
over a lane axis: per sample the ordered subsystem chain (each subsystem's
p depends on the z of the earlier ones in the same sample), each subsystem
solved by the masked Newton + homotopy of ``ops.newton``.  Here the whole
run loop is one launch of a hand-written CUDA kernel (``ops/csrc/scan.cu``,
one thread per lane, its carry in shared memory), built at first use for the
model's sizes and element physics; the model matrices, the tolerance and
the loop limits are its arguments, so one build serves a model at any
tolerance and a batch of same-topology models (``compile_models``).  On
the CPU (``device="cpu"``) the same step runs as plain torch ops over the
lanes (``ops.newton``, ``ops.linsolve``), one sample at a time.

    cm = compile_model(model)                  # float64, tol 1e-10, the card
    y, state, info = cm.run(u)                 # u (nu, T) or (L, nu, T)
    y, state, info = cm.run_sweep(u_time, lane_values, lane_input_idx)

A state is ``{"x": (L, nx), "warms": (WarmStart of (L, .), ...)}`` of
tensors on the engine's device.  Failure semantics as the JAX package's:
per-lane per-sample convergence flags and Newton iterations in
``RunInfo``; ``run`` raises on a non-finite output and warns on a
non-converged sample, reducing on the device to two scalars.
"""

from __future__ import annotations

import collections
import ctypes
import warnings
from typing import NamedTuple, Optional

import numpy as np
import torch

from .model import DiscreteModel
from .ops import emit
from .ops.newton import WarmStart, make_subsystem_solver_mats, mv

__all__ = ["CompiledModel", "compile_model", "BatchCompiledModel",
           "compile_models", "RunInfo", "LAUNCHES", "LAUNCH_EVENTS"]

# launches of the scan kernel, by "<library file>/<f64|f32>", counted where
# the kernel is launched and nowhere else
LAUNCHES = collections.Counter()
# set to a list to time each launch: (start, end) CUDA events recorded on
# the launch stream just around the kernel
LAUNCH_EVENTS = None

# newton.py's bound on the homotopy's steps
MAX_HOMOTOPY_STEPS = 4096
# the launch's code for a block that needs more shared memory than the card
# gives one (csrc/scan.cu SMEM_TOO_LARGE)
SMEM_TOO_LARGE = -2


class RunInfo(NamedTuple):
    """Per-sample solver diagnostics (the reference's needediterations and
    warn-path flags, solvers.jl:205 / ACME.jl:688-694)."""

    converged: torch.Tensor  # (T, L) bool
    iters: torch.Tensor      # (T, L, nsub) int32 Newton iterations per
    #                          subsystem (sum over axis -1 for totals)

    def iter_histogram(self, bins=(1, 2, 3, 5, 8, 13, 21, 34, 55)):
        """Per-subsystem histogram of Newton iteration counts: returns
        (edges, counts (nsub, len(edges)+1)) over all samples and lanes."""
        it = self.iters.cpu().numpy()
        it = it.reshape(-1, it.shape[-1])
        edges = np.asarray(bins)
        counts = np.stack([
            np.bincount(np.digitize(it[:, k], edges),
                        minlength=len(edges) + 1)
            for k in range(it.shape[1])])
        return edges, counts


def _finite_conv(y, conv):
    """Device-side reduction for the warn path: two scalars instead of the
    whole output."""
    return torch.isfinite(y).all(), conv.all()


def _dtype(dtype):
    if dtype is None:
        return torch.float64
    if dtype not in (torch.float64, torch.float32):
        raise ValueError("dtype must be torch.float64 or torch.float32, got "
                         f"{dtype!r}")
    return dtype


def _engine_device(device):
    """The engine's device: the card unless the caller asks for the CPU;
    without a card, a CUDA device raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"scan engine (device={str(device)!r}): no CUDA card found; "
                'pass device="cpu" for the plain version')
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


def _origin_warm(m, k, with_p):
    """The solver's initial origin for subsystem k of model m: p = 0,
    z = init_z and dz/dp evaluated there, as the reference solver
    constructors do (ACME.jl:253-260, solvers.jl:164-178); ``with_p``
    adds Pexp p0 to q as CompiledModel does (BatchCompiledModel does
    not)."""
    p0 = np.zeros(m.np(k))
    z0 = np.asarray(m.init_zs[k], float)
    q = np.asarray(m.q0s[k])
    if with_p:
        q = q + np.asarray(m.pexps[k]) @ p0
    q = q + np.asarray(m.fqs[k]) @ z0
    res, Jq = m.nl_funcs[k](np, q)
    J = Jq @ np.asarray(m.fqs[k])
    Jp = Jq @ np.asarray(m.pexps[k])
    try:
        dzdp = -np.linalg.solve(J, Jp)
    except np.linalg.LinAlgError:
        dzdp = np.zeros_like(Jp)
    return p0, z0, dzdp


class _Src(NamedTuple):
    """Where each model input comes from: ``umap[i] = (kind, j)``, kind 0
    row j of the shared time rows ``ut`` (n, T), 1 column j of the per-lane
    constants ``lv`` (L, n), 2 row j of the per-lane series ``ul``
    (L, n, T)."""
    umap: tuple
    ut: Optional[torch.Tensor] = None
    ul: Optional[torch.Tensor] = None
    lv: Optional[torch.Tensor] = None

    def lanes(self, sl, dev):
        """The lanes ``sl`` on ``dev`` (the time rows whole)."""
        def on(t, cut=True):
            return None if t is None else (t[sl] if cut else t).to(dev)
        return self._replace(ut=on(self.ut, cut=False), ul=on(self.ul),
                             lv=on(self.lv))

    def at(self, t, L, nu, like):
        """The (L, nu) inputs of sample t."""
        u = torch.zeros((L, nu), dtype=like.dtype, device=like.device)
        for i, (kind, j) in enumerate(self.umap):
            u[:, i] = (self.ut[j, t] if kind == 0 else self.lv[:, j]
                       if kind == 1 else self.ul[:, j, t])
        return u


class _Engine:
    """What CompiledModel and BatchCompiledModel share: the matrices as
    torch tensors (shared, or with a leading lane axis) and as the kernel's
    per-lane blocks, the subsystem solvers of the plain version, the
    kernel's header and library, and the scan over either."""

    def _setup(self, m0, models, dtype, tol, newton_maxiter, homotopy,
               device, per_lane):
        self.dtype = _dtype(dtype)
        self.device = _engine_device(device)
        if tol is None:
            tol = 1e-10 if self.dtype == torch.float64 else 5e-4
        self.tol = float(tol)
        self.newton_maxiter = int(newton_maxiter)
        self.homotopy = bool(homotopy)
        self.max_homotopy_steps = MAX_HOMOTOPY_STEPS
        self.nx, self.nu, self.ny = m0.nx, m0.nu, m0.ny
        self.nn_total = m0.nn()
        self.nsub = m0.nsubsystems
        dims = [(m0.nn(k), m0.np(k), m0.nq(k)) for k in range(self.nsub)]
        self._dims = dims
        self._layout = emit.engine_layout(self.nx, self.nu, self.ny, dims)
        self._nls = m0.nl_funcs
        self._header = emit.engine_header(self.nx, self.nu, self.ny, dims,
                                          m0.nl_funcs)
        self._lib = None
        self.lib_name = None

        def mats_of(m):
            out = {"a": m.a, "b": m.b, "c": m.c, "x0": m.x0, "dy": m.dy,
                   "ey": m.ey, "fy": m.fy, "y0": m.y0}
            for k in range(self.nsub):
                for n, v in (("dq", m.dqs), ("eq", m.eqs),
                             ("fqprev", m.fqprevs), ("fq", m.fqs),
                             ("pexp", m.pexps), ("q0", m.q0s)):
                    out[f"{n}{k}"] = v[k]
            return out

        raw = [mats_of(m) for m in models]
        # the kernel's blocks: (1 or L, NMAT), each matrix row-major
        blocks = np.zeros((len(models), self._layout["nmat"]))
        for i, mm in enumerate(raw):
            for name, shape, off in self._layout["mats"]:
                n = int(np.prod(shape))
                blocks[i, off:off + n] = np.asarray(
                    mm[name], float).reshape(shape).ravel()
        self._blocks = torch.as_tensor(blocks, dtype=self.dtype,
                                       device=self.device)

        def T(name):
            if per_lane:
                return torch.as_tensor(np.stack([np.asarray(mm[name], float)
                                                 for mm in raw]),
                                       dtype=self.dtype, device=self.device)
            return torch.as_tensor(np.asarray(raw[0][name], float),
                                   dtype=self.dtype, device=self.device)

        for n in ("a", "b", "c", "x0", "dy", "ey", "fy", "y0"):
            setattr(self, n, T(n))
        self.subs = []
        self._solvers = []
        off = 0
        for k, (nn, np_, _) in enumerate(dims):
            sub = {n: T(f"{n}{k}") for n in ("dq", "eq", "fqprev", "fq",
                                              "pexp", "q0")}
            sub.update(off=off, nn=nn, np=np_)
            off += nn
            self.subs.append(sub)
            self._solvers.append(make_subsystem_solver_mats(
                m0.nl_funcs[k], nn, dtype=self.dtype, tol=self.tol,
                maxiter=self.newton_maxiter, homotopy=self.homotopy,
                max_homotopy_steps=self.max_homotopy_steps))

    # -- state --------------------------------------------------------------
    def _pack(self, state, dev):
        """The state as the kernel's (L, NS) rows on ``dev``."""
        x = state["x"]
        L = x.shape[0]
        parts = [x]
        for w in state["warms"]:
            parts += [w.p, w.z, w.dzdp.reshape(L, -1)]
        return torch.cat([p.to(dev, self.dtype) for p in parts],
                         dim=1).contiguous()

    def _unpack(self, s):
        L, o = s.shape[0], self.nx
        warms = []
        for sub, lay in zip(self.subs, self._layout["subs"]):
            warms.append(WarmStart(
                p=s[:, o + lay["s_p"]:o + lay["s_z"]],
                z=s[:, o + lay["s_z"]:o + lay["s_d"]],
                dzdp=s[:, o + lay["s_d"]:o + lay["s_d"]
                       + sub["nn"] * sub["np"]].reshape(L, sub["nn"],
                                                        sub["np"])))
        return {"x": s[:, :self.nx], "warms": tuple(warms)}

    # -- the plain step -----------------------------------------------------
    def _mats(self):
        """The matrices of the plain step: (the output and state rows,
        each subsystem's), shared or with a leading lane axis."""
        top = {n: getattr(self, n)
               for n in ("a", "b", "c", "x0", "dy", "ey", "fy", "y0")}
        subs = [{n: s[n] for n in ("dq", "eq", "fqprev", "fq", "pexp",
                                   "q0")} for s in self.subs]
        return top, subs

    def _plain_step(self, carry, u_t, mats):
        """One sample for every lane (engine.py:254-274) with torch ops."""
        top, subs = mats
        x = carry["x"]
        L = x.shape[0]
        z_acc = torch.zeros((L, self.nn_total), dtype=x.dtype,
                            device=x.device)
        warms_out = []
        conv = torch.ones((L,), dtype=torch.bool, device=x.device)
        iters_k = []
        for k, (sub, m) in enumerate(zip(self.subs, subs)):
            p = mv(m["dq"], x) + mv(m["eq"], u_t) + mv(m["fqprev"], z_acc)
            r = self._solvers[k](p, carry["warms"][k], m["fq"], m["pexp"],
                                 m["q0"])
            z_acc = z_acc.clone()
            z_acc[:, sub["off"]:sub["off"] + sub["nn"]] = r.z
            warms_out.append(r.warm)
            conv = conv & r.converged
            iters_k.append(r.iters)
        iters = (torch.stack(iters_k, dim=-1) if iters_k else
                 torch.zeros((L, 0), dtype=torch.int32, device=x.device))
        y = mv(top["dy"], x) + mv(top["ey"], u_t) + mv(top["fy"], z_acc) \
            + top["y0"]
        x_new = mv(top["a"], x) + mv(top["b"], u_t) + mv(top["c"], z_acc) \
            + top["x0"]
        return {"x": x_new, "warms": tuple(warms_out)}, (y, conv, iters)

    def _plain_scan(self, state, src, T, mats):
        L = state["x"].shape[0]
        carry = state
        ys, cs, its = [], [], []
        with torch.inference_mode():
            for t in range(T):
                u_t = src.at(t, L, self.nu, state["x"])
                carry, (y, c, it) = self._plain_step(carry, u_t, mats)
                ys.append(y)
                cs.append(c)
                its.append(it)
        dev = state["x"].device
        if T == 0:
            return carry, (torch.zeros((0, L, self.ny), dtype=self.dtype,
                                       device=dev),
                           torch.zeros((0, L), dtype=torch.bool, device=dev),
                           torch.zeros((0, L, self.nsub), dtype=torch.int32,
                                       device=dev))
        return carry, (torch.stack(ys), torch.stack(cs), torch.stack(its))

    # -- the kernel ---------------------------------------------------------
    def _library(self):
        if self._lib is None:
            from .ops.build import load_engine
            self._lib, self.lib_name = load_engine(self._header)
        return self._lib

    def op_counts(self):
        """(per lane-sample, per Newton iteration of each subsystem) float
        operations of the kernel (``emit.engine_op_counts``)."""
        return emit.engine_op_counts(self._dims, self._nls, self.nx,
                                     self.nu, self.ny)

    def launch_key(self):
        """The key of this engine's launches in ``LAUNCHES``."""
        self._library()
        return f"{self.lib_name}/{'f64' if self.dtype == torch.float64 else 'f32'}"

    def _call(self, lib, entry, s_in, src, T, L, blocks, *extra):
        """Allocate the outputs and call ``entry`` (the launch or its host
        twin) on the packed state ``s_in`` (L, NS)."""
        dev = s_in.device
        if s_in.dtype != self.dtype or tuple(s_in.shape) != (
                L, self._layout["ns"]) or not s_in.is_contiguous():
            raise ValueError(f"scan kernel state: expected a contiguous "
                             f"{self.dtype} ({L}, {self._layout['ns']}) "
                             f"tensor, got {s_in.dtype} {tuple(s_in.shape)}")
        for name, t in (("time rows", src.ut), ("lane series", src.ul),
                        ("lane constants", src.lv), ("models", blocks)):
            if t is not None and (t.device != dev or t.dtype != self.dtype):
                raise ValueError(f"scan kernel {name}: expected {self.dtype} "
                                 f"on {dev}, got {t.dtype} on {t.device}")
        if src.lv is not None and src.lv.shape[1] > 1 \
                and src.lv.stride(1) != 1:
            raise ValueError("scan kernel lane constants: rows must be "
                             "contiguous")
        y = torch.empty((T, L, max(self.ny, 1)), dtype=self.dtype, device=dev)
        conv = torch.empty((T, L), dtype=torch.bool, device=dev)
        iters = torch.empty((T, L, max(self.nsub, 1)), dtype=torch.int32,
                            device=dev)
        s_out = torch.empty_like(s_in)
        ptr = lambda t: ctypes.c_void_p(
            None if t is None or t.numel() == 0 else t.data_ptr())
        st = lambda t, i: 0 if t is None else t.stride(i)
        flat = [v for kind_j in src.umap for v in kind_j] or [0, 0]
        umap = (ctypes.c_int * len(flat))(*flat)
        stride = self._layout["nmat"] if blocks.shape[0] > 1 else 0
        rc = getattr(lib, entry)(
            ptr(blocks), stride, ptr(s_in), ptr(s_out),
            ptr(src.ut), st(src.ut, 0), st(src.ut, 1),
            ptr(src.ul), st(src.ul, 0), st(src.ul, 1), st(src.ul, 2),
            ptr(src.lv), st(src.lv, 0), umap,
            ptr(y), ptr(conv), ptr(iters), T, L, self.tol,
            self.newton_maxiter, int(self.homotopy),
            self.max_homotopy_steps, *extra)
        if rc != 0:
            what = lib.acme_scan_cuda_error(rc).decode() \
                if entry.startswith("acme_scan_launch") else "unknown"
            if rc == SMEM_TOO_LARGE:
                what += (f": {self.smem_bytes(lib, stride == 0)} bytes a "
                         "block")
            raise RuntimeError(f"scan kernel failed: error {rc} ({what})")
        return s_out, (y[:, :, :self.ny], conv, iters[:, :, :self.nsub])

    def smem_bytes(self, lib, shared_mats):
        """Dynamic shared memory of one block of the kernel: its lanes'
        carry, and the model block when every lane runs the one
        (``shared_mats``, a CompiledModel; per-lane blocks stay in device
        memory).  A launch whose need the card refuses raises."""
        return int(lib.acme_scan_smem_bytes(int(self.dtype == torch.float64),
                                            int(shared_mats)))

    def _kernel_scan(self, s_in, src, T, L, blocks):
        lib = self._library()
        r = "f64" if self.dtype == torch.float64 else "f32"
        dev = s_in.device
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev)
            timed = LAUNCH_EVENTS is not None
            if timed:
                ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
                ev[0].record(stream)
            out = self._call(lib, f"acme_scan_launch_{r}", s_in, src, T, L,
                             blocks, ctypes.c_int(dev.index),
                             ctypes.c_void_p(stream.cuda_stream))
            if timed:
                ev[1].record(stream)
                LAUNCH_EVENTS.append(tuple(ev))
        LAUNCHES[f"{self.lib_name}/{r}"] += 1
        return out

    def host_scan(self, lib, state, src, T):
        """The kernel's own run compiled for the host
        (``build.load_engine_host``), lane by lane on CPU tensors: the CPU
        tests' view of ``csrc/scan.cu``.  Returns (state, (y_tm, conv,
        iters)) as ``_scan``."""
        L = state["x"].shape[0]
        r = "f64" if self.dtype == torch.float64 else "f32"
        blocks = self._blocks.cpu()
        s_out, out = self._call(lib, f"acme_scan_host_{r}",
                                self._pack(state, "cpu"), src, T, L, blocks)
        return self._unpack(s_out), out

    def _scan(self, state, src, T):
        """The run of every lane over T samples from ``state``: (state,
        (y (T, L, ny), converged (T, L), iters (T, L, nsub))), by the kernel
        on the card and by the plain step on the CPU."""
        L = state["x"].shape[0]
        dev = state["x"].device
        if dev.type == "cuda":
            s_out, out = self._kernel_scan(self._pack(state, dev), src, T, L,
                                           self._blocks.to(dev))
            return self._unpack(s_out), out
        if dev.type == "cpu":
            return self._plain_scan(state, src, T, self._mats())
        raise ValueError(f"unsupported device {dev}")

    def _step(self, carry, u_t):
        """One sample (carry, u_t (L, nu)) -> (carry, (y, conv, iters)): on
        the card one launch of the kernel with T = 1, on the CPU the plain
        step."""
        u_t = torch.as_tensor(u_t, dtype=self.dtype, device=self.device)
        src = _Src(umap=tuple((2, i) for i in range(self.nu)),
                   ul=u_t[:, :, None])
        carry, (y, c, it) = self._scan(carry, src, 1)
        return carry, (y[0], c[0], it[0])

    def _as(self, v):
        return torch.as_tensor(v, dtype=self.dtype, device=self.device)


class CompiledModel(_Engine):
    """A DiscreteModel frozen to device tensors with the scan runtime.

    ``dtype`` defaults to float64 for reference parity (float32 runs the
    kernel's float32 build).  ``tol`` defaults to the reference's 1e-10 in
    float64 and 5e-4 in float32 (residuals in Ampere/Volt-scale units).
    ``device``: the card (the default; without one the constructor raises)
    runs the kernel, ``device="cpu"`` the plain version.
    """

    def __init__(self, model: DiscreteModel, *, dtype=None, tol=None,
                 newton_maxiter=500, homotopy=True, warn=True, device=None):
        self._setup(model, [model], dtype, tol, newton_maxiter, homotopy,
                    device, per_lane=False)
        self.warn = warn
        self.model = model          # kept for steady_initial_state
        D = self._as
        self._init_warm = []
        for k in range(self.nsub):
            p0, z0, dzdp = _origin_warm(model, k, True)
            self._init_warm.append(WarmStart(p=D(p0), z=D(z0), dzdp=D(dzdp)))

    # -- state ------------------------------------------------------------
    def initial_state(self, lanes: int = 1, x=None):
        """Scan carry for ``lanes`` independent circuit instances."""
        def tile(v):
            return v[None].repeat((lanes,) + (1,) * v.dim())

        if x is None:
            x = torch.zeros((lanes, self.nx), dtype=self.dtype,
                            device=self.device)
        else:
            x = self._as(x).broadcast_to((lanes, self.nx)).clone()
        warms = tuple(WarmStart(p=tile(w.p), z=tile(w.z), dzdp=tile(w.dzdp))
                      for w in self._init_warm)
        return {"x": x, "warms": warms}

    def steady_initial_state(self, lane_values=None, lane_input_idx=(),
                             runin: int = 4096):
        """Per-lane steady scan carry: every lane starts at the steady
        state of ITS OWN constant inputs, computed on the host by
        :func:`acme_tpu_torch.runtime.steadystate_sweep` (numpy; its ramp
        starts from the lanes' mean, so a lane's seed depends on its
        batch).  ``lane_values`` (L, len(lane_input_idx)) as passed to
        :meth:`run_sweep`; time-varying inputs are taken at 0.  With
        ``lane_values=None`` one lane at u = 0."""
        from .runtime import steadystate_sweep
        model = self.model
        if lane_values is None:
            u_lanes = np.zeros((1, model.nu))
        else:
            lane_values = np.asarray(lane_values, float)
            u_lanes = np.zeros((lane_values.shape[0], model.nu))
            u_lanes[:, list(lane_input_idx)] = lane_values
        L = u_lanes.shape[0]
        xs, zs, conv = steadystate_sweep(model, u_lanes, runin=runin)
        init_warm = [tuple(np.asarray(v.cpu(), float) for v in w)
                     for w in self._init_warm]
        if not conv.all():
            # uncertified lanes get the standard cold start (the JAX
            # package's reasons: engine.py:187-205)
            warnings.warn(f"steady_initial_state: {int((~conv).sum())}/{L} "
                          "lanes did not certify steady; they start COLD "
                          "and power up dynamically.")
            xs = np.where(conv[:, None], xs, 0.0)
            zs = np.where(conv[:, None],
                          zs, np.concatenate([np.asarray(z0, float)
                                              for z0 in model.init_zs])
                          [None, :]) if zs.size else zs
        D = self._as
        warms = []
        off = 0
        for k, sub in enumerate(self.subs):
            nn_k, np_k = sub["nn"], sub["np"]
            p_l = (xs @ np.asarray(model.dqs[k], float).T
                   + u_lanes @ np.asarray(model.eqs[k], float).T
                   + zs @ np.asarray(model.fqprevs[k], float).T)
            fq = np.asarray(model.fqs[k], float)
            pexp = np.asarray(model.pexps[k], float)
            q = (np.asarray(model.q0s[k], float)[:, None]
                 + pexp @ p_l.T + fq @ zs.T[off:off + nn_k])
            with np.errstate(all="ignore"):
                _, Jq = model.nl_funcs[k](np, q)   # (nn, nq, L)
                J = np.einsum("ijl,jk->lik", Jq, fq)
                Jp = np.einsum("ijl,jk->lik", Jq, pexp)
                d = -np.linalg.pinv(J) @ Jp if nn_k else \
                    np.zeros((L, 0, np_k))
            bad = ~np.isfinite(d).all(axis=(1, 2))
            if bad.any():
                d[bad] = init_warm[k][2]
            # a cond-spike steady point's sensitivity is zeroed: the first
            # convergent solve replaces it (engine.py:226-236)
            if nn_k:
                steep = np.abs(d).max(axis=(1, 2)) > 1e3
                d[steep] = 0.0
            if not conv.all():
                # cold lanes carry the engine's exact init origin
                p_l = np.where(conv[:, None], p_l, init_warm[k][0][None])
                d = np.where(conv[:, None, None], d, init_warm[k][2][None])
            warms.append(WarmStart(p=D(p_l), z=D(zs[:, off:off + nn_k]),
                                   dzdp=D(d)))
            off += nn_k
        return {"x": D(xs), "warms": tuple(warms)}

    def step_fn(self):
        """The single-step function (carry, u_t) -> (carry, (y, conv,
        iters)) with u_t of shape (L, nu): on the card one launch of the
        kernel with T = 1, on the CPU the plain step."""
        return self._step

    def _sweep_src(self, u_time, lane_values, lane_input_idx):
        lane_idx = tuple(int(i) for i in lane_input_idx)
        time_idx = tuple(i for i in range(self.nu) if i not in lane_idx)
        if u_time.shape[0] + len(lane_idx) != self.nu:
            raise ValueError("u_time rows + lane inputs must equal model "
                             "inputs")
        umap = [None] * self.nu
        for j, i in enumerate(time_idx):
            umap[i] = (0, j)
        for j, i in enumerate(lane_idx):
            umap[i] = (1, j)
        return _Src(umap=tuple(umap), ut=u_time,
                    lv=lane_values.contiguous())

    def run_sweep(self, u_time, lane_values, lane_input_idx, state=None):
        """Parameter-sweep run: ``u_time`` (nu_time, T) is shared across all
        lanes; ``lane_values`` (L, k) are per-lane constants fed into the
        circuit inputs listed in ``lane_input_idx`` (e.g. pot positions).
        The kernel assembles each lane's inputs itself, so the input stays
        O(T + L) instead of O(L nu T)."""
        u_time, lane_values = self._as(u_time), self._as(lane_values)
        L = lane_values.shape[0]
        src = self._sweep_src(u_time, lane_values, lane_input_idx)
        if state is None:
            state = self.initial_state(L)
        state, (y_tm, conv, iters) = self._scan(state, src, u_time.shape[1])
        return y_tm.permute(1, 2, 0), state, RunInfo(converged=conv,
                                                     iters=iters)

    def run(self, u, state=None):
        """Run the model.

        ``u``: (nu, T) for a single lane or (L, nu, T) for a batch of lanes
        (row order = circuit input order, as in the reference).  Returns
        (y, new_state, info) with y shaped like u's output counterpart
        ((L, ny, T), a transposed view of the kernel's time-major output).
        """
        u = self._as(u)
        single = u.dim() == 2
        if single:
            u = u[None]
        L, nu, T = u.shape
        if nu != self.nu:
            raise ValueError(f"input has {nu} rows, but model has {self.nu} "
                             "inputs")
        if state is None:
            state = self.initial_state(L)
        elif state["x"].shape[0] != L:
            raise ValueError(f"state has {state['x'].shape[0]} lanes, "
                             f"but input has {L}")
        src = _Src(umap=tuple((2, i) for i in range(nu)), ul=u)
        state, (y_tm, conv, iters) = self._scan(state, src, T)
        y = y_tm.permute(1, 2, 0)
        info = RunInfo(converged=conv, iters=iters)
        if self.warn:
            # two scalars from the device, not the whole output
            finite, all_conv = _finite_conv(y, conv)
            if not bool(finite):
                raise RuntimeError("Failed to converge while solving "
                                   "non-linear equation, got non-finite "
                                   "result.")
            if not bool(all_conv):
                warnings.warn("Failed to converge while solving non-linear "
                              "equation.")
        if single:
            y = y[0]
        return y, state, info


def compile_model(model: DiscreteModel, **kw) -> CompiledModel:
    """Freeze a DiscreteModel into the scan runtime."""
    return CompiledModel(model, **kw)


class BatchCompiledModel(_Engine):
    """Per-lane model matrices: lane i runs ``models[i]``, each a
    structurally identical model (the same circuit at other element
    values).  All models must share topology: identical dimensions and
    per-subsystem shapes; the element physics of ``models[0]`` serves every
    lane.  On the card the kernel reads lane i's matrices from the i-th of
    the per-lane blocks (the same build as a CompiledModel of the
    circuit)."""

    def __init__(self, models, *, dtype=None, tol=None, newton_maxiter=500,
                 homotopy=True, device=None):
        if not models:
            raise ValueError("need at least one model")
        m0 = models[0]
        for m in models[1:]:
            if (m.nx, m.nu, m.ny, m.nsubsystems) != \
                    (m0.nx, m0.nu, m0.ny, m0.nsubsystems) or any(
                    (m.nn(k), m.np(k)) != (m0.nn(k), m0.np(k))
                    for k in range(m0.nsubsystems)):
                raise ValueError(
                    "per-lane models must share dimensions/decomposition")
        self._setup(m0, models, dtype, tol, newton_maxiter, homotopy, device,
                    per_lane=True)
        self.L = len(models)
        warms = []
        for k in range(self.nsub):
            ps, zs, ds = zip(*[_origin_warm(m, k, False) for m in models])
            warms.append(WarmStart(p=self._as(np.stack(ps)),
                                   z=self._as(np.stack(zs)),
                                   dzdp=self._as(np.stack(ds))))
        self._init_warm = tuple(warms)

    def initial_state(self):
        return {"x": torch.zeros((self.L, self.nx), dtype=self.dtype,
                                 device=self.device),
                "warms": tuple(WarmStart(*(v.clone() for v in w))
                               for w in self._init_warm)}

    def run(self, u, state=None):
        """``u``: (nu, T) shared across lanes or (L, nu, T) per lane.
        Returns (y (L, ny, T), state, RunInfo)."""
        u = self._as(u)
        if u.dim() == 2:
            u = u[None].expand((self.L,) + tuple(u.shape))
        if u.shape[0] != self.L or u.shape[1] != self.nu:
            raise ValueError(f"input shape {tuple(u.shape)} does not match "
                             f"(L={self.L}, nu={self.nu}, T)")
        if state is None:
            state = self.initial_state()
        src = _Src(umap=tuple((2, i) for i in range(self.nu)), ul=u)
        state, (y_tm, conv, iters) = self._scan(state, src, u.shape[2])
        return y_tm.permute(1, 2, 0), state, RunInfo(converged=conv,
                                                     iters=iters)


def compile_models(models, **kw) -> BatchCompiledModel:
    """Freeze a batch of same-topology DiscreteModels into one runtime with
    per-lane model matrices (component-value sweeps)."""
    return BatchCompiledModel(models, **kw)
