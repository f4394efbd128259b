"""The plain reference: a circuit given as a netlist, run sample by sample.

Modified nodal analysis of the netlist in a configuration file, every
capacitor discretised by the trapezoidal rule from zero charge, and the
nonlinear elements (diodes, bipolar transistors) solved by Newton's method
at every sample, in float64 numpy, vectorised over lanes.  It derives
everything itself from the netlist and the inputs; it imports nothing of
the program under test.

    ref = Reference(cfg["netlist"], cfg["fs"], lane_values,
                    lane_input_idx=(1, 2))
    y = ref.run(u_time)            # u_time (nu_t, T) -> y (L, ny, T)
    y = ref.run(u_next)            # the state carries from call to call

The linear network is reduced once per lane to the nonlinear elements'
port voltages v: at each sample v solves v = p + H i(v), where p is
linear in the inputs and the capacitor states.  ``rounding`` makes every
step of the per-sample arithmetic round to a narrower type (the control:
``round_bf16``); the float64 run leaves it None.
"""

from __future__ import annotations

import numpy as np

__all__ = ["Reference", "round_bf16", "VT"]

VT = 25e-3                 # thermal voltage of every junction
EXP_KNEE = 73.0            # exp is continued linearly above this argument
GAUX = 1e-4               # S, see Reference.__init__
STEP_CLIP = 0.5           # V, the largest Newton step


def round_bf16(a):
    """``a`` rounded to bfloat16 (nearest, ties to even), as float64."""
    f = np.asarray(a, np.float64).astype(np.float32)
    b = f.view(np.uint32).astype(np.uint64)
    b = (b + 0x7FFF + ((b >> 16) & 1)) & 0xFFFF0000
    return b.astype(np.uint32).view(np.float32).astype(np.float64)


class _Nets:
    def __init__(self):
        self.index = {}

    def __call__(self, name):
        if name == "gnd":
            return -1
        return self.index.setdefault(name, len(self.index))


def _stamp(M, a, b, val):
    """Add ``val`` between nets a and b (-1 is ground) of the conductance
    block of M (..., n, n)."""
    if a >= 0:
        M[..., a, a] += val
    if b >= 0:
        M[..., b, b] += val
    if a >= 0 and b >= 0:
        M[..., a, b] -= val
        M[..., b, a] -= val


def _incidence(n, a, b):
    row = np.zeros(n)
    if a >= 0:
        row[a] += 1.0
    if b >= 0:
        row[b] -= 1.0
    return row


class Reference:
    """The netlist's circuit at sample rate ``fs`` for ``L`` lanes.

    ``lane_values`` (L, k): the constants of the inputs ``lane_input_idx``,
    then the scales of the inputs ``lane_scale_idx``, which multiply the
    shared time rows; every other input is a time row of ``u_time``.  An
    input that sets a potentiometer's position has to be a lane constant.
    Newton's method stops at each sample once a step moves no port
    voltage by more than ``tol`` volts (the error left is then of the
    order of its square over the thermal voltage), its steps clipped to
    ``STEP_CLIP`` volts, at most ``max_iter`` of them, from the line
    through the last two samples' solutions.
    """

    def __init__(self, netlist, fs, lane_values, lane_input_idx=(),
                 lane_scale_idx=(), rounding=None, tol=1e-6,
                 max_iter=200):
        lv = np.atleast_2d(np.asarray(lane_values, np.float64))
        self.L = lv.shape[0]
        self.lane_input_idx = tuple(int(i) for i in lane_input_idx)
        self.lane_scale_idx = tuple(int(i) for i in lane_scale_idx)
        k0 = len(self.lane_input_idx)
        const = {i: lv[:, j] for j, i in enumerate(self.lane_input_idx)}
        self.scale = {i: lv[:, k0 + j]
                      for j, i in enumerate(self.lane_scale_idx)}
        self.rd = rounding or (lambda a: a)
        self.tol, self.max_iter = tol, max_iter
        T = 1.0 / float(fs)
        L = self.L
        nets = _Nets()
        for e in netlist:
            for p in e["pins"].values():
                nets(p)
        n = len(nets.index)
        # branch currents: voltage sources, opamp outputs, zero resistors
        branches = []      # (a, b, kind, value): v_a - v_b = value
        resistors = []     # (a, b, conductance (L,))
        caps = []          # (a, b, C)
        ports = []         # nonlinear ports: (a, b)
        prims = []         # per port: (K, 1/(eta VT))
        mix = []           # per element: (port offset, mixing matrix)
        outputs = []
        self.nu = 0
        for e in netlist:
            pin = {k: nets(v) for k, v in e["pins"].items()}
            kind = e["kind"]
            if "input" in e:
                self.nu = max(self.nu, int(e["input"]) + 1)
            if kind == "resistor":
                resistors.append((pin["1"], pin["2"], float(e["r"])))
            elif kind == "potentiometer":
                pos = e["pos"]
                if isinstance(pos, dict):
                    i = int(pos["input"])
                    self.nu = max(self.nu, i + 1)
                    if i not in const:
                        raise ValueError(f"{e['name']}: the input that sets "
                                         "its position is not a lane constant")
                    pos = const[i]
                pos = np.broadcast_to(np.asarray(pos, np.float64), (L,))
                r = float(e["r"])
                resistors.append((pin["1"], pin["2"], r * pos))
                resistors.append((pin["2"], pin["3"], r * (1.0 - pos)))
            elif kind == "capacitor":
                caps.append((pin["1"], pin["2"], float(e["c"])))
            elif kind == "voltagesource":
                val = ("u", int(e["input"])) if "input" in e \
                    else ("c", float(e["v"]))
                branches.append((pin["+"], pin["-"], "v", val))
            elif kind == "opamp":
                branches.append((pin["out+"], pin["out-"], "nullor",
                                 (pin["in+"], pin["in-"])))
            elif kind == "voltageprobe":
                outputs.append((int(e["output"]), pin["+"], pin["-"]))
            elif kind == "diode":
                mix.append((len(ports), np.eye(1)))
                ports.append((pin["+"], pin["-"]))
                prims.append((float(e["is"]), 1.0 / (VT * float(e["eta"]))))
            elif kind == "bjt":
                if e.get("type", "npn") != "npn":
                    raise ValueError("only npn transistors")
                bf, br, is_ = float(e["bf"]), float(e["br"]), float(e["is"])
                # ports (base, emitter), (base, collector); primitives
                # i_f = af is (exp(vbe/VT) - 1), i_r = ar is (exp(vbc/VT) - 1)
                mix.append((len(ports), np.array([[1.0 + 1.0 / bf, -1.0],
                                                  [-1.0, 1.0 + 1.0 / br]])))
                ports.append((pin["base"], pin["emitter"]))
                ports.append((pin["base"], pin["collector"]))
                prims.append((bf / (1.0 + bf) * is_, 1.0 / VT))
                prims.append((br / (1.0 + br) * is_, 1.0 / VT))
            else:
                raise ValueError(f"unknown element kind {kind!r}")
        # a resistor of zero ohms is a branch of zero volts, or nothing
        # where both ends are one net
        res = []
        for a, b, r in resistors:
            r = np.broadcast_to(np.asarray(r, np.float64), (L,))
            if a == b:
                continue
            if np.all(r == 0.0):
                branches.append((a, b, "v", ("c", 0.0)))
            elif np.any(r == 0.0):
                raise ValueError("a lane sets a resistance to zero")
            else:
                res.append((a, b, 1.0 / r))
        m = len(branches)
        N = n + m
        G = np.zeros((L, N, N))
        for a, b, g in res:
            _stamp(G, a, b, g)
        ncap = len(caps)
        Bs = np.zeros((N, ncap))      # rhs per unit of capacitor state
        capC = np.zeros(ncap)
        Nc = np.zeros((ncap, N))
        for k, (a, b, C) in enumerate(caps):
            _stamp(G, a, b, 2.0 * C / T)
            if a >= 0:
                Bs[a, k] += 2.0 / T
            if b >= 0:
                Bs[b, k] -= 2.0 / T
            capC[k] = C
            Nc[k] = _incidence(N, a, b)
        b0 = np.zeros(N)
        Bu = np.zeros((N, max(self.nu, 1)))
        for j, (a, b, kind, val) in enumerate(branches):
            row = n + j
            # the branch current leaves a, enters b
            if a >= 0:
                G[:, a, row] += 1.0
            if b >= 0:
                G[:, b, row] -= 1.0
            if kind == "v":
                if a >= 0:
                    G[:, row, a] += 1.0
                if b >= 0:
                    G[:, row, b] -= 1.0
                if val[0] == "c":
                    b0[row] = val[1]
                else:
                    Bu[row, val[1]] = 1.0
            else:                      # ideal opamp: v(in+) = v(in-)
                ip, im = val
                if ip >= 0:
                    G[:, row, ip] += 1.0
                if im >= 0:
                    G[:, row, im] -= 1.0
        npt = len(ports)
        Np = np.stack([_incidence(N, a, b) for a, b in ports]) \
            if npt else np.zeros((0, N))
        # a node reached only through nonlinear elements (d2-d3) would leave
        # G singular: each port at such a node gets a conductance GAUX in
        # G, and the element's current less GAUX v in the nonlinear part,
        # so the sum is the element's own current
        linked = np.zeros(N, bool)
        linked[np.nonzero(np.abs(G).sum(axis=(0, 1)))[0]] = True
        aux = np.array([(a >= 0 and not linked[a]) or (b >= 0 and not linked[b])
                        for a, b in ports], float) * GAUX
        for (a, b), ga in zip(ports, aux):
            _stamp(G, a, b, ga)
        ny = max([o[0] for o in outputs], default=-1) + 1
        Ny = np.zeros((ny, N))
        for o, a, b in outputs:
            Ny[o] = _incidence(N, a, b)
        M = np.zeros((npt, npt))
        for off, mm in mix:
            k = mm.shape[0]
            M[off:off + k, off:off + k] = mm
        Ginv = np.linalg.inv(G)                       # (L, N, N)
        # X = Ginv (b0 + Bu u + Bs s - Np^T w), w = M g(v) - aux v; every
        # quantity read from X is a row operator R applied to it: R X =
        # R0 + RZ (u, s) - RW w
        Bz = np.concatenate([Bu, Bs], axis=1)
        Rows = np.concatenate([Np, Nc, Ny])
        RG = Rows @ Ginv
        R0, RZ, RW = RG @ b0, RG @ Bz, RG @ Np.T
        k1, k2 = npt, npt + ncap
        self.p0, self.pz, H = R0[:, :k1], RZ[:, :k1], RW[:, :k1]
        self.o0, self.oz, self.ow = R0[:, k1:], RZ[:, k1:], RW[:, k1:]
        self.H, self.HM = H, H @ M
        self.A = np.eye(npt) - H * aux[None, None, :]
        self.aux = aux
        self.M = M
        self.capC = capC
        self.K = np.array([k for k, _ in prims])
        self.c = np.array([c for _, c in prims])
        self.Kc = self.K * self.c
        self.ny, self.npt, self.ncap = ny, npt, ncap
        if rounding is not None:
            for key in ("p0", "pz", "H", "HM", "A", "aux", "o0", "oz", "ow",
                        "capC", "K", "c", "Kc"):
                setattr(self, key, self.rd(getattr(self, key)))
        self.s = np.zeros((L, ncap))                  # zero charge
        self.v = np.zeros((L, npt))
        self.v_prev = self.v
        self.iterations = 0
        self.unconverged = 0

    def _currents(self, v):
        """(w, dg/dv) at port voltages v (L, npt): w is the nonlinear part
        of the port currents, M g(v) - aux v, and g the primitives
        K (exp(c v) - 1), exp continued linearly above EXP_KNEE."""
        rd = self.rd
        arg = rd(v * self.c)
        e = rd(np.exp(np.minimum(arg, EXP_KNEE)))
        ev = rd(e * (1.0 + np.maximum(arg - EXP_KNEE, 0.0)))
        g = rd(self.K * (ev - 1.0))
        w = rd(rd(g @ self.M.T) - rd(self.aux * v))
        return w, rd(self.Kc * e)

    def run(self, u_time):
        """Run ``u_time`` (nu_t, T); returns y (L, ny, T) float64 and
        carries the state to the next call."""
        u_time = np.atleast_2d(np.asarray(u_time, np.float64))
        T = u_time.shape[1]
        rd = self.rd
        L = self.L
        # the lane-constant inputs set only the potentiometers, which the
        # lanes' matrices hold; the rest are time rows
        time_idx = [i for i in range(self.nu) if i not in self.lane_input_idx]
        U = np.zeros((L, max(self.nu, 1), T))
        for t_row, i in enumerate(time_idx):
            sc = np.broadcast_to(self.scale.get(i, 1.0), (L,))
            U[:, i, :] = rd(u_time[t_row][None, :] * sc[:, None])
        y = np.empty((L, self.ny, T))
        s, v, v1 = self.s, self.v, self.v_prev
        H, HM, A = self.H, self.HM, self.A
        tol = self.tol
        for t in range(T):
            z = np.concatenate([U[:, :, t], s], axis=1)[..., None]
            p = rd(self.p0 + rd((self.pz @ z)[..., 0]))
            # Newton's method on v = p - H w(v), from the line through the
            # last two solutions
            v, v1 = rd(2.0 * v - v1), v
            for _ in range(self.max_iter):
                w, gd = self._currents(v)
                r = rd(rd(v - p) + rd((H @ w[..., None])[..., 0]))
                J = rd(A + rd(HM * gd[:, None, :]))
                try:
                    dv = np.linalg.solve(J, r[..., None])[..., 0]
                except np.linalg.LinAlgError:   # a rounded J can be singular
                    dv = (np.linalg.pinv(J) @ r[..., None])[..., 0]
                dv = rd(dv)
                dv = np.minimum(np.maximum(dv, -STEP_CLIP), STEP_CLIP)
                v = rd(v - dv)
                self.iterations += 1
                if np.abs(dv).max() <= tol:
                    break
            else:
                self.unconverged += 1
            w, _ = self._currents(v)
            out = rd(self.o0 + rd((self.oz @ z)[..., 0])
                     - rd((self.ow @ w[..., None])[..., 0]))
            y[:, :, t] = out[:, self.ncap:]
            s = rd(rd(2.0 * self.capC * out[:, :self.ncap]) - s)
        self.s, self.v, self.v_prev = s, v, v1
        return y
