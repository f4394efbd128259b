"""Circuit graph: netlist of elements, nets, assembly of the global system.

The port's own copy of ``acme_tpu/circuit.py``: the same code and names, numpy
only; it imports nothing of ``acme_tpu``.

Mirrors ACME.jl/src/circuit.jl.  Elements are kept insertion-ordered
(branch offsets and the order of model inputs/outputs follow insertion order,
exactly as the reference documents in docs/src/ug.md:99-103).  The global
coefficient matrices are block-diagonal assemblies over exact rationals.

The ``@circuit`` macro DSL of the reference becomes :func:`parse_netlist`, a
small text DSL with the same semantics (element definitions plus connection
specs), and the programmatic API (:meth:`Circuit.add`, :meth:`Circuit.connect`,
...) which the macro expands to anyway.
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional, Tuple

import numpy as np

from . import elements as _element_lib
from .element import Element, NLFunc
from .exact import (blockdiag, consecranges, fzeros, gensolve, matsplit,
                    topomat as _topomat)

__all__ = ["Circuit", "parse_netlist", "composite_element", "topomat"]

Pin = Tuple[str, str]  # (designator, pin name)


class Circuit:
    """A netlist: insertion-ordered elements plus nets (groups of pins)."""

    def __init__(self):
        self.elements: Dict[str, Element] = {}
        self.nets: List[List[Pin]] = []
        self.net_names: Dict[str, List[Pin]] = {}
        self._gensym = 0

    # -- dimensions -------------------------------------------------------
    def _dimsum(self, attr: str) -> int:
        return sum(getattr(e, attr) for e in self.elements.values())

    @property
    def nb(self): return self._dimsum("nb")

    @property
    def nx(self): return self._dimsum("nx")

    @property
    def nq(self): return self._dimsum("nq")

    @property
    def nu(self): return self._dimsum("nu")

    @property
    def nl(self): return self._dimsum("nl")

    @property
    def ny(self): return self._dimsum("ny")

    @property
    def nn(self): return self._dimsum("nn")

    # -- global matrix assembly (ref circuit.jl:37-49) ---------------------
    def assemble(self, name: str) -> np.ndarray:
        mats = [e.mats[name] for e in self.elements.values()]
        if not mats:
            return fzeros(0, 0)
        return blockdiag(mats)

    def u0(self) -> np.ndarray:
        cols = [e.mats["u0"] for e in self.elements.values()]
        if not cols:
            return fzeros(0, 1)
        return np.vstack(cols)

    # -- graph manipulation -------------------------------------------------
    def add(self, designator_or_element, element: Optional[Element] = None) -> str:
        """Add an element; with one argument a unique designator is generated.

        Re-adding an existing designator replaces the old element
        (ref circuit.jl:94-117)."""
        if element is None:
            element = designator_or_element
            self._gensym += 1
            designator = f"#elem{self._gensym}"
        else:
            designator = str(designator_or_element)
        if not isinstance(element, Element):
            raise TypeError("expected an Element")
        if designator in self.elements:
            self.delete(designator)
        for pin in element.pins:
            self.nets.append([(designator, pin)])
        self.elements[designator] = element
        return designator

    def delete(self, designator: str):
        """Remove an element, disconnecting all its pins (ref circuit.jl:125-130)."""
        designator = str(designator)
        for net in self.nets:
            net[:] = [p for p in net if p[0] != designator]
        del self.elements[designator]

    def branch_offset(self, designator: str) -> int:
        off = 0
        for des, el in self.elements.items():
            if des == designator:
                return off
            off += el.nb
        raise KeyError(f"element {designator!r} not in circuit")

    def _netfor_pin(self, pin: Pin) -> List[Pin]:
        pin = (str(pin[0]), str(pin[1]))
        for net in self.nets:
            if pin in net:
                return net
        raise KeyError(f"Unknown pin {pin}")

    def netfor(self, p) -> List[Pin]:
        """Find (or create, for named nets) the net of a pin or net name
        (ref circuit.jl:141-152)."""
        if isinstance(p, tuple):
            return self._netfor_pin(p)
        name = str(p)
        if name not in self.net_names:
            net: List[Pin] = []
            self.nets.append(net)
            self.net_names[name] = net
        return self.net_names[name]

    def connect(self, *pins):
        """Connect pins ``(designator, pin)`` and/or named nets (str)
        (ref circuit.jl:175-188)."""
        nets = []
        for p in pins:
            net = self.netfor(p)
            if not any(net is n for n in nets):
                nets.append(net)
        for net in nets[1:]:
            nets[0].extend(net)
            idx = next(i for i, n in enumerate(self.nets) if n is net)
            del self.nets[idx]
            for name, named in list(self.net_names.items()):
                if named is net:
                    self.net_names[name] = nets[0]

    def disconnect(self, pin: Pin):
        """Disconnect one pin from its net, leaving the rest of the net intact
        (ref circuit.jl:190-206)."""
        pin = (str(pin[0]), str(pin[1]))
        net = self._netfor_pin(pin)
        net[:] = [p for p in net if p != pin]
        self.nets.append([pin])

    # -- incidence and topology (ref circuit.jl:51-66) ----------------------
    def incidence(self) -> np.ndarray:
        inc = np.zeros((len(self.nets), self.nb), dtype=int)
        for row, net in enumerate(self.nets):
            for (des, pinname) in net:
                off = self.branch_offset(des)
                for branch, polarity in self.elements[des].pins[pinname]:
                    inc[row, off + branch] += polarity
        return inc

    def topomat(self):
        return _topomat(self.incidence())

    # -- nonlinearity composition (ref circuit.jl:68-86) ---------------------
    def nonlinear_eq_func(self, elem_idxs=None) -> NLFunc:
        elems = list(self.elements.values())
        if elem_idxs is None:
            elem_idxs = range(len(elems))
        parts = []
        col_off = 0
        nn_total = 0
        nq_total = 0
        for i in elem_idxs:
            e = elems[i]
            if e.nn == 0 and e.nq == 0:
                col_off += e.nq
                continue
            parts.append((col_off, e.nq, e.nonlinear_eq))
            nn_total += e.nonlinear_eq.nn
            nq_total = col_off + e.nq
            col_off += e.nq

        def fn(xp, q):
            ress = []
            rows = []
            nq = q.shape[0]
            for off, enq, nl in parts:
                r, J = nl(xp, q[off:off + enq])
                ress.append(r)
                # embed the element Jacobian block at its column offset;
                # q may carry extra (lane) dimensions beyond (nn, nq), so
                # keep trailing dims intact; zero-width pads are skipped
                # (Mosaic rejects zero-sized vectors)
                pieces = []
                if off > 0:
                    pieces.append(xp.zeros(J.shape[:1] + (off,) + J.shape[2:],
                                           dtype=J.dtype))
                pieces.append(J)
                if nq - off - enq > 0:
                    pieces.append(xp.zeros(
                        J.shape[:1] + (nq - off - enq,) + J.shape[2:],
                        dtype=J.dtype))
                rows.append(xp.concatenate(pieces, axis=1)
                            if len(pieces) > 1 else J)
            if not ress:
                return (xp.zeros((0,) + tuple(q.shape[1:]), dtype=q.dtype),
                        xp.zeros((0, nq) + tuple(q.shape[1:]), dtype=q.dtype))
            return xp.concatenate(ress), xp.concatenate(rows, axis=0)

        return NLFunc(nn=nn_total, nq=nq_total, fn=fn)


def topomat(incidence):
    """Tree/cotree reduction; accepts an int incidence matrix."""
    return _topomat(np.asarray(incidence))


# ---------------------------------------------------------------------------
# composite elements (ref circuit.jl:408-494)


def composite_element(circ: Circuit, pinmap: Dict, ports=None) -> Element:
    """Compile a sub-circuit into a single Element.

    ``pinmap`` maps new-element pin names to pins/nets of ``circ``; ``ports``
    (pairs of pinmap keys) defaults to one port from the first pin to each
    other pin.  Internal voltages/currents are eliminated exactly via
    :func:`gensolve`; the composed nonlinearity is kept.
    """
    if circ.ny > 0:
        raise ValueError("creating composite elements from circuits with outputs is not supported")
    if ports is None:
        keys = list(pinmap.keys())
        ports = [(keys[0], k) for k in keys[1:]]
    numports = len(ports)
    nb, nx, nq, nu = circ.nb, circ.nx, circ.nq, circ.nu

    Mv = blockdiag([circ.assemble("mv"), fzeros(numports, numports)])
    Mi = blockdiag([circ.assemble("mi"), fzeros(numports, numports)])
    Mx = np.vstack([circ.assemble("mx"), fzeros(numports, nx)])
    Mxd = np.vstack([circ.assemble("mxd"), fzeros(numports, nx)])
    Mq = np.vstack([circ.assemble("mq"), fzeros(numports, nq)])
    Mu = np.vstack([circ.assemble("mu"), fzeros(numports, nu)])
    u0 = np.vstack([circ.u0(), fzeros(numports, 1)])

    incid = np.hstack([circ.incidence(), np.zeros((len(circ.nets), numports), dtype=int)])
    for i, port in enumerate(ports):
        b = nb + i
        net = circ.netfor(pinmap[port[0]])
        row = next(r for r, n in enumerate(circ.nets) if n is net)
        incid[row, b] = 1
        net = circ.netfor(pinmap[port[1]])
        row = next(r for r, n in enumerate(circ.nets) if n is net)
        incid[row, b] = -1

    tv, ti = _topomat(incid)
    S = np.vstack([
        np.hstack([Mv, Mi, Mx, Mxd, Mq]),
        np.hstack([blockdiag([tv, ti]), fzeros(nb + numports, 2 * nx + nq)]),
    ])
    rhs = np.vstack([np.hstack([Mu, u0]),
                     fzeros(nb + numports, nu + 1)])
    u_t, M = gensolve(S, rhs)
    # keep only the port-voltage / port-current rows (plus x, xd, q)
    rr = consecranges([nb, numports, nb, numports + 2 * nx + nq])
    indices = list(range(rr[1].start, rr[1].stop)) + list(range(rr[3].start, rr[3].stop))
    u_t = u_t[indices, :]
    M = M[indices, :]
    # rows of S_t span the left nullspace of M: S_t @ [v i x xd q]' = S_t @ u_t
    S_t = gensolve(M.T.copy(), np.empty((M.shape[1], 0), dtype=object))[1].T
    blocks = matsplit(S_t, [S_t.shape[0]], [numports, numports, nx, nx, nq])
    Mv_t, Mi_t, Mx_t, Mxd_t, Mq_t = (blocks[c][0] for c in range(5))
    Mu_t = np.dot(S_t, u_t[:, :nu])
    u0_t = np.dot(S_t, u_t[:, nu:nu + 1])
    return Element(mv=Mv_t, mi=-Mi_t, mx=Mx_t, mxd=Mxd_t, mq=Mq_t,
                   mu=Mu_t, u0=u0_t,
                   nonlinear_eq=circ.nonlinear_eq_func(),
                   ports=ports)


# ---------------------------------------------------------------------------
# text netlist DSL (the reference's @circuit macro, ref circuit.jl:317-406)

_CONN_SPLIT = re.compile(r"(?:⟷|↔|==|--)")
_PIN_RE = re.compile(r"^(?:(?P<des>[\w#]+)\s*)?\[(?P<pin>[^\]]+)\]$")


def parse_netlist(text: str, env: Optional[dict] = None) -> Circuit:
    """Build a Circuit from a textual netlist.

    Semantics mirror the reference's ``@circuit`` macro: lines are either
    element definitions ``refdes = elementfunc(args)`` optionally followed by
    comma-separated connection specs (where a bare ``[pin]`` refers to the
    element just defined), or standalone connection specs.  Connections chain
    endpoints with ``--`` (also accepted: ``==``, ``⟷``, ``↔``); an endpoint
    is ``refdes[pin]``, ``[pin]`` (current element) or a bare net name.

    Example::

        parse_netlist('''
            src = voltagesource(5), [-] -- gnd
            r   = resistor(1000),  [1] -- src[+], [2] -- gnd
        ''')

    Element expressions are evaluated with the element library in scope;
    ``env`` may supply extra names.
    """
    circ = Circuit()
    scope = {k: getattr(_element_lib, k) for k in _element_lib.__all__}
    scope["composite_element"] = composite_element
    if env:
        scope.update(env)
    seen = set()

    def endpoint(tok: str, default_des: Optional[str]):
        tok = tok.strip()
        m = _PIN_RE.match(tok)
        if m:
            des = m.group("des") or default_des
            if des is None:
                raise ValueError(f"missing element for pin spec {tok!r}")
            return (des, m.group("pin").strip().strip('"\''))
        if re.fullmatch(r'"[^"]*"|\'[^\']*\'', tok):
            return tok[1:-1]
        if re.fullmatch(r"[\w+\-.#]+", tok):
            return tok  # named net
        raise ValueError(f"invalid pin specification: {tok!r}")

    def do_conn(spec: str, default_des: Optional[str]):
        toks = [t for t in _CONN_SPLIT.split(spec) if t.strip()]
        if len(toks) < 2:
            raise ValueError(f"invalid connection specification: {spec!r}")
        circ.connect(*(endpoint(t, default_des) for t in toks))

    for raw in text.splitlines():
        line = raw.split("#", 1)[0].strip() if not raw.strip().startswith("#") else ""
        if not line:
            continue
        m = re.match(r"^(?P<des>\w+)\s*=\s*(?P<rest>.+)$", line)
        if m and not _CONN_SPLIT.search(m.group("des")):
            des, rest = m.group("des"), m.group("rest")
            # split top-level commas: element expr, then connection specs
            parts = _split_top_commas(rest)
            elem = eval(parts[0], {"__builtins__": {}}, scope)  # noqa: S307 - netlist DSL
            if des in seen:
                import warnings
                warnings.warn(f"redefinition of `{des}`")
            seen.add(des)
            circ.add(des, elem)
            for spec in parts[1:]:
                do_conn(spec, des)
        else:
            do_conn(line, None)
    return circ


def _split_top_commas(s: str) -> List[str]:
    parts = []
    depth = 0
    cur = []
    for ch in s:
        if ch in "([{":
            depth += 1
        elif ch in ")]}":
            depth -= 1
        if ch == "," and depth == 0:
            parts.append("".join(cur).strip())
            cur = []
        else:
            cur.append(ch)
    if cur:
        parts.append("".join(cur).strip())
    return [p for p in parts if p]
