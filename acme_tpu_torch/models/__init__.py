"""Bundled example circuits / model families.

The port's own copy of ``acme_tpu/models/__init__.py``: the same code and names, numpy
only; it imports nothing of ``acme_tpu``.

Ports of the reference's examples (ACME.jl/examples/*.jl), which
double as integration fixtures and benchmark workloads:

  * diodeclipper -- 2-diode RC clipper (1 nonlinear subsystem, np=1)
  * sallenkey    -- Sallen-Key lowpass with ideal opamp (fully linear)
  * birdie       -- "Der Birdie" treble booster: BJT + diode + pot
  * superover    -- "Der Super Over" overdrive: opamps, diode clipper,
                    drive/tone/level pots, decomposed nonlinearities

Each circuit function returns a Circuit; pass ``fs`` to the ``*_model``
helpers to get a compiled DiscreteModel.  Pots may be fixed (a number) or
None, in which case the pot position becomes an extra circuit input
(time-varying, and the natural lane-sweep axis).
"""

from __future__ import annotations

from fractions import Fraction

from ..circuit import Circuit
from ..elements import (bjt, capacitor, currentprobe, diode, opamp,
                        potentiometer, resistor, voltageprobe, voltagesource)
from ..model import DiscreteModel

__all__ = ["diodeclipper", "sallenkey", "birdie", "superover",
           "diodeclipper_model", "sallenkey_model", "birdie_model",
           "superover_model"]


def diodeclipper() -> Circuit:
    """Diode clipper (ref examples/diodeclipper.jl)."""
    c = Circuit()
    c.add("j_in", voltagesource())
    c.add("r1", resistor(1e3))
    c.add("c1", capacitor(47e-9))
    c.add("d1", diode(is_=1e-15))
    c.add("d2", diode(is_=1.8e-15))
    c.add("j_out", voltageprobe())
    c.connect(("j_in", "-"), "gnd")
    c.connect(("r1", "1"), ("j_in", "+"))
    c.connect(("c1", "1"), ("r1", "2"))
    c.connect(("c1", "2"), "gnd")
    c.connect(("d1", "-"), "gnd")
    c.connect(("d1", "+"), ("r1", "2"))
    c.connect(("d2", "-"), ("r1", "2"))
    c.connect(("d2", "+"), "gnd")
    c.connect(("j_out", "-"), "gnd")
    c.connect(("j_out", "+"), ("r1", "2"))
    return c


def sallenkey() -> Circuit:
    """Sallen-Key lowpass with ideal opamp (ref examples/sallenkey.jl)."""
    c = Circuit()
    c.add("j_in", voltagesource())
    c.add("r1", resistor(10e3))
    c.add("r2", resistor(10e3))
    c.add("c1", capacitor(10e-9))
    c.add("u1", opamp())
    c.add("c2", capacitor(10e-9))
    c.add("j_out", voltageprobe())
    c.connect(("j_in", "-"), "gnd")
    c.connect(("r1", "1"), ("j_in", "+"))
    c.connect(("r2", "1"), ("r1", "2"))
    c.connect(("c1", "1"), ("r1", "2"))
    c.connect(("u1", "in+"), ("r2", "2"))
    c.connect(("u1", "in-"), ("u1", "out+"), ("c1", "2"))
    c.connect(("u1", "out-"), "gnd")
    c.connect(("c2", "1"), ("u1", "in+"))
    c.connect(("c2", "2"), "gnd")
    c.connect(("j_out", "-"), "gnd")
    c.connect(("j_out", "+"), ("u1", "out+"))
    return c


def birdie(vol=None) -> Circuit:
    """'Der Birdie' treble booster (ref examples/birdie.jl)."""
    c = Circuit()
    c.add("j3", voltagesource(9))
    c.connect(("j3", "-"), "gnd")
    c.connect(("j3", "+"), "vcc")
    c.add("c5", capacitor(100e-6))
    c.connect(("c5", "1"), "gnd")
    c.connect(("c5", "2"), "vcc")
    c.add("d1", diode(is_=350e-12, eta=1.6))
    c.connect(("d1", "-"), "vcc")
    c.connect(("d1", "+"), "gnd")
    c.add("j1", voltagesource())
    c.connect(("j1", "-"), "gnd")
    c.add("r1", resistor(1e6))
    c.connect(("r1", "1"), ("j1", "+"))
    c.connect(("r1", "2"), "gnd")
    c.add("c1", capacitor(2.2e-9))
    c.connect(("c1", "1"), ("j1", "+"))
    c.add("r2", resistor(43e3))
    c.connect(("r2", "1"), ("c1", "2"))
    c.connect(("r2", "2"), "gnd")
    c.add("r3", resistor(430e3))
    c.connect(("r3", "1"), ("c1", "2"))
    c.connect(("r3", "2"), "vcc")
    c.add("t1", bjt("npn", isc=154.1e-15, ise=64.53e-15, etac=1.10, etae=1.06,
                    bf=500, br=12))
    c.connect(("t1", "base"), ("c1", "2"))
    c.add("r4", resistor(390))
    c.connect(("r4", "1"), ("t1", "emitter"))
    c.connect(("r4", "2"), "gnd")
    c.add("r5", resistor(10e3))
    c.connect(("r5", "1"), ("t1", "collector"))
    c.connect(("r5", "2"), "vcc")
    c.add("c3", capacitor(2.2e-9))
    c.connect(("c3", "1"), ("t1", "collector"))
    c.add("p1", potentiometer(100e3) if vol is None else potentiometer(100e3, vol))
    c.connect(("p1", "1"), "gnd")
    c.connect(("p1", "3"), ("c3", "2"))
    c.add("j2", voltageprobe())
    c.connect(("j2", "-"), "gnd")
    c.connect(("j2", "+"), ("p1", "2"))
    return c


def superover(drive=None, tone=None, level=None, sym: bool = False,
              vb_source: bool = False) -> Circuit:
    """'Der Super Over' overdrive (ref examples/superover.jl).

    ``vb_source=True`` adds a stiff 4.5 V source on the bias rail vb --
    the reference's "simplified" variant (test/runtests.jl:751-755).
    Electrically this pins the bias network; structurally it breaks the
    bias feedback loop so the nonlinearity decomposes into a chain of
    three small subsystems, np=(2,1,2) / nn=(2,3,2) instead of one
    np=5 / nn=7 block -- the fast configuration for the fused TPU kernel
    (three tiny eliminations and per-stage physics instead of a 7x7
    solve).  Note the reference's own steady-state check is broken for
    this variant (runtests.jl:763-764 @test_broken)."""
    c = Circuit()
    # power supply
    c.add("j3", voltagesource(9))
    c.connect(("j3", "+"), "vcc")
    c.connect(("j3", "-"), "gnd")
    c.add("d4", diode(is_=12e-9, eta=2))
    c.connect(("d4", "-"), "vcc")
    c.connect(("d4", "+"), "gnd")
    c.add("c11", capacitor(100e-6))
    c.connect(("c11", "1"), "vcc")
    c.connect(("c11", "2"), "gnd")
    c.add("r17", resistor(33e3))
    c.connect(("r17", "1"), "vcc")
    c.connect(("r17", "2"), "vb")
    c.add("r18", resistor(33e3))
    c.connect(("r18", "1"), "vb")
    c.connect(("r18", "2"), "gnd")
    c.add("c12", capacitor(47e-6))
    c.connect(("c12", "1"), "vb")
    c.connect(("c12", "2"), "gnd")
    # input stage
    c.add("j1", voltagesource())
    c.connect(("j1", "-"), "gnd")
    c.add("r1", resistor(2.2e6))
    c.connect(("r1", "1"), ("j1", "+"))
    c.connect(("r1", "2"), "gnd")
    c.add("c1", capacitor(47e-9))
    c.connect(("c1", "1"), ("j1", "+"))
    c.add("r2", resistor(10e3))
    c.connect(("r2", "1"), ("c1", "2"))
    c.add("r3", resistor(470e3))
    c.connect(("r3", "1"), ("r2", "2"))
    c.connect(("r3", "2"), "vb")
    c.add("q1", bjt("npn", is_=80e-15, bf=500, br=10))
    c.connect(("q1", "base"), ("r2", "2"))
    c.connect(("q1", "collector"), "vcc")
    c.add("r4", resistor(10e3))
    c.connect(("r4", "1"), ("q1", "emitter"))
    c.connect(("r4", "2"), "gnd")
    c.add("c2", capacitor(18e-9))
    c.connect(("c2", "1"), ("q1", "emitter"))
    c.add("r5", resistor(100e3))
    c.connect(("r5", "1"), ("c2", "2"))
    c.connect(("r5", "2"), "vb")
    # distortion stage
    c.add("ic1a", opamp())
    c.connect(("ic1a", "in+"), ("c2", "2"))
    c.connect(("ic1a", "out-"), "gnd")
    c.add("d1", diode(is_=4e-9, eta=2))
    c.connect(("d1", "-"), ("ic1a", "out+"))
    c.connect(("d1", "+"), ("ic1a", "in-"))
    c.add("d2", diode(is_=3e-9, eta=2))
    c.connect(("d2", "-"), ("ic1a", "in-"))
    c.add("d3", diode(is_=5e-9, eta=2))
    c.connect(("d3", "+"), ("ic1a", "out+"))
    c.connect(("d3", "-"), ("d2", "+"))
    c.add("p1", potentiometer(1e6) if drive is None else potentiometer(1e6, drive))
    c.connect(("p1", "2"), ("p1", "3"), ("ic1a", "out+"))
    c.add("r6", resistor(33e3))
    c.connect(("r6", "1"), ("ic1a", "in-"))
    c.connect(("r6", "2"), ("p1", "1"))
    c.add("c4", capacitor(47e-9))
    c.connect(("c4", "1"), ("ic1a", "in-"))
    c.add("r7", resistor(4.7e3))
    c.connect(("r7", "1"), ("c4", "2"))
    c.connect(("r7", "2"), "vb")
    # tone control stage
    c.add("r8", resistor(10e3))
    c.connect(("r8", "1"), ("ic1a", "out+"))
    c.add("ic1b", opamp())
    c.connect(("ic1b", "in+"), ("r8", "2"))
    c.connect(("ic1b", "out-"), "gnd")
    c.add("c5", capacitor(18e-9))
    c.connect(("c5", "1"), ("ic1b", "in+"))
    c.connect(("c5", "2"), "gnd")
    c.add("r10", resistor(10e3))
    c.connect(("r10", "1"), ("ic1b", "out+"))
    c.connect(("r10", "2"), ("ic1b", "in-"))
    c.add("c7", capacitor(10e-9))
    c.connect(("c7", "1"), ("ic1b", "out+"))
    c.connect(("c7", "2"), ("ic1b", "in-"))
    c.add("p2", potentiometer(20e3) if tone is None else potentiometer(20e3, tone))
    c.connect(("p2", "1"), ("ic1b", "in+"))
    c.connect(("p2", "3"), ("ic1b", "in-"))
    c.add("c6", capacitor(27e-9))
    c.connect(("c6", "1"), ("p2", "2"))
    c.add("r11", resistor(470))
    c.connect(("r11", "1"), ("c6", "2"))
    c.connect(("r11", "2"), "gnd")
    # output stage
    c.add("c8", capacitor(1e-3))
    c.connect(("c8", "1"), ("ic1b", "out+"))
    c.add("r12", resistor(4.7e3))
    c.connect(("r12", "1"), ("c8", "2"))
    c.add("p3", potentiometer(10e3) if level is None else potentiometer(10e3, level))
    c.connect(("p3", "1"), "vb")
    c.connect(("p3", "3"), ("r12", "2"))
    c.add("r20", resistor(22e3))
    c.connect(("r20", "1"), ("p3", "2"))
    c.add("c9", capacitor(47e-9))
    c.connect(("c9", "1"), ("r20", "2"))
    c.add("r13", resistor(1e6))
    c.connect(("r13", "1"), ("c9", "2"))
    c.connect(("r13", "2"), "vb")
    c.add("q2", bjt("npn", is_=80e-15, bf=500, br=10))
    c.connect(("q2", "base"), ("c9", "2"))
    c.connect(("q2", "collector"), "vcc")
    c.add("r14", resistor(10e3))
    c.connect(("r14", "1"), ("q2", "emitter"))
    c.connect(("r14", "2"), "gnd")
    c.add("r15", resistor(1e3))
    c.connect(("r15", "1"), ("q2", "emitter"))
    c.add("c10", capacitor(1e-6))
    c.connect(("c10", "1"), ("r15", "2"))
    c.add("r16", resistor(100e3))
    c.connect(("r16", "1"), ("c10", "2"))
    c.connect(("r16", "2"), "gnd")
    c.add("j2", voltageprobe())
    c.connect(("j2", "+"), ("c10", "2"))
    c.connect(("j2", "-"), "gnd")
    if sym:
        c.connect(("d3", "-"), ("d3", "+"))
    if vb_source:
        c.add("vbsrc", voltagesource(Fraction(9, 2)))
        c.connect(("vbsrc", "+"), "vb")
        c.connect(("vbsrc", "-"), "gnd")
    return c


def _model(circ, fs, **kw):
    return DiscreteModel(circ, Fraction(1, int(fs)), **kw)


def diodeclipper_model(fs=44100, **kw):
    return _model(diodeclipper(), fs, **kw)


def sallenkey_model(fs=44100, **kw):
    return _model(sallenkey(), fs, **kw)


def birdie_model(vol=None, fs=44100, **kw):
    return _model(birdie(vol=vol), fs, **kw)


def superover_model(drive=None, tone=None, level=None, sym=False,
                    vb_source=False, fs=44100, **kw):
    return _model(superover(drive=drive, tone=tone, level=level, sym=sym,
                            vb_source=vb_source), fs, **kw)
