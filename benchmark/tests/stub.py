"""A stand-in for the program, for the harness's CPU tests: the plain
reference itself behind ``Port``'s interface, with one fault planted on
request.

    bench(args, spec, cell, cfg, traffic, make_program=stub_factory(fault),
          device="cpu", workers=0)

Faults: ``"state_unchanged"`` (every call returns the state it was given,
so the next block starts where this one did), ``"half_lanes"`` (the
second half of the lanes is never computed: zeros), ``"altered"`` (one
output sample of every lane, in the middle of each block, off by 2 V),
``"nonfinite"`` (the first lane's output NaN there).
"""

import copy
from types import SimpleNamespace

import numpy as np
import torch

from reference import Reference


class StubProgram:
    def __init__(self, cfg, spans, device, fault=None):
        spans["model_build"] = 0.0
        spans["runner_prep"] = 0.0
        self.cfg = cfg
        self.fault = fault
        self.ref = None
        self.events = None

    def run(self, u, lanes, state):
        r = self.cfg["runner"]
        if self.ref is None:
            self.ref = Reference(
                self.cfg["netlist"], self.cfg["fs"], lanes,
                lane_input_idx=r.get("lane_input_idx", ()),
                lane_scale_idx=r.get("lane_scale_idx", ()))
        before = copy.deepcopy((self.ref.s, self.ref.v, self.ref.v_prev))
        L = lanes.shape[0]
        if self.fault == "half_lanes":
            keep = Reference(self.cfg["netlist"], self.cfg["fs"],
                             lanes[:L // 2],
                             lane_input_idx=r.get("lane_input_idx", ()),
                             lane_scale_idx=r.get("lane_scale_idx", ()))
            keep.s, keep.v, keep.v_prev = (a[:L // 2] for a in before)
            y = np.zeros((L, 1, u.shape[0]))
            y[:L // 2] = keep.run(u[None, :])
            self.ref.run(u[None, :])
            self.ref.s[:L // 2], self.ref.v[:L // 2] = keep.s, keep.v
        else:
            y = self.ref.run(u[None, :])
        if self.fault == "state_unchanged":
            self.ref.s, self.ref.v, self.ref.v_prev = before
        if self.fault == "altered":
            y[:, :, u.shape[0] // 2] += 2.0
        if self.fault == "nonfinite":
            y[0, :, u.shape[0] // 2] = np.nan
        info = SimpleNamespace(fails=torch.zeros(L, dtype=torch.int32),
                               iters=torch.ones((L, 1)))
        return torch.as_tensor(y, dtype=torch.float32), None, info

    def time_launches(self, on):
        self.events = [] if on else None

    def launches(self):
        return self.events


def stub_factory(fault=None):
    return lambda cfg, spans, device: StubProgram(cfg, spans, device, fault)
