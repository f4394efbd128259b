"""Traffic: the lane values and the audio stream of a cell, from its
traffic file and ``--seed``.

One general generator reads every traffic file (``traffic/<cell>.json``):

    lanes = lane_values(traffic["lanes"], seed)          # (L, k) float64
    stream = Stream(traffic["stream"], seed, fs)
    u = stream.block(0, 4096)                             # (4096,) volts

The lanes are a grid (one axis per lane value; the first axis varies
slowest), each lane drawn uniformly inside its own grid cell.  The
stream is a synthetic plucked-guitar DI signal shared by every lane: one
string, each note cutting the last, its harmonics at amplitude 1/k.  Each
second holds ``notes_per_s`` notes, their gaps (the exponential's
quantiles), decays, peaks and pitches stratified over their ranges, in
the same order for every seed; the seed draws the harmonics' phases.  So
every seed asks for nearly the same work (a window holds only a few
notes, and a pitch paired with another peak changes the Newton work by
several per cent), and a block depends only on the seed and its own
sample range.
"""

from __future__ import annotations

import numpy as np

__all__ = ["lane_values", "check_lanes", "Stream", "rng"]

# stream names for the seeded generators
_LANES, _CHECK, _NOTES = 1, 2, 3
# golden-ratio offsets: each second's strata start at another point
_PHI = 0.6180339887498949


def rng(seed, *key):
    """A generator for ``seed`` (any integer) and a stream ``key``."""
    return np.random.default_rng([int(seed) % (1 << 64), *key])


def lane_values(spec, seed):
    """(L, len(spec["axes"])) lane values: the grid of ``spec["axes"]``,
    each axis ``[lo, hi, n]`` cut into n cells, a lane's value uniform in
    its cell (``"jitter": false``: the cell's centre)."""
    axes = [(float(lo), float(hi), int(n)) for lo, hi, n in spec["axes"]]
    counts = [n for _, _, n in axes]
    L = int(np.prod(counts))
    idx = np.stack(np.unravel_index(np.arange(L), counts), axis=1)
    off = rng(seed, _LANES).random((L, len(axes))) \
        if spec.get("jitter", True) else np.full((L, len(axes)), 0.5)
    lo = np.array([a[0] for a in axes])
    width = np.array([(a[1] - a[0]) / a[2] for a in axes])
    return lo + (idx + off) * width


def check_lanes(L, n, seed):
    """The ``n`` lanes (sorted) whose outputs the reference checks."""
    return np.sort(rng(seed, _CHECK).choice(L, size=min(n, L),
                                            replace=False))


class Stream:
    """The shared input stream of ``spec`` at ``fs``."""

    def __init__(self, spec, seed, fs):
        self.seed = seed
        self.fs = float(fs)
        self.k = int(spec["notes_per_s"])
        self.midi = spec["midi"]
        self.decay = spec["decay_s"]
        self.peak = spec["peak_v"]
        self.harmonics = int(spec["harmonics"])
        self.fade = float(spec.get("fade_s", 0.002))
        self._seconds = {}

    def _second(self, g):
        """Onset (s), frequency, decay, peak and harmonic phases of the
        notes of second ``g``."""
        if g not in self._seconds:
            k = self.k
            fixed = rng(0, _NOTES, g)          # the same for every seed
            r = rng(self.seed, _NOTES, g)
            q = (np.arange(k) + (g * _PHI) % 1.0) / k     # strata, in [0, 1)
            # gaps: exponential quantiles, scaled to fill the second
            gaps = -np.log1p(-(np.arange(k) + 0.5) / k)
            gaps = fixed.permutation(gaps / gaps.sum())
            onsets = g + np.concatenate([[0.0], np.cumsum(gaps)[:-1]])
            decay = self.decay[0] + fixed.permutation(q) \
                * (self.decay[1] - self.decay[0])
            peak = self.peak[0] + fixed.permutation(q) \
                * (self.peak[1] - self.peak[0])
            midi = np.round(self.midi[0] + fixed.permutation(q)
                            * (self.midi[1] - self.midi[0]))
            freq = 440.0 * 2.0 ** ((midi - 69.0) / 12.0)
            phase = r.random((k, self.harmonics)) * 2.0 * np.pi
            self._seconds[g] = (onsets, freq, decay, peak, phase)
        return self._seconds[g]

    def block(self, n0, n):
        """Samples [n0, n0 + n) of the stream, float64 volts."""
        t = (n0 + np.arange(n)) / self.fs
        out = np.zeros(n)
        g0, g1 = int(t[0]) - 1, int(t[-1]) + 1
        notes = [self._second(g) for g in range(max(g0, 0), g1 + 1)]
        on = np.concatenate([x[0] for x in notes])
        ends = np.append(on[1:], np.inf)
        kh = np.arange(1, self.harmonics + 1)
        norm = 1.0 / np.sum(1.0 / kh)
        for j, (a, b) in enumerate(zip(on, ends)):
            if b <= t[0] or a > t[-1]:
                continue
            sel = (t >= a) & (t < b)
            tt = t[sel] - a
            src = notes[j // self.k]
            i = j % self.k
            f, tau, pk, ph = src[1][i], src[2][i], src[3][i], src[4][i]
            # each harmonic decays faster by sqrt(k); the note fades in
            # and, where the next one cuts it, out over ``fade``
            env = np.exp(-tt[:, None] * np.sqrt(kh)[None, :] / tau)
            wave = np.sin(2.0 * np.pi * f * kh[None, :] * tt[:, None]
                          + ph[None, :])
            x = (wave * env / kh[None, :]).sum(axis=1) * pk * norm
            x *= np.minimum(1.0, tt / self.fade)
            if np.isfinite(b):
                x *= np.minimum(1.0, (b - t[sel]) / self.fade)
            out[sel] += x
        return out
