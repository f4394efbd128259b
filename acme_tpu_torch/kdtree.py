"""k-d tree for nearest-neighbour solution caching (host side).

The port's own copy of ``acme_tpu/kdtree.py``: the same code and names, numpy
only; it imports nothing of ``acme_tpu``.

Counterpart of ACME.jl/src/kdtree.jl: cut dimension is the axis of
maximum variance, nearest-neighbour search is best-first with pruning and
supports seeding with an externally found candidate (the reference's
``Alts``-based search with ``init!``, kdtree.jl:93-100,189-234).  Unlike the
reference's implicit complete-binary-tree layout this uses an explicit array
representation; the search result contract (exact nearest neighbour) is the
same.  Only used by the host CachingSolver; the TPU runtime replaces the
cache with previous-sample warm starts (SURVEY.md section 7).
"""

from __future__ import annotations

import heapq

import numpy as np

__all__ = ["KDTree"]

_LEAF_SIZE = 8


class KDTree:
    def __init__(self, ps: np.ndarray):
        ps = np.asarray(ps, float)
        self.ps = ps
        n = ps.shape[1]
        # node arrays: split dim, split value, children (or leaf point range)
        self.dim = []
        self.val = []
        self.left = []
        self.right = []
        self.leaf_pts = []
        self.order = np.arange(n)
        if n > 0:
            self._build(0, n)

    def _new_node(self):
        self.dim.append(-1)
        self.val.append(0.0)
        self.left.append(-1)
        self.right.append(-1)
        self.leaf_pts.append(None)
        return len(self.dim) - 1

    def _build(self, lo: int, hi: int) -> int:
        node = self._new_node()
        if hi - lo <= _LEAF_SIZE:
            self.leaf_pts[node] = self.order[lo:hi].copy()
            return node
        pts = self.ps[:, self.order[lo:hi]]
        dim = int(np.argmax(np.var(pts, axis=1)))
        vals = pts[dim, :]
        mid = (hi - lo) // 2
        part = np.argpartition(vals, mid)
        self.order[lo:hi] = self.order[lo:hi][part]
        cut = 0.5 * (np.max(vals[part[:mid]]) + np.min(vals[part[mid:]]))
        self.dim[node] = dim
        self.val[node] = float(cut)
        left = self._build(lo, lo + mid)
        right = self._build(lo + mid, hi)
        self.left[node] = left
        self.right[node] = right
        return node

    def nearest(self, p: np.ndarray, best_dist: float = np.inf,
                best_idx: int = -1) -> int:
        """Index of the point nearest to p, or ``best_idx`` if nothing in the
        tree beats ``best_dist`` (squared distance)."""
        if self.ps.shape[1] == 0:
            return best_idx
        p = np.asarray(p, float)
        # heap entries carry per-dimension offsets to the candidate box, so
        # revisiting a dimension *replaces* its contribution (as in the
        # reference's Alts entries, kdtree.jl:158-175) rather than adding it.
        counter = 0
        heap = [(0.0, counter, 0, np.zeros_like(p))]
        while heap:
            bound, _, node, delta = heapq.heappop(heap)
            if bound >= best_dist:
                break
            while self.dim[node] >= 0:
                d = self.dim[node]
                off = p[d] - self.val[node]
                if off <= 0:
                    near, far = self.left[node], self.right[node]
                else:
                    near, far = self.right[node], self.left[node]
                far_bound = bound - delta[d] * delta[d] + off * off
                if far_bound < best_dist:
                    far_delta = delta.copy()
                    far_delta[d] = off
                    counter += 1
                    heapq.heappush(heap, (far_bound, counter, far, far_delta))
                node = near
            for idx in self.leaf_pts[node]:
                dist = float(np.sum((p - self.ps[:, idx]) ** 2))
                if dist < best_dist:
                    best_dist = dist
                    best_idx = int(idx)
        return best_idx
