"""Octree integrity validation — failure detection the reference never had.

Port of svo_raytracer_tpu/core/validate.py.

The reference's only runaway guard is the 1500-iteration traversal cap
(svotrace.comp:41); corrupted trees render garbage silently.  This validator
catches structural corruption before it reaches a kernel: out-of-range child
pointers, child blocks overlapping other nodes, cycles (a child base pointing
at or above its parent in level order is impossible in our builders), and
branch nodes whose parent mask tags them as leaves but which still carry
children (legal only for edit-promoted subdividable leaves).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..utils import constants as C
from .octree import Octree, ROOT


@dataclasses.dataclass
class ValidationReport:
    ok: bool
    n_nodes: int
    reachable: int
    errors: list

    def __bool__(self):
        return self.ok


def validate_tree(tree: Octree, max_errors: int = 20) -> ValidationReport:
    t = tree.to_numpy()
    child = np.asarray(t.child[:t.n_nodes])
    mask = np.asarray(t.mask[:t.n_nodes])
    n = t.n_nodes
    errors = []

    def err(msg):
        if len(errors) < max_errors:
            errors.append(msg)

    # BFS from root; count reachability and check pointer sanity
    seen = np.zeros(n, bool)
    seen[ROOT] = True
    frontier = [ROOT]
    reachable = 1
    depth = 0
    while frontier and depth <= C.MAX_SCALE:
        nxt = []
        for p in frontier:
            base = int(child[p])
            if base == 0:
                continue
            if base < 8 or base + 8 > n:
                err(f"node {p}: child base {base} out of range [8,{n - 8}]")
                continue
            m = int(mask[p])
            for k in range(8):
                ci = base + k
                if seen[ci]:
                    err(f"node {ci} reached twice (parents share children)")
                    continue
                seen[ci] = True
                reachable += 1
                tag = (m >> (2 * k)) & 3
                if tag == C.TAG_BRANCH and child[ci] != 0:
                    nxt.append(ci)
        frontier = nxt
        depth += 1
    if frontier:
        err(f"tree deeper than MAX_SCALE={C.MAX_SCALE} — cycle suspected")

    return ValidationReport(ok=not errors, n_nodes=n, reachable=reachable,
                            errors=errors)
