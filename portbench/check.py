"""The comparison that decides ``correct``: the reference, run once the
window has closed and the system's state is freed, against what the
window produced, at the timed sizes.  Each kind of traffic
(``kinds/<kind>.py``) compares its own outputs through :class:`Reference`:
the reference world, pixels drawn from the seed, and the bad-pixel rule
(a colour channel more than ``colour`` or the depth more than
``depth_voxels`` voxels off).

Each reading is a (name, value, limit) triple; a value above its limit,
or not a number, is not correct.  The control (``control.py``) puts the
reference, computed in bfloat16, in the system's place.
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from .reference.world import World


class Reference:
    def __init__(self, cfg, seed, dev, log, counts=None):
        self.cfg, self.dev, self.log = cfg, dev, log
        self.rng = np.random.default_rng((seed % (1 << 63)) ^ 0x5EED)
        self.counts = counts
        t0 = time.perf_counter()
        self.world = World(cfg["world_size"], cfg["chunk_size"], dev)
        self.log(f"reference world {cfg['world_size']}^3 in "
                 f"{time.perf_counter() - t0:.3f} s")

    def pixels(self, n):
        W, H = self.cfg["width"], self.cfg["height"]
        k = min(n, W * H)
        flat = torch.from_numpy(self.rng.choice(W * H, k, replace=False))
        flat = flat.to(self.dev)
        return flat % W, flat // W

    def segments(self):
        """A list for one frame's walk counts (the roofline's work), kept
        when the run collects them, else None."""
        if self.counts is None:
            return None
        self.counts.append([])
        return self.counts[-1]

    def bad(self, col, depth, rcol, rdepth, tol, ok=None):
        """(bad pixels, largest colour gap, largest depth gap); NaN in the
        same channel of both sides is equal."""
        a, b = col.float(), rcol.float()
        cgap = torch.where(torch.isnan(a) & torch.isnan(b),
                           torch.zeros_like(a), (a - b).abs())
        cgap = cgap.nan_to_num(math.inf).amax(1)
        dgap = (depth.float() - rdepth.float()).abs().nan_to_num(math.inf)
        good = (cgap <= tol["colour"]) if ok is None else ok
        good = good & (dgap <= tol["depth_voxels"] / self.world.W)
        return int((~good).sum()), float(cgap.max()), float(dgap.max())


def verdict(numbers):
    """True when every reading is a number within its limit."""
    return all(v == v and v <= lim for _, v, lim in numbers)
