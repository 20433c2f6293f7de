"""Correctly rounded float32 square roots, the same bits on the CPU and on
the card.

torch's multi-threaded float32 ``sqrt`` on the CPU is not always correctly
rounded: it has been one ulp off on about 0.6% of the rows of a call, and
in some processes approximate (up to ~3e-4 relative) on one thread's
share of them.  The card's ``sqrtf`` and the JAX package's roots are
correctly rounded.  A float32 value rooted in float64 and rounded back to
float32 is correctly rounded (53 >= 2 * 24 + 2 bits), on either device.
"""

from __future__ import annotations

import torch


def sqrt(x):
    """The correctly rounded float32 square root of float32 ``x``."""
    return torch.sqrt(x.double()).float()


def unit_rows(v):
    """(..., 3) rows divided by sqrt(x*x + y*y + z*z), the squares summed
    in float32 in that order and rooted with :func:`sqrt`."""
    x, y, z = v.unbind(-1)
    return v / sqrt(x * x + y * y + z * z).unsqueeze(-1)
