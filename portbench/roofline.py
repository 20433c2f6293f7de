"""The yardstick of kernel K1's roofline share: the H100's published peaks
and the work a traversal segment needs, counted by the reference walk.

Peaks (NVIDIA's data sheet, H100 SXM, at its 700 W limit): 3.35 TB/s of
HBM3 and 67 TFLOP/s of float32 outside the tensor cores, integer and
compare operations counted at that rate too.  The card's power limit is
printed beside every share.

The least time of a segment is the larger of its bytes over the HBM rate
and its operations over the float32 rate:

* bytes: each ray's inputs and its record once (RAY_BYTES_IN for an
  explicit ray, nothing for a camera-mode primary, which the kernel
  derives from its id; RECORD_BYTES out), plus 4 B for each distinct
  32-bit word of the bit-packed brick, cell and voxel occupancy tables
  that the reference walk reads on the sampled rays.  The distinct words
  are not scaled up to the segment: a sample reads no more of them than
  the whole segment does, so the count is a lower bound.
* operations: the walk's coarse steps (one per empty 32^3 brick or 2^3
  cell crossed, one per occupied cell entered), scaled from the sample to
  the segment, times OPS_PER_STEP.

The count comes from the reference's walk, never from the system's
counters, so it reads the same work whatever implements K1.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 67e12
#: assumed: loop-body operations of one coarse step of a brick-and-cell
#: walk (arithmetic, compares, address math), as counted from K1's coarse
#: DDA step (csrc/wf_ray.cuh dda_cr)
OPS_PER_STEP = 40
RAY_BYTES_IN = 25      # origin and direction in float32, the alive byte
RECORD_BYTES = 20      # status, t, brick cell, voxel word, iterations


def least_ms(rays, camera, steps, words):
    """(least ms, "bytes" or "operations") of a segment of ``rays`` rays
    (``camera``: derived from their ids), ``steps`` coarse steps and
    ``words`` distinct table words."""
    nbytes = rays * ((0 if camera else RAY_BYTES_IN) + RECORD_BYTES) \
        + 4 * words
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = steps * OPS_PER_STEP / PEAK_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def frame_least_ms(segments, scale):
    """Least ms of a frame's K1 segments, each a walk count of sampled
    rays (``rays``, ``camera``, ``steps``, ``words``) that ``scale``
    (frame pixels over sampled pixels) takes to the whole segment."""
    total = 0.0
    for s in segments:
        ms, _ = least_ms(s["rays"] * scale, s["camera"], s["steps"] * scale,
                         s["words"])
        total += ms
    return total
