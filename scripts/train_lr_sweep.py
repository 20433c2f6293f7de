"""Learning rates for the differentiable renderers' train steps on the
bench world (1024^3 perlin terrain, 1920x1080, the probe camera): for
each power of ten, 7 SGD steps of the wavefront K-hit step (K = 2) and
of the ESVO render_diff step from their initial tables toward 0.8 x the
untrained image, and whether the losses fell at every step.
chip_smoke.TRAIN_LR is chosen from this sweep.

    python scripts/train_lr_sweep.py      # on a GPU host, ~1 minute

Prints one line per kind and rate (its 7 losses), then the card's name
and power limit from nvidia-smi.  The losses do not depend on the card's
clocks.
"""

from __future__ import annotations

import os
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke  # noqa: E402
from svo_raytracer_torch import bench  # noqa: E402
from svo_raytracer_torch.diff import render_diff as rd  # noqa: E402
from svo_raytracer_torch.diff import wave_diff as wd  # noqa: E402
from svo_raytracer_torch.ops import shade, traverse  # noqa: E402

RATES = [10.0 ** e for e in range(4, 11)]
STEPS = 7


def main():
    if not torch.cuda.is_available():
        raise SystemExit("train_lr_sweep: needs a CUDA GPU")
    chip_smoke.build_kernels()
    dev = torch.device("cuda")
    size, chunk, W, H = bench.FULL
    tree, ws, cam5, _ = bench.setup(size, chunk, dev)
    packed = traverse.make_packed_table(tree)
    dirs = rd.d_unit(shade.pixel_dirs_device(cam5, W, H))
    p0 = wd.init_params(ws)
    target = 0.8 * wd.render_wave_diff(p0, ws, cam5[0].expand_as(dirs),
                                       dirs, 2).reshape(H, W, 3)
    v0 = rd.init_params(tree)
    etarget = 0.8 * rd.render_diff(v0, tree, cam5, W, H, packed=packed)
    for kind in ("wave", "esvo"):
        for lr in RATES:
            if kind == "wave":
                step = wd.make_wave_train_step(ws, W, H, K=2, lr=lr)
                p = p0
            else:
                p = v0
            losses = []
            for _ in range(STEPS):
                if kind == "wave":
                    p, loss = step(p, cam5, target)
                else:
                    p, loss = rd.train_step(p, tree, cam5, etarget, W, H,
                                            lr=lr, packed=packed)
                losses.append(float(loss))
            del p
            fell = (all(np.isfinite(losses)) and losses[-1] < losses[0]
                    and all(b <= a for a, b in zip(losses, losses[1:])))
            print(f"[sweep {kind}] lr {lr:g} fell {fell} losses {losses}",
                  flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())


if __name__ == "__main__":
    main()
