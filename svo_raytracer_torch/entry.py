"""The entry point's analog (port of __graft_entry__.py's ``entry``): a
64^3 procedural-terrain octree and one mode-2 frame of it at 256x144
through shade.render_image (kernel KE on the card).

    python -m svo_raytracer_torch.entry          # on the card
    python -m svo_raytracer_torch.entry --cpu    # the plain versions

prints the frame's shape and dtype.  ``device=None`` means the card, and
without one it raises; the tests pass ``"cpu"``.  The multi-chip dry run
of the JAX module waits for the port's multi-GPU slice.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from .apps.viewer import check_device
from .core import build_np
from .ops import noise, shade
from .utils.camera import Camera

WIDTH, HEIGHT = 256, 144


def small_scene(size=64, device=None):
    """(DeviceOctree, cam5) of the entry's scene: the perlin terrain
    sampled every 2048 // size voxels of a 2048^3 world (y from -1024),
    built on the host, and the camera at (1.5, 1.62, 1.85) rotated by
    (-0.4, 0.3)."""
    dev = check_device("cuda" if device is None else device)
    ax = np.arange(size) * (2048 // size)
    x = torch.from_numpy(ax[:, None, None]).to(dev)
    y = torch.from_numpy((ax - 1024)[None, :, None]).to(dev)
    z = torch.from_numpy(ax[None, None, :]).to(dev)
    v = noise.sample_perlin_terrain(x, y, z).cpu().numpy()
    tree = build_np.build_octree_np(v).to_device(dev)
    cam = Camera(pos=np.array([1.5, 1.62, 1.85]))
    cam.rotate(-0.4, 0.3)
    cam5 = torch.tensor(cam.uniform(), dtype=torch.float32, device=dev)
    return tree, cam5


def entry(device=None):
    """(forward, (tree, cam5)): ``forward(tree, cam5)`` renders the
    entry's 256x144 mode-2 frame and returns its colour (144, 256, 3)."""
    tree, cam5 = small_scene(64, device)

    def forward(tree, cam5):
        color, _, _ = shade.render_image(tree, cam5, WIDTH, HEIGHT,
                                         render_mode=2)
        return color

    return forward, (tree, cam5)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the kernels' plain versions)")
    args = ap.parse_args(argv)
    fn, fargs = entry("cpu" if args.cpu else None)
    out = fn(*fargs)
    print("entry forward:", tuple(out.shape), out.dtype)
    return out


if __name__ == "__main__":
    main()
