"""The voxels of bench.py's world (1024^3 perlin terrain in 512^3 chunks,
world offset (0, -512, 0)) that lie near a noise threshold, and the world
rebuilt with some of them flipped: the port's tools for tracing a
difference between its build and the JAX package's to single voxels.

    python scripts/bench_world_margins.py list OUT.npz [--tol T]
        every voxel whose surface (y * scale against cnoise, or against
        cnoise + worley F2) lies within T (default 5e-6: the port's
        cnoise and worley lie within 4e-6 and 1e-6 of jitted JAX's,
        tests/test_torch_noise.py) of its threshold, or whose simplex
        gate lies within GATE_TOL (snoise's 1e-6) of 0 where it decides
        the voxel: their generation coordinates (int16) and the port's
        voxels

    python scripts/bench_world_margins.py rebuild FLIPS.npz
        the world's n_nodes and n_mixed with the voxels at the
        coordinates ``xyz`` of FLIPS.npz flipped (solid <-> air)

Both run on the card (``--device cpu`` for a small rehearsal with
``--size``).  tests/test_torch_worldgen.py evaluates the JAX package's
noise at the listed voxels on the CPU.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from svo_raytracer_torch import bench  # noqa: E402
from svo_raytracer_torch.models import procgen, world  # noqa: E402
from svo_raytracer_torch.ops import brick_scene, noise  # noqa: E402

SCALE = 0.003
GATE_TOL = 1e-6


def chunks(size, chunk):
    """Generation origins of the world's chunks, in build order."""
    _, layout = world.chunk_layout(size, chunk)
    return [(o[0], o[1] - size // 2, o[2]) for o, _ in layout]


def margins(origin, chunk, dev, tol):
    """(xyz, voxel, surface margin, ridge margin, gate) of the chunk's
    voxels within ``tol`` of a threshold."""
    ax = torch.arange(chunk, dtype=torch.int32, device=dev)
    x = (ax + origin[0])[:, None, None].float()
    z = (ax + origin[2])[None, None, :].float()
    land = noise.cnoise(x * SCALE, z * SCALE)
    _, f2 = noise.worley(x * SCALE, z * SCALE, 1.0, False)
    vox = procgen.generate_chunk(origin, chunk, device=dev)
    out = []
    for a in range(0, chunk, procgen.SLAB):
        y = (ax[a:a + procgen.SLAB] + origin[1])[None, :, None].float()
        s = noise.snoise(x * SCALE * 0.5, y * SCALE * 0.5, z * SCALE * 0.5)
        ys = y * SCALE
        m_surf = (ys - land).expand_as(s)
        m_ridge = (ys - land - f2).expand_as(s)
        # the gate decides the voxel only between the two surfaces
        between = (m_surf > 0) & (m_ridge <= 0)
        near = ((m_surf.abs() <= tol) | (m_ridge.abs() <= tol)
                | (between & (s.abs() <= GATE_TOL)))
        i, j, k = torch.nonzero(near, as_tuple=True)
        out.append((torch.stack([i + origin[0], j + a + origin[1],
                                 k + origin[2]], 1).int().cpu(),
                    vox[i, j + a, k].cpu(), m_surf[near].cpu(),
                    m_ridge[near].cpu(), s[near].cpu()))
    return [torch.cat(c).numpy() for c in zip(*out)]


def list_near(size, chunk, dev, tol, path):
    parts = [margins(o, chunk, dev, tol) for o in chunks(size, chunk)]
    xyz, vox, m_surf, m_ridge, gate = (np.concatenate(c)
                                       for c in zip(*parts))
    np.savez_compressed(path, xyz=xyz.astype(np.int16), voxel=vox, tol=tol)
    print(f"{len(xyz)} voxels within {tol} of a threshold -> {path}: "
          f"{(np.abs(m_surf) <= tol).sum()} by the surface, "
          f"{(np.abs(m_ridge) <= tol).sum()} by the ridge, "
          f"{(np.abs(gate) <= GATE_TOL).sum()} by the gate")


def rebuild(size, chunk, dev, path):
    flips = np.load(path)["xyz"].astype(np.int64)

    def gen(origin):
        v = procgen.generate_chunk(origin, chunk, device=dev)
        rel = flips - np.asarray(origin)[None, :]
        inside = ((rel >= 0) & (rel < chunk)).all(1)
        if inside.any():
            i, j, k = (torch.from_numpy(rel[inside][:, n]).to(dev)
                       for n in range(3))
            v[i, j, k] = 1 - v[i, j, k]
        return v

    tree = world.build_world(size, chunk, gen,
                             world_offset=(0, -size // 2, 0))
    scene = brick_scene.brickify(tree.to_numpy())
    print(f"{len(flips)} voxels flipped: n_nodes {tree.n_nodes}, n_mixed "
          f"{scene.n_mixed}")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("what", choices=("list", "rebuild"))
    ap.add_argument("path")
    ap.add_argument("--tol", type=float, default=5e-6)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--size", type=int, default=bench.FULL[0])
    args = ap.parse_args()
    chunk = min(args.size, bench.FULL[1])
    dev = torch.device(args.device)
    if args.what == "list":
        list_near(args.size, chunk, dev, args.tol, args.path)
    else:
        rebuild(args.size, chunk, dev, args.path)


if __name__ == "__main__":
    main()
