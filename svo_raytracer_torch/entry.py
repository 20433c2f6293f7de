"""The entry point's analog (port of __graft_entry__.py): ``entry``, a
64^3 procedural-terrain octree and one mode-2 frame of it at 256x144
through shade.render_image (kernel KE on the card), and
``dryrun_multichip``, the sharded paths on tiny shapes in a process
group.

    python -m svo_raytracer_torch.entry          # on the card
    python -m svo_raytracer_torch.entry --cpu    # the plain versions
    python -m svo_raytracer_torch.entry --multichip N [--cpu]
                                 [--backend nccl|gloo]

The first two print the frame's shape and dtype.  ``--multichip N``
spawns N ranks (a FileStore rendezvous in a temporary directory, no
port) that run dryrun_multichip: on the CPU over gloo, on cards over
nccl (one card per rank) unless ``--backend gloo`` puts every rank on
card 0.  ``device=None`` means the card, and without one it raises; the
tests pass ``"cpu"``.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch
import torch.distributed as dist

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


def dryrun_multichip(n_devices: int, device_type: str = "cuda") -> None:
    """The sharded paths on tiny shapes, inside an initialised group of
    ``n_devices`` ranks (each on its device: the current card, or the
    CPU), in the JAX package's order: the tiles mesh's ESVO train step
    and mode-2 render; a (tiles, bricks) grid mesh's brick render (mode
    3) and brick train step; the wavefront tile render (mode 3, n_left
    0); the sharded K-hit train step (K = 2) with non-zero updates.
    Rank 0 prints the JAX package's lines."""
    from .diff import render_diff as rd
    from .diff import wave_diff as wdm
    from .ops import brick_scene, wavefront
    from .parallel import bricks as B
    from .parallel import mesh as mesh_mod
    from .parallel import render_sharded
    from .parallel import render_wave_sharded as rws

    if dist.get_world_size() != n_devices:
        raise ValueError(f"need a group of {n_devices} ranks, have "
                         f"{dist.get_world_size()}")
    m = mesh_mod.tile_mesh(n_devices, device_type)
    tree, cam5 = small_scene(32, m.device)
    say = print if dist.get_rank() == 0 else (lambda *a: None)
    W, H = 32, 8 * n_devices

    params = rd.init_params(tree)
    target = rd.render_diff(params, tree, cam5, W, H) * 0.8
    step = render_sharded.make_sharded_train_step(m, W, H, lr=1.0)
    _, loss = step(params, tree, cam5, target)
    loss = float(loss)
    if not np.isfinite(loss):
        raise AssertionError(f"training step produced non-finite loss {loss}")
    render = render_sharded.make_sharded_render(m, W, H, render_mode=2)
    img = render(tree, cam5)
    _check_image(img, (H, W, 3))
    say(f"dryrun_multichip({n_devices}): tiles mesh loss={loss:.6f}, "
        f"render {tuple(img.shape)} ok")

    # ---- 2-D (tiles x bricks) mesh: brick-sharded render + train step
    n_bricks = 1
    for cand in (4, 2):
        if n_devices % cand == 0:
            n_bricks = cand
            break
    n_tiles2 = n_devices // n_bricks
    m2 = mesh_mod.grid_mesh(n_tiles2, n_bricks, device_type)
    bs = B.split_bricks(tree, level=1)
    dbs = bs.to_device(m2.device, m2)
    H2 = 8 * max(n_tiles2, 1)
    img2 = B.make_brick_render(m2, bs, W, H2, render_mode=3)(dbs, cam5)
    _check_image(img2, (H2, W, 3))
    step2 = B.make_brick_train_step(m2, bs, W, H2, lr=1.0)
    _, loss2 = step2(rd.init_params(tree), dbs, cam5,
                     torch.zeros((H2, W, 3), device=m2.device))
    loss2 = float(loss2)
    if not np.isfinite(loss2):
        raise AssertionError(f"brick train step loss {loss2}")
    say(f"dryrun_multichip({n_devices}): grid mesh ({n_tiles2}x{n_bricks})"
        f" render {tuple(img2.shape)} ok, train loss={loss2:.6f}")

    # ---- the wavefront engine sharded over ray tiles
    ws = wavefront.prepare(brick_scene.brickify(tree.to_numpy()), m.device)
    W3, H3 = 32, 8 * n_devices
    render3 = rws.make_wave_sharded_render(m, ws, W3, H3, render_mode=3)
    img3, n_left = render3(ws, cam5, 1)
    _check_image(img3, (H3, W3, 3))
    if n_left != 0:
        raise AssertionError(f"{n_left} rays retired at ITER_CAP")
    say(f"dryrun_multichip({n_devices}): wavefront tiles mesh render "
        f"{tuple(img3.shape)} ok (n_left=0)")

    # ---- training through the wavefront engine: sharded K-hit chain
    params_w = wdm.init_params(ws)
    step_w = wdm.make_wave_sharded_train_step(m, ws, W3, H3, K=2, lr=1.0)
    params_w2, loss_w = step_w(params_w, cam5,
                               torch.zeros((H3, W3, 3), device=m.device))
    loss_w = float(loss_w)
    if not np.isfinite(loss_w):
        raise AssertionError(f"wavefront train step loss {loss_w}")
    if not any(bool((a != b).any()) for a, b in zip(params_w2, params_w)):
        raise AssertionError("wavefront grads must be nonzero")
    say(f"dryrun_multichip({n_devices}): wavefront k-hit train step "
        f"loss={loss_w:.6f} ok")


def _check_image(img, shape):
    if tuple(img.shape) != shape or not bool(torch.isfinite(img).all()):
        raise AssertionError(f"image {tuple(img.shape)}, expected {shape} "
                             f"and finite")


def launch_multichip(n: int, cpu: bool, backend: str | None = None) -> None:
    """Spawn ``n`` ranks running dryrun_multichip; any rank's exception
    fails the launch.  ``backend`` defaults to gloo on the CPU and nccl
    on cards (one card per rank: more ranks than cards raise)."""
    device_type = "cpu" if cpu else "cuda"
    backend = backend or ("gloo" if cpu else "nccl")
    if not cpu:
        check_device("cuda")
        if backend == "nccl" and n > torch.cuda.device_count():
            raise ValueError(f"nccl takes one card per rank: {n} ranks, "
                             f"{torch.cuda.device_count()} cards (pass "
                             f"--backend gloo to share one)")
    elif backend != "gloo":
        raise ValueError(f"CPU ranks run over gloo, not {backend}")
    from .parallel import distributed
    distributed.spawn(dryrun_multichip, n, backend, device_type,
                      (n, device_type))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the kernels' plain versions)")
    ap.add_argument("--multichip", type=int, metavar="N",
                    help="spawn N ranks and run dryrun_multichip")
    ap.add_argument("--backend", choices=("nccl", "gloo"),
                    help="the ranks' backend (default: gloo with --cpu, "
                         "nccl on cards)")
    args = ap.parse_args(argv)
    if args.multichip:
        return launch_multichip(args.multichip, args.cpu, args.backend)
    fn, fargs = entry("cpu" if args.cpu else None)
    out = fn(*fargs)
    print("entry forward:", tuple(out.shape), out.dtype)
    return out


if __name__ == "__main__":
    main()
