"""Rank jobs of the port's multi-process tests (tests/test_torch_parallel.py,
test_torch_bricks.py, test_torch_wave_sharded.py,
test_torch_world_sharded.py).

Each test module's fixture writes its inputs to ``in.pt`` in a temporary
directory and calls :func:`run_ranks`, which spawns the ranks of a gloo
group on the CPU (svo_raytracer_torch.parallel.distributed.spawn, a
FileStore: no port) running one job of this module; each rank writes
what it computed to ``rank<r>.pt``.  This module imports torch and the
port only: spawned ranks import it afresh and never load JAX.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

from svo_raytracer_torch.core import octree
from svo_raytracer_torch.diff import render_diff as rd
from svo_raytracer_torch.diff import wave_diff as wd
from svo_raytracer_torch.models import procgen, world
from svo_raytracer_torch.ops import brick_scene, wavefront
from svo_raytracer_torch.parallel import bricks as B
from svo_raytracer_torch.parallel import distributed
from svo_raytracer_torch.parallel import mesh as mesh_mod
from svo_raytracer_torch.parallel import render_sharded
from svo_raytracer_torch.parallel import render_wave_sharded as rws


def run_ranks(job, n, d):
    """Spawn ``n`` gloo ranks on the CPU running ``job(d)``; returns each
    rank's saved results, in rank order."""
    distributed.spawn(job, n, "gloo", "cpu", (str(d),))
    return [torch.load(os.path.join(d, f"rank{r}.pt")) for r in range(n)]


def _inputs(d):
    return torch.load(os.path.join(d, "in.pt"))


def _save(d, out):
    torch.save(out, os.path.join(d, f"rank{dist.get_rank()}.pt"))


def _tree(inp):
    return octree.from_reference(*inp["tree"]).to_device("cpu")


def _refused(fn):
    """The ValueError message ``fn()`` raises, or None if it returns."""
    try:
        fn()
    except ValueError as e:
        return str(e)
    return None


def job_parallel(d):
    """tests/test_parallel.py's checks on tile_mesh(4): modes 1-3, one
    train step, 15 steps from noisy albedo, an uneven height."""
    inp = _inputs(d)
    tree, cam5 = _tree(inp), inp["cam5"]
    W = H = 32
    m = mesh_mod.tile_mesh(4, "cpu")
    out = {f"render{mode}": render_sharded.make_sharded_render(
        m, W, H, render_mode=mode)(tree, cam5) for mode in (1, 2, 3)}
    p, loss = render_sharded.make_sharded_train_step(m, W, H, lr=1.0)(
        rd.VoxelParams(*inp["params"]), tree, cam5, inp["target"])
    out.update(albedo=p.albedo, density=p.density, loss=loss)
    step = render_sharded.make_sharded_train_step(m, W, H, lr=300.0)
    p, out["losses"] = rd.VoxelParams(*inp["noisy"]), []
    for _ in range(15):
        p, loss = step(p, tree, cam5, inp["target0"])
        out["losses"].append(float(loss))
    out["uneven"] = _refused(
        lambda: render_sharded.make_sharded_render(m, 32, 34))
    out["mode0"] = _refused(
        lambda: render_sharded.make_sharded_render(m, W, H, render_mode=0))
    distributed.init_distributed("gloo")   # a second start does nothing
    try:
        distributed.init_distributed("nccl")
    except RuntimeError as e:
        out["other_backend"] = str(e)
    g = distributed.global_tile_mesh("cpu")
    out["host_rows"] = distributed.host_local_rows(32, g)
    out["tile_rank"] = (g.rank("tiles"), g.size("tiles"), g.shape)
    _save(d, out)


def job_bricks(d):
    """tests/test_bricks.py's sharded checks on grid_mesh(2, 2): brick
    renders in modes 0-3, a train step and three more."""
    inp = _inputs(d)
    tree, cam5 = _tree(inp), inp["cam5"]
    m = mesh_mod.grid_mesh(2, 2, "cpu")
    bs = B.split_bricks(tree, level=1)
    dbs = bs.to_device("cpu", m)
    out = {f"render{mode}": B.make_brick_render(m, bs, 64, 32,
                                                render_mode=mode)(dbs, cam5)
           for mode in (1, 2, 3)}
    out["render0"] = B.make_brick_render(m, bs, 32, 16, render_mode=0,
                                         frame_number=1)(dbs, cam5)
    step = B.make_brick_train_step(m, bs, 32, 16, lr=1.0)
    p, loss = step(rd.VoxelParams(*inp["params"]), dbs, cam5, inp["target"])
    out.update(albedo=p.albedo, density=p.density, loss=loss, losses=[])
    for _ in range(3):
        p, loss = step(p, dbs, cam5, inp["target"])
        out["losses"].append(float(loss))
    out["ids"] = dbs.ids
    _save(d, out)


def job_wave(d):
    """Wavefront tile renders on tile_mesh(4) (modes 3, 0 gi-1 and 2,
    interleaved and banded) and the sharded K = 2 train step."""
    inp = _inputs(d)
    ws = wavefront.prepare(brick_scene.brickify(octree.from_reference(
        *inp["tree"])), "cpu")
    cam5 = inp["cam5"]
    W, H = inp["size"]
    m = mesh_mod.tile_mesh(4, "cpu")
    out = {}
    for mode, interleave in ((3, True), (3, False), (0, True), (0, False),
                             (2, True)):
        render = rws.make_wave_sharded_render(m, ws, W, H, render_mode=mode,
                                              gi_bounces=1,
                                              interleave=interleave)
        out[(mode, interleave)] = render(ws, cam5, 1)
    step = wd.make_wave_sharded_train_step(m, ws, W, H, K=2, lr=inp["lr"])
    p, loss = step(wd.init_params(ws), cam5, inp["target"])
    out.update(albedo=p.albedo, density=p.density, loss=loss)
    _save(d, out)


def job_world(d):
    """build_world_sharded of a 64^3 perlin world from 32^3 chunks on
    this job's tile mesh."""
    m = mesh_mod.tile_mesh(device_type="cpu")
    w = world.build_world_sharded(
        64, 32, lambda o: procgen.generate_chunk(o, 32, device="cpu"), m,
        world_offset=(0, -32, 0))
    _save(d, dict(arrays=w.arrays(), n_nodes=w.n_nodes,
                  world_size=w.world_size))
