"""Process-group set-up and the job's meshes (port of
svo_raytracer_tpu/parallel/distributed.py).

The JAX package starts ``jax.distributed`` on a TPU pod, where the pod's
environment names every host and device.  Here each process is one rank
of a ``torch.distributed`` group: :func:`init_distributed` starts the
group once per process, with the backend the caller chooses (``nccl``:
one card per rank; ``gloo``: CPU tensors, or several ranks sharing a
card), and the mesh helpers of parallel/mesh.py then address ranks
through named axes.  The backend is never changed behind the caller's
back.
"""

from __future__ import annotations

import os
import tempfile

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from . import mesh as mesh_mod


def init_distributed(backend: str, init_method: str | None = None,
                     world_size: int | None = None,
                     rank: int | None = None) -> None:
    """Start this process's default group (idempotent: a second call with
    the same backend does nothing; another backend raises).

    ``init_method`` defaults to ``env://``: the rendezvous torchrun sets
    up (MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK), in place of the TPU
    pod's auto-detection.  ``file://<path>`` (a FileStore) needs no port.
    """
    if dist.is_initialized():
        if dist.get_backend() != backend:
            raise RuntimeError(f"the default group already runs "
                               f"{dist.get_backend()!r}, not {backend!r}")
        return
    dist.init_process_group(
        backend, init_method=init_method or "env://",
        world_size=-1 if world_size is None else world_size,
        rank=-1 if rank is None else rank)


def global_tile_mesh(device_type: str = "cuda") -> mesh_mod.Mesh:
    """1-D ``tiles`` mesh over every rank of the job (all hosts)."""
    return mesh_mod.tile_mesh(device_type=device_type)


def host_local_rows(height: int, mesh: mesh_mod.Mesh) -> tuple[int, int]:
    """The row window [lo, hi) that this host's ranks own under contiguous
    row sharding over ``tiles``: used to feed per-host targets without
    making the global image anywhere.  This host's ranks are the
    LOCAL_WORLD_SIZE ranks around this one (LOCAL_RANK), as torchrun and
    the entry's launcher set them; on a 1-D tile mesh a rank's ``tiles``
    index is its global rank."""
    n = mesh.size("tiles")
    if height % n:
        raise ValueError(f"height {height} must divide over {n} tiles")
    rows = height // n
    try:
        local_rank = int(os.environ["LOCAL_RANK"])
        local_size = int(os.environ["LOCAL_WORLD_SIZE"])
    except KeyError as e:
        raise RuntimeError(f"host_local_rows needs {e.args[0]} (set by "
                           f"torchrun or the entry's launcher)") from None
    first = mesh.rank("tiles") - local_rank
    return first * rows, (first + local_size) * rows


def rank_device(backend: str, device_type: str) -> torch.device:
    """The device a rank works on: the CPU; under nccl the card of its
    local rank (one card per rank); under gloo on cards, card 0, which
    every rank shares."""
    if device_type == "cpu":
        return torch.device("cpu")
    if backend == "nccl":
        return torch.device("cuda", int(os.environ.get("LOCAL_RANK",
                                                       dist.get_rank())))
    return torch.device("cuda", 0)


def _rank_main(rank, fn, n, store, backend, device_type, args):
    os.environ["LOCAL_RANK"] = str(rank)
    os.environ["LOCAL_WORLD_SIZE"] = str(n)
    if device_type == "cpu":
        torch.set_num_threads(1)   # n ranks share the host's cores
    init_distributed(backend, f"file://{store}", n, rank)
    try:
        if device_type == "cuda":
            # before any mesh: DeviceMesh keeps a device already chosen
            torch.cuda.set_device(rank_device(backend, "cuda"))
        fn(*args)
    finally:
        dist.destroy_process_group()


def spawn(fn, n: int, backend: str, device_type: str, args=()) -> None:
    """Run ``fn(*args)`` in ``n`` new processes, one rank each of a group
    over ``backend`` (a FileStore in a temporary directory: no port), on
    rank_device's device, with LOCAL_RANK and LOCAL_WORLD_SIZE set.
    ``fn`` must be importable by name (spawned processes start afresh).
    Any rank's exception fails the call."""
    with tempfile.TemporaryDirectory() as tmp:
        mp.spawn(_rank_main, args=(fn, n, os.path.join(tmp, "store"),
                                   backend, device_type, tuple(args)),
                 nprocs=n)
