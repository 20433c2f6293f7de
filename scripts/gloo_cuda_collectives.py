#!/usr/bin/env python3
"""Which collectives the gloo backend takes on CUDA tensors, and how fast.

    python scripts/gloo_cuda_collectives.py [--ranks 4] [--mib 256]

Spawns ``--ranks`` processes that share cuda:0 over a gloo group (a
FileStore in a temporary directory) and tries, on CUDA tensors, the
collectives the port's mesh helpers use (svo_raytracer_torch/parallel/
mesh.py): all_reduce with SUM and MIN on float32 and int32, all_gather
into a list, and all_gather_into_tensor; then a DeviceMesh of device type
"cuda" over that group.  Each refusal is printed with its error: this is
a probe, and the library itself never catches a collective's error.
Then the host-clock time of one all_reduce SUM of ``--mib`` MiB of
float32, on CUDA tensors (where gloo takes them) and on CPU tensors, and
the same on one rank over nccl.  Needs a CUDA GPU; prints the card's
name and power limit.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import tempfile
import time

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def attempt(label, fn):
    try:
        fn()
        torch.cuda.synchronize()
        return f"{label}: accepted"
    except (RuntimeError, ValueError, TypeError) as e:
        first = str(e).splitlines()[0][:160]
        return f"{label}: refused ({type(e).__name__}: {first})"


def timed_all_reduce(x, group=None):
    dist.barrier(group=group)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dist.all_reduce(x, group=group)
    if x.is_cuda:
        torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def rank_main(rank, n, store, mib, out_dir):
    torch.set_num_threads(1)
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            world_size=n, rank=rank)
    dev = torch.device("cuda", 0)
    lines = []
    for dt in (torch.float32, torch.int32):
        for op in ("SUM", "MIN"):
            x = torch.full((1000,), rank + 1, dtype=dt, device=dev)
            lines.append(attempt(
                f"all_reduce {op} {dt}",
                lambda x=x, op=op: dist.all_reduce(
                    x, op=getattr(dist.ReduceOp, op))))
    x = torch.arange(1000, dtype=torch.float32, device=dev) + rank
    outs = [torch.empty_like(x) for _ in range(n)]
    lines.append(attempt("all_gather (list) float32",
                         lambda: dist.all_gather(outs, x)))
    if lines[-1].endswith("accepted"):
        ok = all(torch.equal(o, torch.arange(1000, device=dev).float() + r)
                 for r, o in enumerate(outs))
        lines[-1] += f", values right {ok}"
    big = torch.empty(n * 1000, dtype=torch.float32, device=dev)
    lines.append(attempt("all_gather_into_tensor float32",
                         lambda: dist.all_gather_into_tensor(big, x)))
    from torch.distributed.device_mesh import init_device_mesh
    lines.append(attempt("init_device_mesh('cuda', (n,)) over gloo",
                         lambda: init_device_mesh("cuda", (n,),
                                                  mesh_dim_names=("tiles",))))
    numel = mib * 2**20 // 4
    times = {}
    for where in ("cuda", "cpu"):
        y = torch.ones(numel, dtype=torch.float32,
                       device=dev if where == "cuda" else "cpu")
        try:
            times[where] = [timed_all_reduce(y) for _ in range(3)]
        except RuntimeError as e:
            times[where] = f"refused: {str(e).splitlines()[0][:120]}"
    lines.append(f"all_reduce SUM of {mib} MiB float32 over {n} ranks, "
                 f"host ms (3 calls): {times}")
    with open(os.path.join(out_dir, f"rank{rank}.txt"), "w") as f:
        f.write("\n".join(lines) + "\n")
    dist.destroy_process_group()


def nccl_one(rank, store, mib, out_dir):
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"file://{store}",
                            world_size=1, rank=0)
    y = torch.ones(mib * 2**20 // 4, device="cuda")
    ms = [timed_all_reduce(y) for _ in range(3)]
    with open(os.path.join(out_dir, "nccl.txt"), "w") as f:
        f.write(f"nccl world size 1 all_reduce of {mib} MiB, host ms: {ms}\n")
    dist.destroy_process_group()


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--mib", type=int, default=256)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"{smi}; torch {torch.__version__} cuda {torch.version.cuda}")
    with tempfile.TemporaryDirectory() as tmp:
        mp.spawn(rank_main, args=(args.ranks, os.path.join(tmp, "store"),
                                  args.mib, tmp), nprocs=args.ranks)
        for r in range(args.ranks):
            with open(os.path.join(tmp, f"rank{r}.txt")) as f:
                print(f"[rank {r}]\n{f.read()}", end="")
        mp.spawn(nccl_one, args=(os.path.join(tmp, "store1"), args.mib, tmp),
                 nprocs=1)
        with open(os.path.join(tmp, "nccl.txt")) as f:
            print(f.read(), end="")


if __name__ == "__main__":
    sys.exit(main())
