"""How often PyTorch's CPU float32 square root disagrees with NumPy's on
its first multi-threaded call in a fresh process.

Each of N child processes evaluates the port's cnoise and snoise, then
worley (whose last step is the square root of a 20,000-element view,
split across threads) once with torch.sqrt and once with the port's
NumPy root.  Prints, per process, how many roots differ and by how much,
and how many processes saw a difference above 1e-6 (an approximate root,
not a rounding).  The port's noise roots with NumPy on the CPU
(ops/noise._sqrt) because of what this finds.

    python scripts/torch_cpu_sqrt_repeat.py [N]     # default 40
"""

from __future__ import annotations

import os
import subprocess
import sys

CHILD = r"""
import sys
sys.path.insert(0, sys.argv[1])
import numpy as np, torch
from svo_raytracer_torch.ops import noise
a = np.random.default_rng(0).uniform(-1, 1, (3, 20000)).astype(np.float32)
x, y, z = (torch.from_numpy(v.copy()) for v in a)
noise.cnoise(x, z), noise.snoise(x, y, z)     # as the terrain runs them
numpy_root = noise._sqrt
noise._sqrt = torch.sqrt
with_torch = noise.worley(x, z)[0].numpy()
noise._sqrt = numpy_root
with_numpy = noise.worley(x, z)[0].numpy()
print(int((with_torch != with_numpy).sum()),
      float(np.abs(with_torch - with_numpy).max()))
"""


def main():
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 40
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    runs = []
    for _ in range(n):
        out = subprocess.run([sys.executable, "-c", CHILD, root],
                             capture_output=True, text=True, check=True)
        differ, err = out.stdout.split()
        runs.append((int(differ), float(err)))
    far = [r for r in runs if r[1] > 1e-6]
    print(f"roots differing from NumPy's per process (count, max "
          f"|difference|): {runs}")
    print(f"{sum(r[0] > 0 for r in runs)} of {n} processes differ; {len(far)} "
          f"of {n} by more than 1e-6: {far}")


if __name__ == "__main__":
    main()
