"""The port's correctly rounded float32 roots (ops/fp.py) across fresh
processes: torch's multi-threaded float32 ``sqrt`` on the CPU has been one
ulp off on ~0.6% of rows in every process, and approximate (~3e-4) on one
thread's share of rows in some processes and not others (ROADMAP.md §3,
F1; scripts/torch_cpu_sqrt_repeat.py).  Eight processes, started
together, each normalise 200,000 seeded float32 rows on four threads
through shade._normalize (the ESVO primaries and bounce frames) and root
the decoders' integer normal lengths through fp.sqrt
(traverse._decode, brick_trace.decode_hits); every row must equal
NumPy's correctly rounded result.  Tolerance: none."""

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROCESSES = 8
ROWS = 200_000

CHILD = r"""
import sys
sys.path.insert(0, sys.argv[1])
import numpy as np, torch
torch.set_num_threads(4)
from svo_raytracer_torch.ops import fp, shade
seed, rows = int(sys.argv[2]), int(sys.argv[3])
gen = np.random.default_rng(seed)
v = (gen.normal(size=(rows, 3)) * gen.uniform(0.1, 10, (rows, 1))).astype(
    np.float32)
x, y, z = v[:, 0], v[:, 1], v[:, 2]
ref = v / np.sqrt(x * x + y * y + z * z)[:, None]
got = shade._normalize(torch.from_numpy(v)).numpy()
n = gen.integers(-5, 5, (rows, 3)).astype(np.float32)
s = n[:, 0] * n[:, 0] + n[:, 1] * n[:, 1] + n[:, 2] * n[:, 2]
roots = fp.sqrt(torch.from_numpy(s)).numpy()
sq = torch.from_numpy(x * x + y * y + z * z)
plain = int((torch.sqrt(sq).numpy() != np.sqrt(sq.numpy())).sum())
print(int((got != ref).any(1).sum()), int((roots != np.sqrt(s)).sum()),
      plain)
"""


def test_roots_equal_numpy_in_fresh_processes():
    procs = [subprocess.Popen([sys.executable, "-c", CHILD, ROOT, str(i),
                               str(ROWS)], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for i in range(PROCESSES)]
    runs = []
    for p in procs:
        out, err = p.communicate(timeout=120)
        assert p.returncode == 0, err
        runs.append(tuple(int(v) for v in out.split()))
    print("rows differing per process (normalised, integer roots, torch's "
          f"own float32 sqrt for comparison): {runs}")
    assert all(r[0] == 0 and r[1] == 0 for r in runs), runs
