"""The benchmark of svo_raytracer_torch on one NVIDIA H100 (BENCHMARK.json
at the checkout's root names its cells; ``run.py`` runs one)."""
