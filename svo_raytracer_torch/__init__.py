"""svo_raytracer_torch — the brick-wavefront pathtracer on PyTorch and CUDA.

A port of ``svo_raytracer_tpu`` (the JAX/Pallas reference, which stays in
the repository) to one NVIDIA Hopper GPU.  The layout mirrors the JAX
package so each function's counterpart is found under the same name:

  core/    — the octree node table and its NumPy voxel builder
  utils/   — engine constants and the camera
  ops/     — brick scene tables, the wavefront traversal (kernel K1 in
             ``csrc/wavefront.cu``), hit decode, shading, frame rendering
  models/  — scene builders (the direct heightmap -> BrickScene path)
  diff/    — differentiable rendering: the ESVO single-hit render and the
             wavefront K-hit chain with its compositor, SGD train steps
             and checkpoints
  parallel/ — the multi-device layer on torch.distributed: named-axis
             meshes, row-sharded ESVO and wavefront renders and train
             steps, octree brick sharding
  csrc/    — hand-written CUDA C++ kernels, built with nvcc at first use

The package imports ``torch`` and NumPy, and nothing of ``jax`` or of the
JAX package.
"""

__version__ = "0.1.0"
