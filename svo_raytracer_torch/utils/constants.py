"""Engine constants and configuration the port needs (the values of
svo_raytracer_tpu/utils/constants.py, from the reference's Constants.java
and Camera.java, and its RenderConfig and WorldConfig)."""

from __future__ import annotations

import dataclasses

# --- Octree traversal (svotrace.comp:31-43) -------------------------------
#: Positions walk [1,2) and the 23 float32 mantissa bits are the per-level
#: coordinate bits (svotrace.comp:39, POP at :347-365).
MAX_SCALE = 23
#: Default per-ray LOD cutoff (svotrace.comp:40).
MAX_DEPTH = 13
#: Runaway-ray kill switch (svotrace.comp:41).
MAX_RAYCAST_ITERATIONS = 1500
#: Direction components are clamped away from zero (svotrace.comp:31,226-228).
EPSILON = 3.552713678800501e-15
SQRT3 = 1.73205080757

# --- World / octree layout (Constants.java) --------------------------------
#: Reference world resolution in voxels (Constants.java:30 says 8196, a typo
#: for 8192 = 8 chunks of 1024; the functional value is kept).
WORLD_SIZE = 8192
CHUNK_SIZE = 1024
#: Tombstone value written over deleted subtrees (Constants.java:16).
DELETE_VALUE = 127
MAX_MATERIALS = 256
#: SDF march skips shorter than this step one voxel (Octree.java:748).
MARCH_DISTANCE_MIN_CUTOFF = 5

#: Child octant order (Constants.java:18-27): bit0 = +x, bit1 = +y, bit2 = +z.
CHILD_OFFSETS = (
    (0, 0, 0),
    (1, 0, 0),
    (0, 1, 0),
    (1, 1, 0),
    (0, 0, 1),
    (1, 0, 1),
    (0, 1, 1),
    (1, 1, 1),
)

# --- 2-bit child-type tags in the leaf mask (Octree.java:589-599) ----------
TAG_BRANCH = 0
TAG_SURFACE_LEAF = 1
TAG_SUBDIV_LEAF = 2
TAG_NON_SURFACE_LEAF = 3

# --- Camera (Camera.java:13-18, Constants.java:8-10) -----------------------
CAMERA_SCALE_X = 0.9
CAMERA_SCALE_Y = 1.6
CAMERA_LOWER_LIMIT = -1.570
CAMERA_UPPER_LIMIT = 1.570

# --- Window (Constants.java:4-5) -------------------------------------------
WINDOW_WIDTH = 1920
WINDOW_HEIGHT = 1080


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Static render parameters of a scene."""

    width: int = WINDOW_WIDTH
    height: int = WINDOW_HEIGHT
    render_mode: int = 2  # default mode (Main.java:125)
    max_depth: int = MAX_DEPTH
    max_iterations: int = MAX_RAYCAST_ITERATIONS
    use_beam: bool = False
    beam_tile: int = 4  # 1 coarse ray per 4x4 pixels (Main.java:39,265)
    gi_bounces: int = 1  # diffuse GI bounces in mode 0 (svotrace.comp:444)


@dataclasses.dataclass(frozen=True)
class WorldConfig:
    """World-generation parameters (chunkgen uniforms + Octree build args)."""

    size: int = WORLD_SIZE
    chunk_size: int = CHUNK_SIZE
    max_lod: int = 9  # per-chunk LOD (Octree.java:256)
    world_offset: tuple = (0, 0, 0)
