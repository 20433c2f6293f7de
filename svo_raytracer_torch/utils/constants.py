"""Engine constants the port needs (the values of
svo_raytracer_tpu/utils/constants.py, from the reference's Constants.java
and Camera.java)."""

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
