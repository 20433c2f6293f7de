"""Kind ``viewer``: ``apps.viewer.Viewer.run_frame`` on the wavefront
engine, one command of a closed loop of look and move keys per frame,
each frame ended by the viewer's crosshair readback; the seed sets the
loop's phase.

Compared: the camera each captured frame was rendered from against the
reference camera after the same commands (largest gap in the uniform),
then the frame at sampled pixels as ``frames`` does, mode 2's penumbra
allowed (``shade.direct_match``).
"""

import numpy as np
import torch

from portbench import drivers
from portbench.reference import camera as ref_camera
from portbench.reference import shade

KEYS = {"render_mode", "loop", "clearance_voxels"}


class Driver(drivers.Driver):
    def build_tables(self):
        from svo_raytracer_torch.apps.viewer import Viewer

        def tables():
            v = Viewer(self.tree, self.W, self.H, commands=[],
                       engine="wavefront", device=self.dev)
            v.pre_run()
            return v

        self.viewer = self.span("tables_s", tables)

    def warm(self):
        from svo_raytracer_torch.apps import input as keys
        from svo_raytracer_torch.utils.camera import Camera

        t = self.traffic
        self.keys = t["loop"].split()
        L = len(self.keys)
        v = self.viewer
        v.render_mode = t["render_mode"]
        v.cam = Camera(pos=np.asarray(self.pose[0], np.float64),
                       pitch=self.pose[1], yaw=self.pose[2])
        self.check_loop()
        self.phase = int(self.seed % L)
        for k in self.keys[:self.phase]:
            v._apply(keys.parse(k))
        v.running = True
        self.next = self.phase
        self.original_render = v.render
        self.keep = None

        def render(cam5, frame_number=None, render_mode=None):
            out = self.original_render(cam5, frame_number, render_mode)
            if self.keep is not None:
                self.captures.append((self.keep, cam5.clone(),
                                      out[0].clone(), out[1].clone()))
                self.keep = None
            return out

        v.render = render
        self.captures = []
        for _ in range(t["warm_frames"]):
            self.frame(None)
        drivers.sync(self.dev)

    def check_loop(self):
        """Every pose of the loop lies inside the world and above the
        terrain under it (a straight-down ray from the top of the world
        meets its surface below the camera)."""
        from svo_raytracer_torch.ops import wavefront

        cam = ref_camera.Camera(*self.pose)
        poses = []
        for k in self.keys:
            cam.command(k)
            poses.append(cam.pos.copy())
        p = torch.tensor(np.array(poses), dtype=torch.float32,
                         device=self.dev)
        o = p.clone()
        o[:, 1] = 1.999
        d = torch.zeros_like(o)
        d[:, 1] = -1.0
        res = wavefront.intersect_wavefront(self.viewer.wave_scene, o, d)
        ground = torch.where(res.hit, 1.999 - res.t, torch.ones_like(res.t))
        clear = (p[:, 1] - ground) * self.cfg["world_size"]
        inside = ((p > 1.0) & (p < 2.0)).all(1)
        lo = float(clear.min())
        need = self.traffic["clearance_voxels"]
        if not bool(inside.all()) or lo < need:
            raise RuntimeError(f"the command loop leaves the world or goes "
                               f"under its terrain: least clearance {lo:.1f} "
                               f"voxels (needs {need})")
        self.log(f"command loop: least clearance {lo:.1f} voxels")

    def frame(self, keep):
        k = self.keys[self.next % len(self.keys)]
        self.next += 1
        self.viewer.commands.append(k)
        self.keep = keep
        self.viewer.run_frame()

    def run(self, seconds, among, min_units=0, step=None):
        plan = self.capture_plan(among)
        self.captures = []

        def unit(i, keep):
            self.frame(self.next if keep else None)

        return self.loop(unit, seconds, plan, min_units, step)

    def check(self, ref, program=None):
        """The cameras, then the frames.  ``program(index, rcam, px, py)``
        gives the camera, colour and depth in the system's place (the
        control)."""
        t = self.traffic
        bad = total = 0
        cam_gap = 0.0
        for index, cam5, col, depth in self.captures:
            cam = ref_camera.Camera(*self.pose)
            for j in range(index + 1):
                cam.command(self.keys[j % len(self.keys)])
            rcam = torch.tensor(cam.uniform(), dtype=torch.float32,
                                device=ref.dev)
            px, py = ref.pixels(t["capture"]["pixels"])
            if program is not None:
                cam5, pc, pd = program(index, cam, px, py)
            else:
                pc, pd = col[py, px], depth[py, px]
            cam_gap = max(cam_gap, float((cam5.float() - rcam).abs().max()))
            rcol, rdepth, open_ = shade.direct_pixels(
                ref.world, rcam, px, py, self.W, self.H,
                counts=ref.segments())
            ok = shade.direct_match(pc, rcol, open_, t["tolerance"]["colour"])
            b, cg, dg = ref.bad(pc, pd, rcol, rdepth, t["tolerance"], ok)
            ref.log(f"viewer frame at command {index}: {b} of {px.numel()} "
                    f"sampled pixels off; largest colour gap {cg:.3g}, "
                    f"depth gap {dg:.3g}")
            bad += b
            total += px.numel()
        lim = t["limits"]
        return [("camera_gap", cam_gap, lim["camera_gap"]),
                ("bad_pixel_share", bad / max(total, 1),
                 lim["bad_pixel_share"])]

    def control(self, ref, low):
        """The reference in precision ``low`` in the system's place, its
        camera stepped in float32."""
        def program(index, cam, px, py):
            c5 = torch.tensor(camera_low(self.pose, self.keys, index),
                              device=ref.dev)
            col, depth, _ = shade.direct_pixels(ref.world, c5, px, py,
                                                self.W, self.H, low)
            return c5, col, depth
        return self.check(ref, program=program)


def camera_low(pose, keys, index):
    """The viewer's camera after commands 0..index, each step of its
    position and angles rounded to float32."""
    cam = ref_camera.Camera(*pose)
    for j in range(index + 1):
        cam.command(keys[j % len(keys)])
        cam.pos = cam.pos.astype(np.float32).astype(np.float64)
        cam.pitch = float(np.float32(cam.pitch))
        cam.yaw = float(np.float32(cam.yaw))
    return cam.uniform().astype(np.float32)


def _stale(patch):
    from svo_raytracer_torch.apps import viewer
    patch(viewer.Viewer, "_apply", lambda self, action: None)


def _half(patch):
    from svo_raytracer_torch.ops import shade as port_shade
    real = port_shade.direct_shade_math

    def half(*a, **kw):
        col, depth, it = real(*a, **kw)
        n = col.shape[0] // 2
        return torch.cat([col[:n], torch.zeros_like(col[n:])]), depth, it
    patch(port_shade, "direct_shade_math", half)


def _altered(patch):
    from svo_raytracer_torch.ops import shade as port_shade
    real = port_shade.direct_shade_math

    def off(*a, **kw):
        out = real(*a, **kw)
        return (out[0] + 0.01,) + out[1:]
    patch(port_shade, "direct_shade_math", off)


FAULTS = {"stale": _stale, "half": _half, "altered": _altered}
