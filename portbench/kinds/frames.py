"""Kind ``frames``: ``render_wave.render_frame_wavefront`` from the pinned
camera, one frame at a time, each ended by a synchronize; the frame
number advances each frame from a start the seed sets.

Compared: at pixels drawn from the seed of frames drawn from the seed,
the frame's colour and depth against the reference's; the number is the
share of bad pixels (``check.Reference.bad``).
"""

import torch

from portbench import drivers
from portbench.reference import shade

KEYS = {"render_mode", "gi_bounces", "frame_start"}


class Driver(drivers.Driver):
    def warm(self):
        t = self.traffic
        lo, hi = t["frame_start"]
        self.start = int(lo + self.seed % (hi - lo))
        self.cam = self.cam5(*self.pose)
        for i in range(t["warm_frames"]):
            self.render(self.start + 1000 + i)
        drivers.sync(self.dev)

    def render(self, frame_number):
        from svo_raytracer_torch.ops import render_wave

        t = self.traffic
        return render_wave.render_frame_wavefront(
            self.ws, self.cam, self.W, self.H, render_mode=t["render_mode"],
            frame_number=frame_number, gi_bounces=t["gi_bounces"])

    def run(self, seconds, among, min_units=0, step=None):
        plan = self.capture_plan(among)
        self.captures = []

        def unit(i, keep):
            col, depth, _ = self.render(self.start + i)
            drivers.sync(self.dev)
            if keep:
                self.captures.append((self.start + i, col.clone(),
                                      depth.clone()))

        return self.loop(unit, seconds, plan, min_units, step)

    def check(self, ref, program=None):
        """Share of bad pixels over the captured frames.  ``program(number,
        px, py)`` gives the colour and depth in the system's place (the
        control); by default they are the captured frame's."""
        t = self.traffic
        bad = total = 0
        for number, col, depth in self.captures:
            px, py = ref.pixels(t["capture"]["pixels"])
            segs = ref.segments()
            rcol, rdepth = shade.gi_pixels(
                ref.world, self.cam, px, py, self.W, self.H, number,
                t["gi_bounces"], counts=segs)
            pc, pd = ((col[py, px], depth[py, px]) if program is None
                      else program(number, px, py))
            b, cg, dg = ref.bad(pc, pd, rcol, rdepth, t["tolerance"])
            ref.log(f"frame {number}: {b} of {px.numel()} sampled pixels "
                    f"off; largest colour gap {cg:.3g}, depth gap {dg:.3g}")
            bad += b
            total += px.numel()
        return [("bad_pixel_share", bad / max(total, 1),
                 t["limits"]["bad_pixel_share"])]

    def control(self, ref, low):
        """The reference in precision ``low`` in the system's place."""
        t = self.traffic
        return self.check(ref, program=lambda number, px, py: shade.gi_pixels(
            ref.world, self.cam, px, py, self.W, self.H, number,
            t["gi_bounces"], low))


def _stale(patch):
    from svo_raytracer_torch.ops import render_wave
    real = render_wave.render_frame_wavefront
    patch(render_wave, "render_frame_wavefront",
          lambda *a, **kw: real(*a, **dict(kw, frame_number=1)))


def _half(patch):
    from svo_raytracer_torch.ops import render_wave
    real = render_wave._render_gi

    def half(*a, **kw):
        col, depth, it = real(*a, **kw)
        n = col.shape[0] // 2
        return (torch.cat([col[:n], torch.zeros_like(col[n:])]),
                torch.cat([depth[:n], torch.zeros_like(depth[n:])]), it)
    patch(render_wave, "_render_gi", half)


def _altered(patch):
    from svo_raytracer_torch.ops import shade as port_shade
    real = port_shade.gi_update

    def off(*a, **kw):
        out = real(*a, **kw)
        return (out[0] + 0.01,) + out[1:]
    patch(port_shade, "gi_update", off)


FAULTS = {"stale": _stale, "half": _half, "altered": _altered}
