"""Headless interactive viewer — the Main.java analog (port of
svo_raytracer_tpu/apps/viewer.py).

Drives the per-frame pipeline of the reference's ``Main.updateEarly``
(``Main.java:130-289``): input -> camera -> (beam prepass) -> trace ->
present, plus SDF edits with ranged device updates, save/load hotkeys and
the debug overlay.  "Present" writes PNG frames; input comes from stdin
commands or a ``--script`` string (see ``input.KEYBINDS``).

Two engines render, as in the JAX package: the brick wavefront
(ops/render_wave, kernel K1) for 32^3..2048^3 worlds and the ESVO octree
walk (ops/shade.render_image, kernel KE) otherwise.  An edit patches both
engines' device tables in place: the dirty node windows of the
DeviceTree, and the touched bricks of the WaveScene
(brick_scene.brickify_patch, wavefront.apply_patch).  Frames stay on the
device; mode 0 accumulates there in float32; only the crosshair's depth
pixel is read back each frame, and the colour only for a screenshot.
Each edit's stages are timed (``Viewer.edits``).

Usage:
  python -m svo_raytracer_torch.apps.viewer --svo assets/debug.svo \\
      --world-size 1024
  python -m svo_raytracer_torch.apps.viewer --demo sphere --script "w j p Q"
  ... --cpu      # on the CPU (the kernels' plain versions); default: cuda
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

from ..core import build_np, sdf, svo_format
from ..core.octree import Octree
from ..io.image import write_png
from ..utils import constants as C
from ..utils import profiling
from ..utils.camera import Camera
from . import input as input_mod
from .app import Application


def check_device(device) -> torch.device:
    """``device`` as a torch.device; a CUDA device with no GPU present
    raises rather than carrying on elsewhere."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass --cpu (or "
                           "device='cpu') to run on the CPU")
    return dev


class Viewer(Application):
    def __init__(self, tree: Octree, width=480, height=270, out_dir=".",
                 commands=None, interactive=False, use_beam=False,
                 engine="auto", device="cuda"):
        self.tree_host = tree.to_numpy()
        self.width, self.height = width, height
        self.out_dir = out_dir
        self.commands = list(commands or [])
        self.interactive = interactive
        self.device = check_device(device)
        self.render_mode = 2  # Main.java:125
        self.use_beam = use_beam
        self.show_debug = False
        self.frame_number = 0
        self.crosshair_depth = 0.0
        self.cam = Camera(pos=np.array([1.5, 1.5, 2.0]))
        self.speed = 0.02
        if engine == "auto":
            # the wavefront engine covers 32^3..2048^3 (flat L0, G <= 64)
            engine = ("wavefront" if 32 <= tree.world_size <= 2048
                      else "esvo")
        self.engine = engine
        self._accum = None      # progressive mode-0 accumulation buffer
        self._accum_n = 0
        self._moved = True
        self.edits = []         # one dict of stage times per SDF edit

    # -- device plumbing --
    def pre_run(self):
        from ..runtime.renderer import DeviceTree

        self.device_tree = DeviceTree(self.tree_host, self.device)
        self.wave_scene = None
        self._rebuild_wave()

    def _rebuild_wave(self):
        """Full brickify + prepare (set-up, and after read_world), keeping
        the slot capacity when the new scene fits it."""
        if self.engine == "wavefront":
            from ..ops import brick_scene, wavefront

            self.brick_host = brick_scene.brickify(self.tree_host)
            cap = (self.wave_scene.capacity if self.wave_scene is not None
                   and self.wave_scene.capacity >= self.brick_host.n_mixed
                   else None)
            self.wave_scene = wavefront.prepare(self.brick_host, self.device,
                                                capacity=cap)

    def cam5(self) -> torch.Tensor:
        return torch.tensor(self.cam.uniform(), dtype=torch.float32,
                            device=self.device)

    # -- frame --
    def update_early(self):
        cmd = None
        if self.commands:
            cmd = self.commands.pop(0)
        elif self.interactive:
            line = sys.stdin.readline()
            cmd = line if line else "Q"
        action = input_mod.parse(cmd) if cmd else None
        if action:
            self._apply(action)

        cam5 = self.cam5()
        # camera motion / edits restart progressive accumulation
        # (Main.java:161-243: any change resets frameNumber to 0)
        if self._moved:
            self.frame_number = 0
            self._accum = None
            self._accum_n = 0
            self._moved = False
        self.frame_number += 1
        color, depth, _ = self.render(cam5)
        if self.render_mode == 0:
            # progressive running average, on the device in float32
            self._accum = color if self._accum is None \
                else self._accum + color
            self._accum_n += 1
            # a divisor tensor: a CUDA tensor divided by a Python scalar is
            # multiplied by its reciprocal
            color = self._accum / torch.full_like(self._accum, self._accum_n)
        self.color = color
        # crosshair depth readback (Main.java:132-146) — the centre pixel
        # only, not the reference's full-frame glGetTexImage
        self.crosshair_depth = depth[self.height // 2,
                                     self.width // 2].item()

    def render(self, cam5, frame_number=None, render_mode=None):
        """One frame of the current engine: (color, depth, iters) on the
        device, row 0 the GL bottom scanline."""
        fn = self.frame_number if frame_number is None else frame_number
        mode = self.render_mode if render_mode is None else render_mode
        if self.engine == "wavefront":
            from ..ops import render_wave

            return render_wave.render_frame_wavefront(
                self.wave_scene, cam5, self.width, self.height,
                render_mode=mode, frame_number=fn)
        from ..ops import shade

        return shade.render_image(
            self.device_tree.dev, cam5, self.width, self.height,
            render_mode=mode, frame_number=fn, use_beam=self.use_beam,
            packed=self.device_tree.packed)

    def draw_ui(self):
        if self.show_debug:  # ImGui overlay analog (Main.java:292-314)
            pos = self.cam.pos
            print(f"# mode={self.render_mode} pos=({pos[0]:.3f},{pos[1]:.3f},"
                  f"{pos[2]:.3f}) rot=({self.cam.pitch:.3f},{self.cam.yaw:.3f})"
                  f" nodes={self.device_tree.n_nodes}"
                  f" frame_ms={self.frame_time_ms:.1f}"
                  f" beam={self.use_beam}", file=sys.stderr)

    def _screenshot(self):
        path = os.path.join(self.out_dir, f"frame_{self.frame_count:04d}.png")
        write_png(path, self.color)
        self.last_screenshot = path
        print(f"# wrote {path}", file=sys.stderr)

    def _place_sdf(self, value: int):
        """placeSDF (Main.java:338-353): un-project the crosshair depth,
        apply a sphere brush of world_size/128 voxels (at least 2), upload
        the dirty node windows and patch the touched bricks.  Appends the
        edit's record, with each stage's ms, to ``edits``."""
        target = self.cam.ray_pick_location(self.crosshair_depth,
                                            self.tree_host.world_size)
        radius = max(2, self.tree_host.world_size // 128)
        ball = sdf.Sphere(target, radius)
        rec = dict(value=value, target=[int(v) for v in target],
                   radius=radius, n_nodes_before=self.tree_host.n_nodes,
                   ms={})

        def stage(name, fn, sync=None):
            with profiling.timer(f"edit {name}", sync=sync):
                out = fn()
            rec["ms"][name] = profiling.summary()[f"edit {name}"]["last_ms"]
            return out

        new_tree, cb = stage("brush", lambda: sdf.use_sdf_brush(
            self.tree_host, ball, value))
        self.tree_host = new_tree
        stage("ranged_update",
              lambda: self.device_tree.ranged_update(new_tree, cb),
              sync=lambda: self.device_tree.packed)
        rec.update(n_nodes=new_tree.n_nodes, bounds=(cb.start0, cb.end0,
                                                     cb.start1, cb.end1),
                   tree_upload=dict(self.device_tree.last_upload))
        if self.engine == "wavefront":
            # incremental re-brick of only the touched cells
            from ..ops import brick_scene, wavefront

            rec["n_mixed_before"] = self.wave_scene.n_mixed
            patch = stage("brickify_patch", lambda: brick_scene.brickify_patch(
                new_tree, self.brick_host, ball.min, ball.max))
            up = {}
            self.wave_scene = stage(
                "apply_patch", lambda: wavefront.apply_patch(
                    self.wave_scene, self.brick_host, patch, stats=up),
                sync=lambda: self.wave_scene.attr_comb)
            rec.update(n_mixed=self.wave_scene.n_mixed, scene_upload=up)
        self.edits.append(rec)
        self._moved = True
        print(f"# placed sphere v={value} at {target} "
              f"dirty=[{cb.start0},{cb.end0})+[{cb.start1},{cb.end1})",
              file=sys.stderr)

    _MOVING = ("move_forward", "move_back", "move_left", "move_right",
               "move_up", "move_down", "rotate_left", "rotate_right",
               "rotate_up", "rotate_down")

    def _apply(self, action: str):
        c = self.cam
        if action in self._MOVING or action.startswith("render_mode_"):
            self._moved = True
        if action == "move_forward":
            c.pos = c.pos + c.forward * self.speed
        elif action == "move_back":
            c.pos = c.pos - c.forward * self.speed
        elif action == "move_left":
            c.pos = c.pos - c.right * self.speed
        elif action == "move_right":
            c.pos = c.pos + c.right * self.speed
        elif action == "move_up":
            c.pos = c.pos + np.array([0, self.speed, 0])
        elif action == "move_down":
            c.pos = c.pos - np.array([0, self.speed, 0])
        elif action == "rotate_left":
            c.rotate(0.0, 0.1)
        elif action == "rotate_right":
            c.rotate(0.0, -0.1)
        elif action == "rotate_up":
            c.rotate(0.1, 0.0)
        elif action == "rotate_down":
            c.rotate(-0.1, 0.0)
        elif action.startswith("render_mode_"):
            self.render_mode = int(action[-1])
        elif action == "toggle_debug":
            self.show_debug = not self.show_debug
        elif action == "toggle_beam":
            self.use_beam = not self.use_beam
        elif action == "save_world":
            svo_format.write_svo_file(self.tree_host,
                                      os.path.join(self.out_dir, "level1.svo"))
        elif action == "read_world":
            self.tree_host = svo_format.read_svo_file(
                os.path.join(self.out_dir, "level1.svo"),
                world_size=self.tree_host.world_size)
            self.device_tree.full_upload(self.tree_host)
            self._rebuild_wave()
            self._moved = True
        elif action == "subtract_sphere":
            self._place_sdf(0)
        elif action == "put_sphere":
            self._place_sdf(1)
        elif action == "speed_turbo":
            self.speed = 0.05
        elif action == "speed_slow":
            self.speed = 0.005
        elif action == "quit":
            self.running = False
        self._pending_screenshot = action == "screenshot"

    def update_late(self):
        if getattr(self, "_pending_screenshot", False):
            self._screenshot()
            self._pending_screenshot = False


def _demo_tree(kind: str, size: int = 64) -> Octree:
    x, y, z = np.meshgrid(*(np.arange(size),) * 3, indexing="ij")
    if kind == "sphere":
        v = (np.sqrt((x - size / 2) ** 2 + (y - size / 2) ** 2
                     + (z - size / 2) ** 2) <= size / 4).astype(np.uint8)
        v[:, :size // 8, :] = 1
    else:
        raise ValueError(kind)
    return build_np.build_octree_np(v)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--svo", help=".svo world file to load")
    ap.add_argument("--world-size", type=int, default=C.WORLD_SIZE,
                    help="voxels per edge of the --svo world (the file "
                         "does not record it)")
    ap.add_argument("--demo", default=None, help="demo scene (sphere)")
    ap.add_argument("--width", type=int, default=480)
    ap.add_argument("--height", type=int, default=270)
    ap.add_argument("--out", default=".")
    ap.add_argument("--script", default=None,
                    help="space-separated commands, e.g. 'w w j p Q'")
    ap.add_argument("--frames", type=int, default=None)
    ap.add_argument("--beam", action="store_true")
    ap.add_argument("--engine", default="auto",
                    choices=("auto", "wavefront", "esvo"),
                    help="traversal engine (auto: wavefront for 32..2048^3)")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: the CUDA device)")
    args = ap.parse_args(argv)
    device = check_device("cpu" if args.cpu else "cuda")

    if args.svo:
        tree = svo_format.read_svo_file(args.svo, world_size=args.world_size)
    else:
        tree = _demo_tree(args.demo or "sphere")

    commands = args.script.split() if args.script else None
    viewer = Viewer(tree, args.width, args.height, args.out,
                    commands=commands, interactive=args.script is None,
                    use_beam=args.beam, engine=args.engine, device=device)
    viewer.launch(max_frames=args.frames or (len(commands) if commands
                                             else None))
    return viewer


if __name__ == "__main__":
    main()
