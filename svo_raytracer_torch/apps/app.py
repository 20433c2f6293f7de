"""Application lifecycle + frame loop skeleton (port of
svo_raytracer_tpu/apps/app.py).

The reference's L0/L4 frame machinery (``Application.launch``:
initWindow -> preRun -> run-loop -> postRun -> destroy, ``Application.java:13-19``;
per-frame ``startFrame -> updateEarly -> update -> updateLate -> endFrame``,
``Window.java:66-104``) without a GL window: frames render to arrays/PNGs and
the loop is driven headlessly (interactive stdin or scripted).  Frame timing
is measured exactly like Window.java:83,102-103.
"""

from __future__ import annotations

import time


class Application:
    """Subclass and override the frame hooks (Window.java:112-118)."""

    frame_time_ms: float = 0.0
    frame_count: int = 0
    running: bool = False

    # -- lifecycle hooks --
    def pre_run(self) -> None: ...
    def post_run(self) -> None: ...

    # -- per-frame hooks --
    def update_early(self) -> None: ...
    def update(self) -> None: ...
    def update_late(self) -> None: ...
    def draw_ui(self) -> None: ...

    def should_close(self) -> bool:
        return not self.running

    def run_frame(self) -> None:
        start = time.perf_counter()
        self.update_early()
        self.update()
        self.update_late()
        self.draw_ui()
        self.frame_time_ms = (time.perf_counter() - start) * 1000.0
        self.frame_count += 1

    def launch(self, max_frames: int | None = None) -> None:
        """Application.launch (Application.java:13-19)."""
        self.pre_run()
        self.running = True
        try:
            while not self.should_close():
                self.run_frame()
                if max_frames is not None and self.frame_count >= max_frames:
                    break
        finally:
            self.running = False
            self.post_run()
