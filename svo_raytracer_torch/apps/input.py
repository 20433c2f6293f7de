"""Input mapping — the reference keybinds as a headless command vocabulary
(port of svo_raytracer_tpu/apps/input.py).

The reference binds GLFW keys (``Input.java:14-38``): WASD/QE movement, arrow
rotation, 1-4 render modes, 0/9 save/load, mouse L/R subtract/place sphere,
backquote debug UI, backslash beam toggle.  Headless, the same vocabulary is
exposed as single-character commands consumed by the viewer's stdin/script
loop; key-state semantics (held vs pressed, Input.java:101-115) collapse to
one event per command.
"""

from __future__ import annotations

# command -> action name (mirrors the Input.java constants)
KEYBINDS = {
    "w": "move_forward",
    "s": "move_back",
    "a": "move_left",
    "d": "move_right",
    "q": "move_up",
    "e": "move_down",
    "i": "rotate_up",
    "k": "rotate_down",
    "j": "rotate_left",
    "l": "rotate_right",
    "1": "render_mode_0",   # reference: keys 1-4 select modes 0-3
    "2": "render_mode_1",
    "3": "render_mode_2",
    "4": "render_mode_3",
    "0": "save_world",
    "9": "read_world",
    "`": "toggle_debug",
    "\\": "toggle_beam",
    "x": "subtract_sphere",  # mouse left (Input.java:36-38)
    "c": "put_sphere",       # mouse right
    "t": "speed_turbo",
    "g": "speed_slow",
    "p": "screenshot",
    "Q": "quit",
}


def parse(command: str) -> str | None:
    return KEYBINDS.get(command.strip()[:1] if command.strip() else "")
