"""Camera controller: FPS-style keyboard movement and mouse look.

Port of tracy_tpu/apps/input.py (reference input layer, src/input.h:9-78,
and TracyProcessInputs, win_raytracer.cpp:291-363), on the port's Camera:

* WASDQE move the eye along forward/right/up scaled by dt (target fixed);
* left-drag mouse look: delta = dt * (pos - grab_pos), the EYE rotates
  about the TARGET by delta.x around up and delta.y around right
  (row-vector `vec4(pos) * rotation`, the transposed rotation);
* any change is a camera cut, which resets progressive accumulation
  (TracyEvent::eCameraCut -> ResetFrameCounter).

The controller is host state in float64 numpy, state -> state; a GUI (the
matplotlib viewer) or a test feeds it events.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

from tracy_tpu_torch.core import math as tm
from tracy_tpu_torch.core.camera import Camera
from tracy_tpu_torch.utils.device import DEFAULT_DEVICE

MOVEMENT_KEYS = ("w", "a", "s", "d", "q", "e")


@dataclasses.dataclass
class CameraState:
    eye: np.ndarray
    target: np.ndarray
    up: np.ndarray
    fov_degrees: float
    aspect: float

    def to_camera(self, device=DEFAULT_DEVICE) -> Camera:
        """The port's Camera, on `device` (the card by default)."""
        return Camera.setup(self.eye, self.target, self.up, self.fov_degrees, self.aspect,
                            device=device)


class CameraController:
    def __init__(self, state: CameraState):
        self.state = state
        self.keys: set = set()
        self.mouse_down = False
        self._grab_pos: Optional[np.ndarray] = None

    def key_down(self, key: str):
        if key in MOVEMENT_KEYS:
            self.keys.add(key)

    def key_up(self, key: str):
        self.keys.discard(key)

    def mouse_press(self, x: float, y: float):
        self.mouse_down = True
        self._grab_pos = np.array([x, y], dtype=np.float64)

    def mouse_release(self):
        self.mouse_down = False
        self._grab_pos = None

    def update(self, dt: float, mouse_pos: Optional[Tuple[float, float]] = None) -> bool:
        """Advance the camera one frame; True on a camera cut."""
        s = self.state
        cut = False
        if self.keys:
            forward = s.target - s.eye
            right = np.cross(forward, s.up)
            right = right / max(np.linalg.norm(right), 1e-12)
            eye = s.eye.copy()
            for key, step in (("w", forward), ("s", -forward), ("a", -right),
                              ("d", right), ("q", -s.up), ("e", s.up)):
                if key in self.keys:
                    eye += dt * step
            s.eye = eye
            # The reference clears the movement keys each processed frame
            # (win_raytracer.cpp:324).
            self.keys.clear()
            cut = True
        if self.mouse_down and mouse_pos is not None and self._grab_pos is not None:
            delta = dt * (np.asarray(mouse_pos, dtype=np.float64) - self._grab_pos)
            if np.any(delta != 0):
                forward = s.target - s.eye
                right = np.cross(forward, s.up)
                right = right / max(np.linalg.norm(right), 1e-12)
                rot = (tm.rotate_axis(tm.radians(delta[0]), s.up)
                       @ tm.rotate_axis(tm.radians(delta[1]), right))
                # (vec4(pos, 1) * rotation).xyz: the row vector times rotation.
                s.eye = (np.append(s.eye, 1.0) @ rot)[:3]
                cut = True
        return cut
