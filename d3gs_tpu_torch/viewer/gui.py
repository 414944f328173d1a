"""Interactive in-process GUI viewer/trainer (counterpart of
`d3gs_tpu/viewer/gui.py`, the reference train_gui.py:524-710 +
utils/gui_utils.py).

A `GUI` over `OrbitCamera` + the port's renderer: orbit/pan/zoom
interaction, wall-clock-animated fid (reference :655-664), RGB/depth
display modes and an FPS / infer-time overlay. dearpygui is an optional
import needed only by `setup()` / `run()`: every other method (orbit
manipulation, `test_step` producing the current frame) works headless,
which is how the tests drive it and how the socket viewer reuses it.
Frames render on the device of the Gaussians (the CUDA blend on the card).

Training interleave: `attach_trainer` accepts a callable advancing training
by one chunk; `run()` alternates it with `test_step` like the reference's
`train_step`/`test_step` frame loop (:508-515).
"""
from __future__ import annotations

import time

import numpy as np
import torch

from .orbit import OrbitCamera


class GUI:
    def __init__(self, render_state, *, width: int = 800, height: int = 800,
                 radius: float = 2.5, fovy_deg: float = 60.0,
                 deform_fn=None, render_fn=None,
                 anim_period: float = 4.0, n_frames: int = 0,
                 fps_of_fid: float = 10.0, direct_compute: bool = False):
        """render_state: GaussianState (may be swapped while training).
        deform_fn(xyz, fid) -> (d_xyz, d_rot, d_scale) or None for static.
        render_fn(state, camera, d_xyz, d_rot, d_scale) -> output with
        .image (H, W, 3) and .depth (H, W) tensors; defaults to
        models.renderer.render.
        """
        self.state = render_state
        self.cam = OrbitCamera(width, height, r=radius, fovy_deg=fovy_deg)
        self.deform_fn = deform_fn
        # ODE-kind fields return ABSOLUTE positions; the renderer must use
        # them directly instead of composing xyz + d_xyz (render.py:53-56)
        self.direct_compute = direct_compute
        self._render_fn = render_fn
        self.mode = "rgb"                 # "rgb" | "depth"
        self.playing = True               # animate fid from the wall clock
        self.anim_period = anim_period    # seconds per fid \in [0,1) loop
        # with a known train-frame count, use the reference's exact rate:
        # fid = t * fps_of_fid / n_frames % 1 (train_gui.py:655-664)
        self.n_frames = n_frames
        self.fps_of_fid = fps_of_fid
        self.fid = 0.0                    # manual fid when not playing
        self.training = False
        self._trainer = None
        self._t0 = time.time()
        self.infer_ms = 0.0
        self.fps = 0.0
        self._buffer = np.zeros((height, width, 3), np.float32)

    # -- logic (headless-safe) ------------------------------------------
    def attach_trainer(self, step_once):
        """step_once() advances training and returns the live state."""
        self._trainer = step_once
        self.training = step_once is not None

    def current_fid(self) -> float:
        """Wall-clock animation over [0, 1) (reference :655-664)."""
        if self.playing:
            dt = time.time() - self._t0
            if self.n_frames > 0:
                return (dt * self.fps_of_fid / self.n_frames) % 1.0
            return (dt / self.anim_period) % 1.0
        return float(self.fid)

    def _camera(self):
        from ..data.cameras import Camera
        from ..ops.camera_math import perspective_projection

        # the orbit pose is NeRF-convention c2w; rectify to the COLMAP
        # convention the rasterizer uses exactly like the reference MiniCam
        # (train_gui.py:68-71: flip y/z rows, negate translation)
        w2c = np.linalg.inv(self.cam.pose)
        w2c[1:3, :3] *= -1
        w2c[:3, 3] *= -1
        view_row = w2c.T.astype(np.float32)
        proj_row = np.asarray(
            perspective_projection(self.cam.near, self.cam.far,
                                   self.cam.fovx, self.cam.fovy),
            np.float32).T
        dev = self.state.alive.device
        t = lambda a: torch.as_tensor(  # noqa: E731
            np.asarray(a, np.float32), device=dev)
        return Camera(
            viewmatrix=t(view_row), projmatrix=t(view_row @ proj_row),
            campos=t(-self.cam.pose[:3, 3]),
            fid=float(np.float32(self.current_fid())),
            image=torch.zeros((self.cam.H, self.cam.W, 3), device=dev),
            width=self.cam.W, height=self.cam.H,
            fovx=float(self.cam.fovx), fovy=float(self.cam.fovy))

    @torch.no_grad()
    def test_step(self) -> np.ndarray:
        """Render the current orbit view at the current fid; returns the
        (H, W, 3) float frame and updates the FPS/infer-time stats."""
        cam = self._camera()
        if self.deform_fn is not None:
            dx, dr, ds = self.deform_fn(self.state.params.xyz, cam.fid)
        else:
            dx = dr = ds = 0.0
        t0 = time.time()
        if self._render_fn is not None:
            out = self._render_fn(self.state, cam, dx, dr, ds)
        else:
            from ..models.renderer import render
            out = render(self.state, cam, d_xyz=dx, d_rotation=dr,
                         d_scaling=ds,
                         direct_compute=self.direct_compute
                         and self.deform_fn is not None)
        if self.mode == "depth":
            dep = out.depth.cpu().numpy()
            frame = np.repeat(
                (dep / max(float(dep.max()), 1e-6))[..., None], 3, axis=-1)
        else:
            frame = np.clip(out.image.cpu().numpy(), 0.0, 1.0)
        dt = time.time() - t0
        self.infer_ms = dt * 1e3
        self.fps = 1.0 / max(dt, 1e-9)
        self._buffer = frame.astype(np.float32)
        return self._buffer

    # -- dearpygui front-end -------------------------------------------
    @staticmethod
    def available() -> bool:
        try:
            import dearpygui.dearpygui  # noqa: F401
            return True
        except ImportError:
            return False

    def setup(self):
        """Create the dearpygui window/widgets/handlers. Requires
        dearpygui; raises ImportError pointing at the headless
        alternatives if it is missing (optional dependency by design)."""
        try:
            import dearpygui.dearpygui as dpg
        except ImportError as e:
            raise ImportError(
                "dearpygui is not installed — the interactive GUI is "
                "optional. Use the SIBR-protocol socket viewer "
                "(python -m d3gs_tpu_torch.train_gui without --gui) or "
                "python -m d3gs_tpu_torch.render for offline output.") from e
        self._dpg = dpg

        dpg.create_context()
        with dpg.texture_registry(show=False):
            dpg.add_raw_texture(self.cam.W, self.cam.H,
                                self._buffer.ravel(),
                                format=dpg.mvFormat_Float_rgb,
                                tag="_texture")
        with dpg.window(tag="_primary", width=self.cam.W,
                        height=self.cam.H):
            dpg.add_image("_texture")
        dpg.set_primary_window("_primary", True)

        with dpg.window(label="Control", width=260, height=220,
                        pos=(10, 10)):
            dpg.add_text("", tag="_log_fps")
            dpg.add_checkbox(
                label="depth mode", default_value=False,
                callback=lambda s, v: setattr(
                    self, "mode", "depth" if v else "rgb"))
            dpg.add_checkbox(
                label="animate fid", default_value=self.playing,
                callback=lambda s, v: setattr(self, "playing", v))
            dpg.add_slider_float(
                label="fid", default_value=0.0, min_value=0.0,
                max_value=1.0,
                callback=lambda s, v: setattr(self, "fid", v))
            if self._trainer is not None:
                dpg.add_checkbox(
                    label="train", default_value=True,
                    callback=lambda s, v: setattr(self, "training", v))

        def on_drag(sender, app_data):
            if dpg.is_item_hovered("_primary"):
                _, dx, dy = app_data
                self.cam.orbit(dx, dy)

        def on_wheel(sender, app_data):
            if dpg.is_item_hovered("_primary"):
                self.cam.scale(app_data)

        def on_pan(sender, app_data):
            if dpg.is_item_hovered("_primary"):
                _, dx, dy = app_data
                self.cam.pan(dx, dy)

        with dpg.handler_registry():
            dpg.add_mouse_drag_handler(button=dpg.mvMouseButton_Left,
                                       callback=on_drag)
            dpg.add_mouse_wheel_handler(callback=on_wheel)
            dpg.add_mouse_drag_handler(button=dpg.mvMouseButton_Middle,
                                       callback=on_pan)

        dpg.create_viewport(title="d3gs-tpu viewer", width=self.cam.W + 20,
                            height=self.cam.H + 40)
        dpg.setup_dearpygui()
        dpg.show_viewport()

    def pump(self) -> bool:
        """One GUI frame: render the current view, refresh overlays,
        process events. Returns False when the window was closed. Safe to
        call from a trainer's live_hook (passive interleave) or from
        `run()`'s loop."""
        dpg = self._dpg
        if not dpg.is_dearpygui_running():
            return False
        frame = self.test_step()
        dpg.set_value("_texture", frame.ravel())
        dpg.set_value("_log_fps",
                      f"infer {self.infer_ms:7.2f} ms  "
                      f"({self.fps:5.1f} FPS)  fid "
                      f"{self.current_fid():.3f}")
        dpg.render_dearpygui_frame()
        return True

    def run(self):
        """Interactive loop: alternate training chunks (when attached and
        enabled) with view frames, like the reference's train/test step
        frame loop (train_gui.py:508-515)."""
        self.setup()
        while True:
            if self.training and self._trainer is not None:
                self.state = self._trainer() or self.state
            if not self.pump():
                break
        self._dpg.destroy_context()
