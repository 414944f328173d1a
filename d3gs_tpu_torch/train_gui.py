"""CLI: interactive GUI trainer / viewer (counterpart of the repository's
`train_gui.py`, the reference train_gui.py).

    python -m d3gs_tpu_torch.train_gui -s <data> -m <out> --is_blender \
        [--gui | --no_gui] [--ip 127.0.0.1 --port 6009] [--device cpu] ...
    python -m d3gs_tpu_torch.train_gui -s <data> -m <run> --view_only \
        [--iteration N] [--no_gui] ...

An in-process dearpygui GUI (orbit/pan/zoom, wall-clock-animated fid, depth
mode, FPS overlay) interleaved with the baseline training loop through its
`live_hook`; without dearpygui, or with `--no_gui`, the SIBR-protocol
socket viewer (`viewer/network_viewer.py`) serves one client message per
log point (every 10 iterations) and, after training, until interrupted
(ctrl-c ends it with exit code 0). `--view_only` skips training and views
the checkpoint in --model_path at --iteration (Gaussians and deform
weights); its socket frames follow the wall-clock fid. Renders and trains
on the card (`cuda`) unless `--device cpu` asks for the CPU.
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from . import config as C
from . import resolve_device


def _camera(vcam, fid: float, device):
    """The port's Camera for a decoded client camera (`ViewerCamera`)."""
    from .data.cameras import Camera
    t = lambda a: torch.as_tensor(  # noqa: E731
        np.asarray(a, np.float32), device=device)
    return Camera(viewmatrix=t(vcam.world_view_transform),
                  projmatrix=t(vcam.full_proj_transform),
                  campos=t(vcam.camera_center), fid=fid,
                  image=torch.zeros((vcam.height, vcam.width, 3),
                                    device=device),
                  width=vcam.width, height=vcam.height, fovx=vcam.fovx,
                  fovy=vcam.fovy)


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="GUI trainer / viewer (PyTorch/CUDA port)")
    C.add_group_args(parser, C.ModelParams)
    C.add_group_args(parser, C.PipelineParams)
    C.add_group_args(parser, C.OptimizationParams)
    parser.add_argument("--ip", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=6009)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--gui", action="store_true",
                        help="force the dearpygui front-end (default: use "
                             "it when importable, else socket viewer)")
    parser.add_argument("--no_gui", action="store_true",
                        help="force the headless socket viewer")
    parser.add_argument("--view_only", action="store_true",
                        help="no training: view the trained checkpoint in "
                             "--model_path at --iteration")
    parser.add_argument("--iteration", type=int, default=-1)
    parser.add_argument("--gui_size", type=int, default=800)
    parser.add_argument("--radius", type=float, default=2.5)
    parser.add_argument("--device", default="cuda",
                        help="torch device (default cuda; cpu on request)")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)

    model_cfg = C.extract_group(args, C.ModelParams)
    pipe_cfg = C.extract_group(args, C.PipelineParams)
    opt_cfg = C.extract_group(args, C.OptimizationParams)

    from .data.scene import Scene
    from .models.renderer import render
    from .viewer.gui import GUI

    use_gui = args.gui or (not args.no_gui and GUI.available())
    if args.gui and not GUI.available():
        raise SystemExit("--gui requested but dearpygui is not installed "
                         "(optional dependency); drop --gui for the "
                         "socket viewer")
    if not model_cfg.model_path:
        model_cfg.model_path = "./output/gui"
    os.makedirs(model_cfg.model_path, exist_ok=True)
    bg = torch.zeros(3, device=device)

    def view_render(direct: bool = False):
        def _r(state, cam, dx, dr, ds):
            # ODE-kind fields return absolute positions (direct_compute)
            return render(state, cam, d_xyz=dx, d_rotation=dr, d_scaling=ds,
                          direct_compute=direct, bg=bg,
                          dup_capacity=pipe_cfg.dup_capacity,
                          antialias=pipe_cfg.antialias)
        return _r

    if args.view_only:
        # ---- trained-scene viewer (reference test_step-only flow) ----
        from .models.deform.fields import (ODE_KINDS, create_deform_field,
                                           load_deform_weights)
        from .train.flagship import pick_field_spec

        scene = Scene(model_cfg, load_iteration=args.iteration,
                      shuffle=False, capacity=pipe_cfg.capacity,
                      device=device)
        spec = pick_field_spec(model_cfg, opt_cfg)
        field = load_deform_weights(model_cfg.model_path, create_deform_field(
            spec, device=device, opt_cfg=opt_cfg), args.iteration)
        direct = spec.kind in ODE_KINDS

        def deform_fn(xyz, fid):
            return field.step(xyz, fid, y0=xyz)

        gui = GUI(scene.gaussians, width=args.gui_size,
                  height=args.gui_size, radius=args.radius,
                  deform_fn=deform_fn, render_fn=view_render(direct),
                  direct_compute=direct,
                  n_frames=len(scene.get_train_cameras()))
        if use_gui:
            print(f"viewing {model_cfg.model_path} "
                  f"(iteration {scene.loaded_iter})")
            gui.run()
        else:
            _serve_socket(args, model_cfg, pipe_cfg, gui, device)
        return

    # ---- GUI / socket-viewer trainer ---------------------------------
    from .train.baseline import train_baseline

    scene = Scene(model_cfg, capacity=pipe_cfg.capacity, seed=args.seed,
                  device=device)
    gui = GUI(scene.gaussians, width=args.gui_size, height=args.gui_size,
              radius=args.radius, render_fn=view_render(),
              n_frames=len(scene.get_train_cameras()))

    if use_gui:
        gui.setup()

        def live_hook(state, deform_state, field, iteration):
            gui.state = state
            if deform_state is not None:
                gui.deform_fn = lambda xyz, fid: field.step(xyz, fid, y0=xyz)
            gui.pump()

        serve_after = gui
    else:
        from .viewer import NetworkViewer
        viewer = NetworkViewer(args.ip, args.port)
        print(f"network viewer listening on {args.ip}:{viewer.port}",
              flush=True)

        def viewer_render_for(state):
            @torch.no_grad()
            def viewer_render(vcam, scale_mod):
                out = render(state, _camera(vcam, 0.0, device),
                             scaling_modifier=float(scale_mod), bg=bg,
                             dup_capacity=pipe_cfg.dup_capacity,
                             antialias=pipe_cfg.antialias)
                return out.image.cpu().numpy()
            return viewer_render

        def live_hook(state, deform_state, field, iteration):
            viewer.serve_once(viewer_render_for(state),
                              model_cfg.source_path)

        serve_after = None

    result = train_baseline(
        gaussians=scene.gaussians, train_cams=scene.get_train_cameras(),
        test_cams=scene.get_test_cameras(),
        cameras_extent=scene.cameras_extent,
        model_cfg=model_cfg, opt_cfg=opt_cfg, pipe_cfg=pipe_cfg,
        model_path=model_cfg.model_path, log_every=10, seed=args.seed,
        live_hook=live_hook)

    if serve_after is not None:
        serve_after.state = result.state
        print("training done; interactive view (close window to exit)")
        while serve_after.pump():
            pass
        serve_after._dpg.destroy_context()
    else:
        print("training done; serving viewer (ctrl-c to exit)", flush=True)
        try:
            while True:
                viewer.serve_once(viewer_render_for(result.state),
                                  model_cfg.source_path)
        except KeyboardInterrupt:
            viewer.close()


def _serve_socket(args, model_cfg, pipe_cfg, gui, device):
    """Headless fallback for --view_only: serve the trained scene over the
    SIBR socket protocol at the wall-clock fid, ignoring the orbit state
    (the client drives the poses)."""
    from .models.renderer import render
    from .viewer import NetworkViewer
    viewer = NetworkViewer(args.ip, args.port)
    print(f"dearpygui unavailable: socket viewer on {args.ip}:{viewer.port}",
          flush=True)
    bg = torch.zeros(3, device=device)

    @torch.no_grad()
    def viewer_render(vcam, scale_mod):
        cam = _camera(vcam, float(np.float32(gui.current_fid())), device)
        dx, dr, ds = (gui.deform_fn(gui.state.params.xyz, cam.fid)
                      if gui.deform_fn is not None else (0.0, 0.0, 0.0))
        out = render(gui.state, cam, d_xyz=dx, d_rotation=dr, d_scaling=ds,
                     direct_compute=gui.direct_compute
                     and gui.deform_fn is not None,
                     scaling_modifier=float(scale_mod), bg=bg,
                     dup_capacity=pipe_cfg.dup_capacity,
                     antialias=pipe_cfg.antialias)
        return out.image.cpu().numpy()

    try:
        while True:
            viewer.serve_once(viewer_render, model_cfg.source_path)
    except KeyboardInterrupt:
        viewer.close()


if __name__ == "__main__":
    main()
