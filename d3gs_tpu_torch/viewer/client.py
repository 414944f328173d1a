"""A loopback client of the SIBR viewer protocol that `NetworkViewer`
serves, and a runner that starts `python -m d3gs_tpu_torch.train_gui
--no_gui` in a subprocess and takes frames from it: the viewer checked end
to end, as a remote SIBR viewer would drive it."""
from __future__ import annotations

import json
import math
import os
import select
import signal
import socket
import subprocess
import sys
import threading
import time

import numpy as np

from ..ops.camera_math import perspective_projection, world_to_view

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
FOV = math.radians(60)


def look_from_z(z: float):
    """(view, full projection), row-vector convention, of a camera at
    (0, 0, z) looking down -z, with a 60-degree field of view."""
    V = world_to_view(np.eye(3), np.array([0.0, 0.0, z])).T
    return V, V @ perspective_projection(0.01, 100.0, FOV, FOV).T


def client_message(width, height, V, full, scale=1.0) -> dict:
    """A SIBR client message for the row-vector view / full projection:
    the viewer negates view columns 1, 2 and projection column 1 on
    receipt, so they are sent negated."""
    v, f = np.array(V, np.float64), np.array(full, np.float64)
    v[:, 1:3] *= -1
    f[:, 1] *= -1
    return {"resolution_x": width, "resolution_y": height, "train": True,
            "fov_x": FOV, "fov_y": FOV, "z_near": 0.01, "z_far": 100.0,
            "shs_python": False, "rot_scale_python": False,
            "keep_alive": True, "scaling_modifier": scale,
            "view_matrix": v.ravel().tolist(),
            "view_projection_matrix": f.ravel().tolist()}


def request_frame(sock, msg) -> tuple[np.ndarray, str]:
    """Send one message on a connected client socket; -> (H, W, 3) uint8
    frame, verify string."""
    data = json.dumps(msg).encode()
    sock.sendall(len(data).to_bytes(4, "little") + data)
    n = msg["resolution_x"] * msg["resolution_y"] * 3 + 4
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("the viewer closed the connection")
        buf += chunk
    k = int.from_bytes(buf[-4:], "little")
    verify = b""
    while len(verify) < k:
        verify += sock.recv(k - len(verify))
    img = np.frombuffer(buf[:-4], np.uint8).reshape(
        msg["resolution_y"], msg["resolution_x"], 3)
    return img, verify.decode()


def serve_train_gui(args, frames: int, msg: dict, wait_done: bool = False,
                    timeout: float = 300.0) -> dict:
    """`python -m d3gs_tpu_torch.train_gui <args> --no_gui --port 0` in a
    subprocess. Once it prints the port it listens on, one connection takes
    `frames` frames with `msg`, each kept as (frame, verify, whether the
    process had printed "training done" by then, seconds since the start).
    With `wait_done`, waits for "training done" (the training route serves
    until interrupted only after training; SIGINT during training is a
    KeyboardInterrupt). Then SIGINT, which ends the CLI.
    -> {"frames", "rc", "startup_s", "output"}."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "d3gs_tpu_torch.train_gui", *args,
         "--no_gui", "--port", "0"], cwd=_ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    lines, got, port = [], [], None
    t0 = time.perf_counter()
    try:
        while port is None and time.perf_counter() - t0 < timeout:
            if proc.poll() is not None:
                break
            if select.select([proc.stdout], [], [], 1.0)[0]:
                line = proc.stdout.readline()
                lines.append(line)
                if "127.0.0.1:" in line:
                    port = int(line.rsplit(":", 1)[1])
        if port is None:
            raise RuntimeError("train_gui did not listen: "
                               + "".join(lines)[-2000:])
        startup = time.perf_counter() - t0
        done = threading.Event()

        def reader():
            for line in proc.stdout:
                lines.append(line)
                if "training done" in line:
                    done.set()
        th = threading.Thread(target=reader, daemon=True)
        th.start()
        with socket.create_connection(("127.0.0.1", port),
                                      timeout=timeout) as s:
            for _ in range(frames):
                img, verify = request_frame(s, msg)
                got.append((img, verify, done.is_set(),
                            time.perf_counter() - t0))
        if wait_done and not done.wait(timeout=2 * timeout):
            raise RuntimeError("train_gui's training did not end: "
                               + "".join(lines)[-2000:])
        proc.send_signal(signal.SIGINT)
        rc = proc.wait(timeout=timeout)
        th.join(timeout=30)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    return {"frames": got, "rc": rc, "startup_s": startup,
            "output": "".join(lines)}
