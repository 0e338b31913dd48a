"""SIBR live-viewer TCP bridge (same wire protocol as the reference).

Counterpart of reference gaussian_renderer/network_gui.py: a non-blocking
listener; each viewer message is a little-endian u32 length + JSON camera
payload (row-vector matrices with the Y/Z axis flips the SIBR viewer
sends); the reply is the rendered RGB bytes followed by a length-prefixed
verify string. The training loop polls ``handle()`` once per iteration.

The reference stores row-vector-convention (transposed) matrices; this
framework uses math convention, so the incoming matrices are transposed
after the axis flips.

A copy of rain_tpu/viewer/network_gui.py (numpy and the standard library)
with one repair: the 4-byte length is read until all 4 bytes have
arrived. rain_tpu reads it with a single ``recv(4)``
(rain_tpu/viewer/network_gui.py:47), which can return fewer bytes and
mis-frame every later message.
"""

from __future__ import annotations

import json
import socket

import numpy as np


class NetworkGUI:
    def __init__(self, host="127.0.0.1", port=6009):
        self.listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self.listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        # port-in-use retry (reference train.py:287-294)
        while True:
            try:
                self.listener.bind((host, port))
                break
            except OSError:
                port += 1
        self.host, self.port = host, port
        self.listener.listen()
        self.listener.settimeout(0)
        self.conn = None

    def try_connect(self):
        try:
            self.conn, addr = self.listener.accept()
            self.conn.settimeout(None)
            print(f"\nViewer connected by {addr}")
        except (BlockingIOError, socket.timeout, OSError):
            pass

    def _recv_exact(self, n: int) -> bytes:
        buf = b""
        while len(buf) < n:
            chunk = self.conn.recv(n - len(buf))
            if not chunk:
                raise ConnectionError("viewer closed")
            buf += chunk
        return buf

    def _read(self):
        n = int.from_bytes(self._recv_exact(4), "little")
        return json.loads(self._recv_exact(n).decode("utf-8"))

    def receive(self):
        """Returns (camera dict or None, do_training, shs_python,
        rot_scale_python, keep_alive, scaling_modifier)."""
        msg = self._read()
        width = msg["resolution_x"]
        height = msg["resolution_y"]
        if width == 0 or height == 0:
            return None, None, None, None, None, None
        wv = np.array(msg["view_matrix"], np.float32).reshape(4, 4)
        wv[:, 1] *= -1
        wv[:, 2] *= -1
        fp = np.array(msg["view_projection_matrix"],
                      np.float32).reshape(4, 4)
        fp[:, 1] *= -1
        world_view = wv.T                    # row-vector → math convention
        full_proj = fp.T
        cam_center = np.linalg.inv(world_view)[:3, 3]
        import math
        camera = {
            "width": int(width),
            "height": int(height),
            "world_view": world_view,
            "full_proj": full_proj,
            "camera_center": np.float32(cam_center),
            "tanfovx": np.float32(math.tan(msg["fov_x"] * 0.5)),
            "tanfovy": np.float32(math.tan(msg["fov_y"] * 0.5)),
        }
        return (camera, bool(msg["train"]), bool(msg["shs_python"]),
                bool(msg["rot_scale_python"]), bool(msg["keep_alive"]),
                msg["scaling_modifier"])

    def send(self, image_bytes, verify: str):
        if image_bytes is not None:
            self.conn.sendall(image_bytes)
        self.conn.sendall(len(verify).to_bytes(4, "little"))
        self.conn.sendall(bytes(verify, "ascii"))

    def handle(self, render_fn, source_path: str, training_done: bool):
        """One poll of the viewer loop (reference train.py:56-69).

        render_fn(camera dict, scaling_modifier) → uint8 [H, W, 3] bytes.
        Returns once training may proceed.
        """
        if self.conn is None:
            self.try_connect()
        while self.conn is not None:
            try:
                cam, do_training, _, _, keep_alive, scale_mod = \
                    self.receive()
                image_bytes = None
                if cam is not None:
                    image_bytes = render_fn(cam, scale_mod)
                self.send(image_bytes, source_path)
                if do_training and (not training_done or not keep_alive):
                    break
            except Exception:
                self.conn = None
