"""The port's viewer bridge (rain_tpu_torch/viewer/network_gui.py): the
counterpart of tests/test_viewer.py, a wire-protocol round trip over a
real socket, plus a message whose 4-byte length arrives in two sends
(rain_tpu's single ``recv(4)`` at rain_tpu/viewer/network_gui.py:47 would
mis-frame it; the port reads until all 4 bytes are there), and the
Trainer serving a viewer frame between steps. No tolerance: bytes and
matrices are compared exactly.
"""

import dataclasses
import json
import socket
import threading
import time

import numpy as np
import torch

from rain_tpu_torch import config as cfg_mod
from rain_tpu_torch.data.cameras import Camera
from rain_tpu_torch.data.dataset import SceneData
from rain_tpu_torch.train.trainer import Trainer
from rain_tpu_torch.viewer.network_gui import NetworkGUI
from test_viewer import _recv_reply, _send_msg

torch.set_num_threads(1)

W = H = 8


def _payload(**kw):
    wv = np.eye(4, dtype=np.float32)
    return dict({
        "resolution_x": W, "resolution_y": H, "train": True,
        "fov_y": 0.8, "fov_x": 0.8, "z_near": 0.01, "z_far": 100.0,
        "shs_python": False, "rot_scale_python": False,
        "keep_alive": False, "scaling_modifier": 1.0,
        "view_matrix": wv.flatten().tolist(),
        "view_projection_matrix": wv.flatten().tolist()}, **kw)


def _serve(gui, render_fn, calls, source="srcpath"):
    """Poll until one render request was served (the listener is
    non-blocking, so the first polls may find no client yet)."""
    for _ in range(200):
        gui.handle(render_fn, source, training_done=False)
        if calls:
            return
        time.sleep(0.025)
    raise AssertionError("the viewer's request was never served")


def _split_send(sock, payload):
    """The 4-byte length in two sends of 2 bytes, a pause between."""
    data = json.dumps(payload).encode("utf-8")
    head = len(data).to_bytes(4, "little")
    sock.sendall(head[:2])
    time.sleep(0.2)
    sock.sendall(head[2:])
    sock.sendall(data)


def _roundtrip(send):
    gui = NetworkGUI("127.0.0.1", 16109)
    result = {}

    def client():
        s = socket.create_connection(("127.0.0.1", gui.port), timeout=5)
        send(s, _payload())
        result["reply"] = _recv_reply(s, W * H * 3)
        # a zero-resolution message (viewer keepalive), then disconnect
        send(s, _payload(resolution_x=0, resolution_y=0))
        n = int.from_bytes(s.recv(4), "little")
        s.recv(n)
        s.close()

    t = threading.Thread(target=client)
    t.start()
    calls = []

    def render_fn(cam, scaling_modifier):
        calls.append((cam, scaling_modifier))
        return memoryview(np.full((H, W, 3), 7, np.uint8).copy())

    _serve(gui, render_fn, calls)
    gui.handle(render_fn, "srcpath", training_done=False)
    t.join(timeout=5)
    assert not t.is_alive()
    gui.listener.close()
    img, verify = result["reply"]
    assert verify == "srcpath"
    assert img == bytes(np.full((H, W, 3), 7, np.uint8))
    assert len(calls) == 1
    cam, scale = calls[0]
    assert (cam["width"], cam["height"], scale) == (W, H, 1.0)
    # the Y/Z flips, then row-vector → math convention
    flips = np.diag([1.0, -1.0, -1.0, 1.0]).astype(np.float32)
    assert np.array_equal(cam["world_view"], flips.T)
    assert np.array_equal(cam["full_proj"], np.diag(
        [1.0, -1.0, 1.0, 1.0]).astype(np.float32).T)


def test_viewer_roundtrip():
    _roundtrip(_send_msg)


def test_length_in_two_sends():
    _roundtrip(_split_send)


def test_trainer_serves_a_frame(tmp_path):
    """Trainer(viewer=...) polls the viewer before each step and renders
    the frame it asks for, whole, at the viewer's size."""
    rng = np.random.default_rng(0)
    pts = np.concatenate([rng.uniform(-1, 1, (150, 2)),
                          rng.uniform(3, 5, (150, 1))], 1).astype(np.float32)
    cam = Camera(uid=0, image_name="c0", R=np.eye(3), T=np.zeros(3),
                 fovx=0.8, fovy=0.6, width=32, height=24,
                 image=rng.uniform(0, 1, (3, 24, 32)).astype(np.float32))
    scene = SceneData([cam], [], pts, np.full((150, 3), 0.5, np.float32),
                      1.0, np.zeros(3))
    cfgs = cfg_mod.extract_all(cfg_mod.build_parser("t").parse_args([]))
    # a tier far below the frame's instances: the frame renders again
    cfgs["system"] = dataclasses.replace(cfgs["system"], max_instances=16)
    gui = NetworkGUI("127.0.0.1", 16209)
    replies = {}

    def client():
        s = socket.create_connection(("127.0.0.1", gui.port), timeout=10)
        _send_msg(s, _payload(resolution_x=32, resolution_y=24,
                              view_matrix=np.diag([1.0, -1, -1, 1])
                              .flatten().tolist(), keep_alive=True))
        replies["img"] = _recv_reply(s, 32 * 24 * 3)
        s.close()

    t = threading.Thread(target=client)
    t.start()
    logs = []
    tr = Trainer(scene, cfgs, str(tmp_path), device="cpu", viewer=gui,
                 log_fn=logs.append, tensorboard=False)
    for _ in range(200):          # wait for the client to connect
        gui.try_connect()
        if gui.conn is not None:
            break
        time.sleep(0.025)
    tr.train(2, test_iterations=(), save_iterations=())
    t.join(timeout=10)
    assert not t.is_alive()
    gui.listener.close()
    img, verify = replies["img"]
    assert verify == ""
    frame = np.frombuffer(img, np.uint8).reshape(24, 32, 3)
    assert frame.max() > 0
    assert any("viewer frame" in m and "rendered again" in m for m in logs)
    assert tr.max_instances > 16       # the step grew the tier itself
