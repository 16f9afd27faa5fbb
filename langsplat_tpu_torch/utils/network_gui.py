"""Remote-viewer bridge: a non-blocking TCP server speaking the SIBR viewer's protocol,
polled from the training loop.

PyTorch-port counterpart of `langsplat_tpu/utils/network_gui.py`, with the same wire
format: a message is a 4-byte little-endian length and a JSON object carrying the
resolution, fovs, near/far planes, the train / keep_alive toggles, the scaling modifier
and the view and view-projection matrices (the viewer sends them with the Y and Z
columns negated; `receive` flips them back). The reply is the frame's raw RGB bytes
(row-major, uint8) followed by a length-prefixed verify string.

Two faults of the JAX version are fixed here: a message that arrives in pieces is read
whole (`recv_exact`), and `poll` drops the viewer only on connection and protocol
errors (OSError, ConnectionError, and ValueError / KeyError from a bad message), so an
error raised by the render reaches the caller.
"""

from __future__ import annotations

import json
import socket
import time
from dataclasses import dataclass

import numpy as np
import torch


@dataclass
class MiniCam:
    """A camera the viewer sent: resolution, fovs, planes and row-vector matrices."""
    width: int
    height: int
    fovy: float
    fovx: float
    znear: float
    zfar: float
    world_view_transform: np.ndarray
    full_proj_transform: np.ndarray

    @property
    def image_width(self):
        return self.width

    @property
    def image_height(self):
        return self.height

    @property
    def tanfovx(self) -> float:
        return float(np.tan(self.fovx * 0.5))

    @property
    def tanfovy(self) -> float:
        return float(np.tan(self.fovy * 0.5))

    @property
    def camera_center(self) -> np.ndarray:
        return np.linalg.inv(self.world_view_transform)[3, :3]


def recv_exact(sock: socket.socket, n: int) -> bytes:
    """Exactly n bytes from sock, however many pieces they arrive in."""
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("the peer closed the connection")
        buf += chunk
    return bytes(buf)


def frame_bytes(image: torch.Tensor) -> memoryview:
    """[3,H,W] float image in [0,1] -> its [H,W,3] uint8 bytes: converted on the image's
    device, then one copy to the host."""
    arr = (torch.clamp(image, 0, 1) * 255).to(torch.uint8).permute(1, 2, 0).contiguous()
    return memoryview(arr.cpu().numpy())


class NetworkGUI:
    """The server: `init` binds it, `poll` serves the viewer from the training loop,
    `close` releases the sockets."""

    def __init__(self):
        self.conn = None
        self.addr = None
        self.listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self.listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)

    def init(self, host: str = "127.0.0.1", port: int = 6009) -> None:
        self.listener.bind((host, port))
        self.listener.listen()
        self.listener.settimeout(0)

    def try_connect(self, timeout: float = 0.0) -> None:
        """Accept a waiting viewer; with a timeout, wait up to that many seconds."""
        self.listener.settimeout(timeout)
        try:
            self.conn, self.addr = self.listener.accept()
            print(f"\nConnected by {self.addr}")
            self.conn.settimeout(None)
        except OSError:
            pass
        finally:
            self.listener.settimeout(0)

    def _read(self) -> dict:
        message_length = int.from_bytes(recv_exact(self.conn, 4), "little")
        return json.loads(recv_exact(self.conn, message_length).decode("utf-8"))

    def send(self, image_bytes, verify: str) -> None:
        if image_bytes is not None:
            self.conn.sendall(image_bytes)
        self.conn.sendall(len(verify).to_bytes(4, "little"))
        self.conn.sendall(bytes(verify, "ascii"))

    def receive(self):
        """-> (MiniCam | None, do_training, shs_python, rot_scale_python, keep_alive,
        scaling_modifier); a zero resolution gives a tuple of None."""
        msg = self._read()
        width = msg["resolution_x"]
        height = msg["resolution_y"]
        if width == 0 or height == 0:
            return None, None, None, None, None, None
        view = np.asarray(msg["view_matrix"], np.float32).reshape(4, 4)
        view[:, 1] = -view[:, 1]
        view[:, 2] = -view[:, 2]
        proj = np.asarray(msg["view_projection_matrix"], np.float32).reshape(4, 4)
        proj[:, 1] = -proj[:, 1]
        cam = MiniCam(width, height, msg["fov_y"], msg["fov_x"],
                      msg["z_near"], msg["z_far"], view, proj)
        return (cam, bool(msg["train"]), bool(msg["shs_python"]),
                bool(msg["rot_scale_python"]), bool(msg["keep_alive"]),
                msg["scaling_modifier"])

    def disconnect(self) -> None:
        if self.conn is not None:
            try:
                self.conn.close()
            except OSError:
                pass
        self.conn = None

    def close(self) -> None:
        self.disconnect()
        self.listener.close()

    def poll(self, render_fn, source_path: str, iteration: int,
             max_iterations: int) -> None:
        """One training-loop poll: serve viewer frames until the viewer releases the
        loop (train on, and not holding the last iteration with keep_alive).
        render_fn(MiniCam, scaling_modifier) -> [3,H,W] float tensor; what it raises
        propagates. A broken connection or a bad message drops the viewer."""
        if self.conn is None:
            self.try_connect()
        while self.conn is not None:
            try:
                cam, do_training, _, _, keep_alive, scale_mod = self.receive()
            except (OSError, ValueError, KeyError):   # ConnectionError is an OSError
                self.disconnect()
                break
            image_bytes = None if cam is None else frame_bytes(render_fn(cam, scale_mod))
            try:
                self.send(image_bytes, source_path)
            except OSError:
                self.disconnect()
                break
            if do_training and (iteration < max_iterations or not keep_alive):
                break


def viewer_packet(width: int, height: int, fov_x: float, fov_y: float, view, proj, *,
                  train: bool = True, keep_alive: bool = True,
                  scaling_modifier: float = 1.0, z_near: float = 0.01,
                  z_far: float = 100.0) -> bytes:
    """One viewer message on the wire: the length prefix and the JSON object. `view`
    and `proj` go as given, so the caller negates the Y/Z columns as the viewer does."""
    msg = {"resolution_x": width, "resolution_y": height, "train": train,
           "fov_y": fov_y, "fov_x": fov_x, "z_near": z_near, "z_far": z_far,
           "shs_python": False, "rot_scale_python": False, "keep_alive": keep_alive,
           "scaling_modifier": scaling_modifier,
           "view_matrix": np.asarray(view, np.float64).reshape(-1).tolist(),
           "view_projection_matrix": np.asarray(proj, np.float64).reshape(-1).tolist()}
    payload = json.dumps(msg).encode()
    return len(payload).to_bytes(4, "little") + payload


class ViewerClient:
    """The viewer's side of the protocol, to drive the server without the SIBR viewer:
    connects (retrying until `timeout` while the server is not yet listening), sends
    messages and reads the replies."""

    def __init__(self, host: str, port: int, timeout: float = 30.0):
        deadline = time.monotonic() + timeout
        while True:
            try:
                self.sock = socket.create_connection((host, port), timeout=timeout)
                break
            except OSError:
                if time.monotonic() > deadline:
                    raise
                time.sleep(0.02)

    def reply(self, width: int, height: int) -> tuple[bytes, str]:
        """The next reply: (the frame's width*height*3 bytes, the verify string)."""
        image = recv_exact(self.sock, width * height * 3)
        verify = recv_exact(self.sock, int.from_bytes(recv_exact(self.sock, 4), "little"))
        return image, verify.decode()

    def request(self, packet: bytes, width: int, height: int) -> tuple[bytes, str]:
        """Send one message and read its reply."""
        self.sock.sendall(packet)
        return self.reply(width, height)

    def close(self) -> None:
        self.sock.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
