"""SIBR remote-viewer socket endpoint.

The port's own copy of grendel_tpu/viewer/network_gui.py, on the wire
protocol of the reference's network_gui
(gaussian_renderer/network_gui.py:27-111): a TCP listener; each request
is a 4-byte little-endian length followed by a JSON message carrying the
resolution, the field of view, near and far, the view and
view-projection matrices (with SIBR's y/z column signs flipped) and the
training-control flags; the answer is the raw image bytes followed by a
length-prefixed verification string.

The caller renders with its own pipeline and passes back an (H, W, 3)
uint8 image (a tensor on any device, or a numpy array). The training loop
does not call it, as the reference's does not.
"""

from __future__ import annotations

import json
import socket
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch


@dataclass
class ViewerRequest:
    width: int
    height: int
    fovx: float
    fovy: float
    znear: float
    zfar: float
    world_view: np.ndarray        # (4, 4) after SIBR sign conversion
    full_proj: np.ndarray         # (4, 4)
    do_training: bool
    keep_alive: bool
    scaling_modifier: float


class NetworkGUI:
    def __init__(self, host: str = "127.0.0.1", port: int = 6009):
        self.listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self.listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self.listener.bind((host, port))
        self.listener.listen()
        self.listener.settimeout(0)
        self.conn: Optional[socket.socket] = None

    def try_connect(self) -> bool:
        if self.conn is not None:
            return True
        try:
            self.conn, _ = self.listener.accept()
            self.conn.settimeout(None)
            return True
        except (BlockingIOError, socket.timeout):
            return False

    def _read_exact(self, n: int) -> bytes:
        buf = b""
        while len(buf) < n:
            part = self.conn.recv(n - len(buf))
            if not part:
                raise ConnectionError("viewer disconnected")
            buf += part
        return buf

    def receive(self) -> Optional[ViewerRequest]:
        """Read one request; None if the viewer sent a zero resolution."""
        length = int.from_bytes(self._read_exact(4), "little")
        msg = json.loads(self._read_exact(length).decode("utf-8"))
        w, h = msg["resolution_x"], msg["resolution_y"]
        if w == 0 or h == 0:
            return None
        view = np.array(msg["view_matrix"], np.float32).reshape(4, 4)
        proj = np.array(msg["view_projection_matrix"], np.float32).reshape(4, 4)
        # SIBR -> 3DGS convention: flip y and z columns
        view[:, 1] *= -1
        view[:, 2] *= -1
        proj[:, 1] *= -1
        proj[:, 2] *= -1
        return ViewerRequest(
            width=w, height=h,
            fovx=msg["fov_x"], fovy=msg["fov_y"],
            znear=msg["z_near"], zfar=msg["z_far"],
            world_view=view, full_proj=proj,
            do_training=bool(msg["train"]),
            keep_alive=bool(msg["keep_alive"]),
            scaling_modifier=float(msg["scaling_modifier"]),
        )

    def send(self, image_u8: Optional[np.ndarray], verify: str) -> None:
        """Send a rendered (H, W, 3) uint8 image + verification string."""
        if isinstance(image_u8, torch.Tensor):
            image_u8 = image_u8.detach().cpu().numpy()
        if image_u8 is not None:
            self.conn.sendall(np.ascontiguousarray(image_u8).tobytes())
        self.conn.sendall(len(verify).to_bytes(4, "little"))
        self.conn.sendall(verify.encode("ascii"))

    def disconnect(self) -> None:
        if self.conn is not None:
            try:
                self.conn.close()
            finally:
                self.conn = None

    def close(self) -> None:
        self.disconnect()
        self.listener.close()
