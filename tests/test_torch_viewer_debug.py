"""Port parity of the SIBR viewer endpoint (grendel_tpu_torch/viewer) and
the debug dumps (grendel_tpu_torch/utils/debug.py) against grendel_tpu's:

  * a loopback client sends one framed request to each package's
    ``NetworkGUI``: both parse it to equal ``ViewerRequest``s (y and z
    columns of both matrices flipped), and the client reads back the image
    and the verification string each sends;
  * the dumps of the same array (a tensor for the port, a JAX array for
    grendel_tpu) are byte-equal files, and ``compare_txt_dumps`` gives
    equal counts.
"""

import dataclasses
import json
import socket

import jax.numpy as jnp
import numpy as np
import torch

from grendel_tpu.utils import debug as j_debug
from grendel_tpu.viewer import NetworkGUI as JGUI
from grendel_tpu_torch.utils import debug as t_debug
from grendel_tpu_torch.viewer import NetworkGUI as TGUI


def _message(rng):
    return {"resolution_x": 6, "resolution_y": 4, "fov_x": 0.9,
            "fov_y": 0.7, "z_near": 0.01, "z_far": 100.0,
            "view_matrix": rng.normal(size=16).tolist(),
            "view_projection_matrix": rng.normal(size=16).tolist(),
            "train": 1, "keep_alive": 0, "scaling_modifier": 1.0}


def _read(sock, n):
    buf = b""
    while len(buf) < n:
        part = sock.recv(n - len(buf))
        assert part, "server closed"
        buf += part
    return buf


def _serve(gui_cls, msg, image):
    gui = gui_cls("127.0.0.1", 0)
    port = gui.listener.getsockname()[1]
    try:
        with socket.create_connection(("127.0.0.1", port), timeout=10) as c:
            for _ in range(1000):
                if gui.try_connect():
                    break
            payload = json.dumps(msg).encode("utf-8")
            c.sendall(len(payload).to_bytes(4, "little") + payload)
            req = gui.receive()
            gui.send(image, "verify-me")
            pixels = _read(c, 4 * 6 * 3)
            n = int.from_bytes(_read(c, 4), "little")
            verify = _read(c, n).decode("ascii")
    finally:
        gui.close()
    return req, pixels, verify


def test_viewer_request_matches_jax():
    rng = np.random.default_rng(0)
    msg = _message(rng)
    image = rng.integers(0, 255, (4, 6, 3), dtype=np.uint8)
    j_req, j_px, j_ver = _serve(JGUI, msg, image)
    t_req, t_px, t_ver = _serve(TGUI, msg, torch.as_tensor(image))
    assert j_px == t_px == image.tobytes() and j_ver == t_ver == "verify-me"
    for f in dataclasses.fields(j_req):
        a, b = getattr(t_req, f.name), getattr(j_req, f.name)
        if isinstance(b, np.ndarray):
            np.testing.assert_array_equal(a, b)
            assert a.dtype == b.dtype
        else:
            assert a == b and type(a) is type(b), f.name
    view = np.array(msg["view_matrix"], np.float32).reshape(4, 4)
    np.testing.assert_array_equal(t_req.world_view[:, 1], -view[:, 1])


def test_debug_dumps_match_jax(tmp_path):
    rng = np.random.default_rng(1)
    img = rng.uniform(size=(3, 5, 7)).astype(np.float32)
    mask = rng.uniform(size=(5, 7)) > 0.5
    arr = rng.normal(size=(4, 3)).astype(np.float32)
    for pkg, conv in (("jax", jnp.asarray), ("port", torch.as_tensor)):
        mod = j_debug if pkg == "jax" else t_debug
        mod.save_image_txt(str(tmp_path / pkg / "img.txt"), conv(img))
        mod.save_mask_txt(str(tmp_path / pkg / "mask.txt"), conv(mask))
        mod.save_array_txt(str(tmp_path / pkg / "arr.txt"), conv(arr),
                           precision=4)
        bumped = img.copy()
        bumped[1, 2, 3] += 1e-3
        bumped[0, 4, 6] += 1e-7
        mod.save_image_txt(str(tmp_path / pkg / "img2.txt"), conv(bumped))
    for name in ("img.txt", "mask.txt", "arr.txt", "img2.txt"):
        assert ((tmp_path / "port" / name).read_bytes()
                == (tmp_path / "jax" / name).read_bytes()), name
    counts = [mod.compare_txt_dumps(str(tmp_path / pkg / "img.txt"),
                                    str(tmp_path / pkg / "img2.txt"))
              for mod, pkg in ((j_debug, "jax"), (t_debug, "port"))]
    assert counts == [1, 1]
