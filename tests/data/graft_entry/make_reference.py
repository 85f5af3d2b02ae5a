"""Regenerate jax_dryrun2.json, the JAX reference of the port's graft
entry point test (tests/test_torch_graft_entry.py):

  * ``line``: the summary line that the JAX package's
    ``__graft_entry__.dryrun_multichip(2)`` prints on the 8-device CPU mesh;
  * ``keys``: every ``key=value`` of that line, parsed here;
  * ``runs``: of each of the dry run's three trainers (``main``, the
    2-device run; ``resumed``, its resume from the iteration-24
    checkpoint; ``reference``, the one-device run of the parity check),
    every densify round (``densify_history``: iteration, clone, split,
    prune, alive, dropped) and every step's (total loss, L1)
    (``losses``), recorded by a subclass of the JAX package's ``Trainer``
    put in its place for the run;
  * ``scene``: the dry run's scene (``SyntheticScene(n_cams=6, n_test=2,
    width=64, height=48, n_gaussians=120, n_init_points=100, sh_degree=1,
    seed=3)``, the one ``dryrun_multichip`` builds): the training and
    held-out camera arrays (``train_*``, ``test_*``: world_view, full_proj,
    camera_center, tanfov, uid, gt_u8), the initial ``points`` and
    ``colors`` and the ``extent``, each array as its dtype, shape and
    base64 of its bytes.

Run from the repository root, on the CPU (about 2 minutes):

    JAX_PLATFORMS=cpu python tests/data/graft_entry/make_reference.py

The JAX dry run is deterministic on the CPU: two runs print the same line,
character for character. Nothing in grendel_tpu_torch imports this file.
"""

import ast
import base64
import contextlib
import io
import json
import os
import re
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))
OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                   "jax_dryrun2.json")

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()
sys.path.insert(0, ROOT)

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 8)

import numpy as np  # noqa: E402

import __graft_entry__  # noqa: E402
from grendel_tpu.engine import trainer as jax_trainer  # noqa: E402
from grendel_tpu.testing import SyntheticScene  # noqa: E402
from grendel_tpu_torch import convert  # noqa: E402

N_DEVICES = 2


def encode(a) -> dict:
    a = np.ascontiguousarray(a)
    return {"dtype": str(a.dtype), "shape": list(a.shape),
            "b64": base64.b64encode(a.tobytes()).decode("ascii")}


class RecordedTrainer(jax_trainer.Trainer):
    """The JAX package's Trainer, keeping every trainer made and every
    step's (total loss, L1)."""
    made = []

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        RecordedTrainer.made.append(self)
        self.losses = []
        get_trainer = self._trainer

        def tapped(sh_degree):
            st = get_trainer(sh_degree)
            if not getattr(st, "_recorded", False):
                real_step = st.step

                def step(*a, **k):
                    new_state, metrics = real_step(*a, **k)
                    self.losses.append(
                        [float(jax.device_get(metrics["loss"])),
                         float(jax.device_get(metrics["l1"]))])
                    return new_state, metrics

                st.step = step
                st._recorded = True
            return st

        self._trainer = tapped


def parse(line: str) -> dict:
    """Every value of a ``dryrun_multichip`` summary line."""
    keys = {"n_devices": int(re.match(r"dryrun_multichip\((\d+)\)",
                                      line).group(1))}
    m = re.search(r"n_local=(\d+)->(\d+)", line)
    keys["n_local0"], keys["n_local"] = int(m.group(1)), int(m.group(2))
    for key, rx, cast in (
            ("iters", r"iters=(\d+)", int),
            ("n_alive", r" n_alive=(\d+)", int),
            ("rel_l1_step0", r"rel_l1_step0=(\S+)", float),
            ("max_rel_loss_diff", r"max_rel_loss_diff=(\S+)", float),
            ("dn_alive", r"dn_alive=(-?\d+)", int),
            ("dpsnr", r"dpsnr=([\d.]+)dB", float),
            ("densify_rounds", r"densify_rounds=(\d+)", int),
            ("capacity_events", r"capacity_events=(\[[^\]]*\])",
             ast.literal_eval),
            ("opacity_resets", r"opacity_resets=(\[[^\]]*\])",
             ast.literal_eval),
            ("ckpt_resume_iter", r"ckpt_resume_iter=(\d+)", int),
            ("resume_n_alive", r"resume_n_alive=(\d+)", int),
            ("resumed_to_iter", r"resumed_to_iter=(\d+)", int),
            ("a2a_send_cap", r"a2a_send_cap=(\d+)/dest", int),
            ("a2a_fwd_volume_mb", r"a2a_fwd_volume=([\d.]+)MB", float)):
        keys[key] = cast(re.search(rx, line).group(1))
    return keys


def main():
    buf = io.StringIO()
    jax_trainer.Trainer = RecordedTrainer
    with contextlib.redirect_stdout(buf):
        __graft_entry__.dryrun_multichip(N_DEVICES)
    jax_trainer.Trainer = RecordedTrainer.__base__
    runs = {role: dict(densify_history=t.densify_history, losses=t.losses)
            for role, t in zip(("main", "resumed", "reference"),
                               RecordedTrainer.made)}
    line = [s for s in buf.getvalue().splitlines()
            if s.startswith(f"dryrun_multichip({N_DEVICES})")][-1]
    print(line)
    scene = SyntheticScene(n_cams=6, n_test=2, width=64, height=48,
                           n_gaussians=120, n_init_points=100, sh_degree=1,
                           seed=3)
    arrays = {k: encode(v) for k, v in convert.scene_arrays(scene).items()
              if k != "extent"}
    ref = {"line": line, "keys": parse(line), "runs": runs,
           "jax": jax.__version__,
           "scene": dict(arrays, extent=float(scene.cameras_extent))}
    with open(OUT, "w") as f:
        json.dump(ref, f, indent=1, default=lambda v: v.item())
        f.write("\n")
    print(f"wrote {OUT}")


if __name__ == "__main__":
    main()
