"""The last training flags of the port's loop and CLI, and its dataset
preload rule, on the CPU:

  * the preload rule: at the default threshold (10 GB) a small scene is
    preloaded, so both packages' one-device ``Trainer``s switch a requested
    ``local_sampling`` off, log it and the preload line, and write the
    same strategy history;
  * ``--nsys_profile`` writes a ``torch.profiler`` trace under
    ``<model_path>/trace``; ``--log_memory_summary`` and
    ``--check_cpu_memory`` write the memory line at every log interval,
    and its text is the JAX loop's for the same numbers (on the card
    fields too, with the card's counters stubbed; its peaks are the
    loop's running maxima across the ceiling's resets);
    ``--time_image_loading`` times the decode of an exported dataset;
  * the CLI's ``--detect_anomaly`` (autograd's anomaly mode) raises on a
    NaN loss (a NaN background), which trains on without it, and leaves
    the mode as it found it.
"""

import io
import json
import os
import types

import pytest
import torch

from grendel_tpu.engine.trainer import Trainer as JTrainer
from grendel_tpu_torch import testing
from grendel_tpu_torch.config import TrainConfig
from grendel_tpu_torch.engine.trainer import Trainer
from tests.test_torch_trainer_dist import jax_config

PRELOAD_RUN = dict(
    model=dict(sh_degree=1),
    dist=dict(bsz=2, local_sampling=True, save_strategy_history=True),
    opt=dict(iterations=8, densify_from_iter=100, densify_until_iter=0),
    checkpoint_iterations=[], test_iterations=[], save_iterations=[],
    log_interval=4, quiet=True)


def _small_scene():
    return testing.SyntheticScene(n_cams=6, n_test=2, width=48, height=32,
                                  n_gaussians=60, n_init_points=80, seed=4,
                                  device="cpu")


def _jax_scene(scene):
    """The same cameras, ground truth and points as grendel_tpu types."""
    from grendel_tpu.cameras import Camera as JCamera
    from grendel_tpu.data.readers import PointCloud as JPointCloud

    def cams(cs):
        return [JCamera(uid=c.uid, image_name=c.image_name, R=c.R, T=c.T,
                        fovx=c.fovx, fovy=c.fovy, width=c.width,
                        height=c.height, gt_image_u8=c.gt_image_u8)
                for c in cs]

    return types.SimpleNamespace(
        train_cameras=cams(scene.train_cameras),
        test_cameras=cams(scene.test_cameras),
        point_cloud=JPointCloud(*scene.point_cloud),
        cameras_extent=scene.cameras_extent)


def test_preload_rule_matches_jax(tmp_path, eight_devices):
    scene = _small_scene()
    jscene = _jax_scene(scene)
    logs, histories = {}, {}
    for pkg in ("jax", "port"):
        out = str(tmp_path / pkg)
        os.makedirs(out)
        log = io.StringIO()
        if pkg == "jax":
            cfg = jax_config(PRELOAD_RUN, out, d_count=1)
            tr = JTrainer(cfg, jscene, devices=eight_devices[:1],
                          log_file=log)
        else:
            cfg = testing.apply_config(TrainConfig(), dict(
                PRELOAD_RUN, model=dict(sh_degree=1, model_path=out)))
            tr = Trainer(cfg, scene, device="cpu", log_file=log)
        assert cfg.dist.preload_dataset_to_gpu_threshold == 10
        assert not cfg.dist.local_sampling
        assert not cfg.dist.distributed_dataset_storage
        assert not tr._whole_image_division
        tr.train()
        logs[pkg] = log.getvalue()
        with open(os.path.join(out, "strategy_history_ws=1.json")) as f:
            histories[pkg] = json.load(f)
    for text in logs.values():
        assert "preload_dataset_to_gpu: disabling local_sampling" in text
        assert ("preloaded 6 GT images (0.00 GB dataset) to device memory"
                in text)
    assert len(histories["port"]) == 4
    assert histories["port"] == histories["jax"]


def _memory_line(trainer_cls, self_like, it=8):
    lines = []
    self_like._log = lines.append
    trainer_cls._log_memory(self_like, it)
    return lines


def test_memory_line_matches_jax(monkeypatch):
    gib = 2 ** 30
    flags = dict(check_gpu_memory=True, check_cpu_memory=True,
                 log_memory_summary=True)
    monkeypatch.setattr("grendel_tpu.utils.timer.device_memory_stats",
                        lambda: {"bytes_in_use": 3 * gib,
                                 "peak_bytes_in_use": 5 * gib})
    want = _memory_line(JTrainer, types.SimpleNamespace(
        cfg=types.SimpleNamespace(**flags),
        _trainer_cache={0: types.SimpleNamespace(mem_bytes=7 * gib)}))
    # the loop's peaks are its running maxima across the resets of its
    # ceiling readings: the allocator's own, 4 and 6 GiB since the last
    # reset, are below the 5 and 7 GiB held from before it
    for name, v in (("memory_allocated", 3), ("max_memory_allocated", 4),
                    ("max_memory_reserved", 6)):
        monkeypatch.setattr(torch.cuda, name, lambda dev, v=v: v * gib)
    port = types.SimpleNamespace(
        cfg=types.SimpleNamespace(**flags), device=torch.device("cuda"),
        _peaks=(5 * gib, 7 * gib))
    port.peak_memory = types.MethodType(Trainer.peak_memory, port)
    got = _memory_line(Trainer, port)
    assert got == want and len(got) == 1
    assert want[0].startswith("iter 8: memory hbm_in_use=3.00GB "
                              "peak=5.00GB cpu_maxrss=")
    assert want[0].endswith(" compiled_reserved=7.00GB")


def test_cli_profile_memory_and_image_timing(tmp_path, capsys):
    from grendel_tpu_torch.scripts import export_structured_dataset, train

    data = str(tmp_path / "data")
    export_structured_dataset.main(["--out", data, "--size", "40x24",
                                    "--cams", "8", "--points", "200"])
    out = str(tmp_path / "run")
    train.main(["-s", data, "--eval", "--iterations", "8", "--bsz", "2",
                "--densify_from_iter", "100", "--test_iterations", "8",
                "--nsys_profile", "--log_memory_summary",
                "--check_cpu_memory", "--log_interval", "4",
                "--time_image_loading", "--multiprocesses_image_loading",
                "0", "--device", "cpu", "-m", out])
    assert "[timing] scene + GT decode: " in capsys.readouterr().out
    with open(os.path.join(out, "trace", "trace_rk0.json")) as f:
        assert json.load(f)["traceEvents"]
    with open(os.path.join(out, "python_ws=1_rk=0.log")) as f:
        log = f.read()
    assert f"profiler trace written to {out}/trace" in log
    mem = [ln.split("] ", 1)[1] for ln in log.splitlines()
           if ": memory " in ln]
    assert [m.split(":")[0] for m in mem] == ["iter 4", "iter 8"]
    assert all(m.split("memory ")[1].startswith("cpu_maxrss=")
               and m.endswith("GB") for m in mem)


@pytest.mark.parametrize("detect_anomaly", [False, True])
def test_detect_anomaly_raises_on_nan_loss(detect_anomaly, tmp_path,
                                           monkeypatch):
    from grendel_tpu_torch.scripts import train

    monkeypatch.setattr(Trainer, "_background",
                        lambda self, it: torch.full((3,), float("nan")))
    argv = ["--synthetic", "--synthetic_size", "48x32", "--iterations", "4",
            "--bsz", "2", "--densify_from_iter", "100", "--device", "cpu",
            "-q", "-m", str(tmp_path)] + (["--detect_anomaly"]
                                          if detect_anomaly else [])
    if detect_anomaly:
        with pytest.raises((RuntimeError, FloatingPointError)):
            train.main(argv)
    else:
        assert train.main(argv) == 0
        with open(tmp_path / "python_ws=1_rk=0.log") as f:
            assert "training done: 4 iters" in f.read()
    assert not torch.is_anomaly_enabled()
