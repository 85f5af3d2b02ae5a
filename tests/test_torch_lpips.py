"""Port parity of LPIPS (grendel_tpu_torch/ops/lpips.py) and of the
metrics tool (grendel_tpu_torch/scripts/metrics.py) against grendel_tpu's,
on random VGG16 weights (no pretrained weights exist offline; equal on
random weights means the same network on pretrained ones):

  * LPIPS at 64x48 within 1e-5 relative of grendel_tpu.ops.lpips.lpips;
  * the metrics tool, end to end, on one PNG tree written by PIL: SSIM and
    PSNR within 1e-5 relative (float32 means summed in another order),
    LPIPS within 1e-4 relative, and the same JSON keys
    in both files, with and without LPIPS weights.
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import torch
from PIL import Image

from grendel_tpu.ops import lpips as jl
from grendel_tpu_torch.ops import lpips as tl
from tests.test_lpips import _random_weights


def test_lpips_matches_jax():
    rng = np.random.default_rng(1)
    a = rng.uniform(size=(3, 48, 64)).astype(np.float32)
    b = np.clip(a + rng.normal(scale=0.1, size=a.shape), 0,
                1).astype(np.float32)
    weights = _random_weights(seed=5)
    want = float(jl.lpips(jnp.asarray(a), jnp.asarray(b), weights))
    model = tl.LPIPS(weights, device="cpu")
    got = float(tl.lpips(torch.tensor(a), torch.tensor(b), model))
    assert want > 0
    np.testing.assert_allclose(got, want, rtol=1e-5)
    # a weights dict builds the module on the images' device
    assert float(tl.lpips(torch.tensor(a), torch.tensor(b), weights)) == got
    assert float(tl.lpips(torch.tensor(a), torch.tensor(a), model)) < 1e-9
    assert tl._VGG16_PLAN == jl._VGG16_PLAN and tl._TAPS == jl._TAPS
    assert not tl.lpips_available(None) and not tl.lpips_available("/nope")


def test_metrics_cli_matches_jax(tmp_path):
    from grendel_tpu_torch.scripts import metrics as t_metrics
    from scripts import metrics as j_metrics

    wpath = tmp_path / "lpips_vgg16.npz"
    np.savez(wpath, **_random_weights(seed=3))
    rng = np.random.default_rng(4)
    for split, n in (("test", 2), ("train", 3)):
        mdir = tmp_path / "model" / split / "ours_100"
        for sub in ("renders", "gt"):
            os.makedirs(mdir / sub)
        for i in range(n):
            # smooth images, so PIL's row filters vary
            img = (np.cumsum(np.cumsum(rng.integers(0, 9, (48, 64, 3)), 0),
                             1) % 256).astype(np.uint8)
            noisy = np.clip(img + rng.normal(0, 10, img.shape), 0,
                            255).astype(np.uint8)
            Image.fromarray(img).save(mdir / "gt" / f"{i:05d}.png")
            Image.fromarray(noisy).save(mdir / "renders" / f"{i:05d}.png")
    model = tmp_path / "model"

    def run(main, *extra):
        main(["-m", str(model), *extra])
        return {f"{name}_{split}": json.loads(
            (model / f"{name}_{split}.json").read_text())
            for name in ("results", "per_view") for split in ("test", "train")}

    for extra in ((), ("--lpips_weights", str(wpath))):
        want = run(j_metrics.main, *extra)
        got = run(t_metrics.main, "--device", "cpu", *extra)
        assert json.dumps(got, sort_keys=True).count(":") == json.dumps(
            want, sort_keys=True).count(":")
        for name, doc in want.items():
            assert got[name].keys() == doc.keys()
            for method, vals in doc.items():
                assert got[name][method].keys() == vals.keys()
                for metric, v in vals.items():
                    g = got[name][method][metric]
                    if v is None:
                        assert g is None
                        continue
                    tol = 1e-4 if metric == "LPIPS" else 1e-5
                    if isinstance(v, dict):
                        assert g.keys() == v.keys()
                        g, v = list(g.values()), list(v.values())
                    np.testing.assert_allclose(g, v, rtol=tol)
        lp = got["results_test"]["ours_100"]["LPIPS"]
        assert (lp is None) == (not extra)
