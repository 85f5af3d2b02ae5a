"""Score rendered views against their ground truth: the port's
counterpart of scripts/metrics.py.

    python -m grendel_tpu_torch.scripts.metrics -m out/run1 [out/run2 ...]

Reads the ``{test,train}/<method>/{renders,gt}/*.png`` pairs that
scripts/render.py writes and writes ``results_{split}.json`` (the mean
SSIM, PSNR and LPIPS of each method) and ``per_view_{split}.json`` (each
view's) in the model directory, under the JAX tool's keys. SSIM and PSNR
come from ops/ssim.py. LPIPS needs VGG16 weights in ops/lpips.py's
``.npz`` layout, from ``--lpips_weights`` or ``$GRENDEL_LPIPS_WEIGHTS``;
without them it is null. Runs on the card unless ``--device cpu`` is
given; the PNGs are read without PIL (utils/png.py).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="SSIM, PSNR and LPIPS of "
                                "rendered views")
    p.add_argument("--model_paths", "-m", nargs="+", required=True)
    p.add_argument("--lpips_weights", type=str,
                   default=os.environ.get("GRENDEL_LPIPS_WEIGHTS"),
                   help="npz of VGG16 LPIPS weights (ops/lpips.py); also "
                        "read from $GRENDEL_LPIPS_WEIGHTS. Absent: LPIPS "
                        "is null")
    p.add_argument("--device", type=str, default="cuda")
    a = p.parse_args(argv)

    from ..device import resolve_device
    from ..ops.ssim import psnr as psnr_fn
    from ..ops.ssim import ssim as ssim_fn
    from ..utils.png import read_png

    dev = resolve_device(a.device)
    lpips_model = None
    if a.lpips_weights:
        from ..ops.lpips import LPIPS, load_weights

        lpips_model = LPIPS(load_weights(a.lpips_weights), device=dev)
        print(f"LPIPS enabled (weights: {a.lpips_weights})")

    def load(path):
        img = read_png(path)[..., :3].astype(np.float32) / 255.0
        return torch.as_tensor(img.transpose(2, 0, 1).copy(), device=dev)

    for model_path in a.model_paths:
        print(f"Scene: {model_path}")
        for split in ("test", "train"):
            split_dir = os.path.join(model_path, split)
            if not os.path.isdir(split_dir):
                continue
            full, per_view = {}, {}
            for method in sorted(os.listdir(split_dir)):
                rdir = os.path.join(split_dir, method, "renders")
                gdir = os.path.join(split_dir, method, "gt")
                if not (os.path.isdir(rdir) and os.path.isdir(gdir)):
                    continue
                ssims, psnrs, lpipss, names = [], [], [], []
                for fn in sorted(os.listdir(rdir)):
                    gp = os.path.join(gdir, fn)
                    if not os.path.exists(gp):
                        continue
                    r, g = load(os.path.join(rdir, fn)), load(gp)
                    with torch.no_grad():
                        ssims.append(float(ssim_fn(r, g)))
                        psnrs.append(float(psnr_fn(r, g)))
                        if lpips_model is not None:
                            lpipss.append(float(lpips_model(r, g)))
                    names.append(fn)
                if not names:
                    continue
                lp_str = f"{np.mean(lpipss):.7f}" if lpipss else "n/a"
                print(f"  {split}/{method}: "
                      f"SSIM {np.mean(ssims):.7f}  PSNR {np.mean(psnrs):.7f}  "
                      f"LPIPS {lp_str} ({len(names)} views)")
                full[method] = {
                    "SSIM": float(np.mean(ssims)),
                    "PSNR": float(np.mean(psnrs)),
                    "LPIPS": float(np.mean(lpipss)) if lpipss else None,
                }
                per_view[method] = {
                    "SSIM": dict(zip(names, ssims)),
                    "PSNR": dict(zip(names, psnrs)),
                }
                if lpipss:
                    per_view[method]["LPIPS"] = dict(zip(names, lpipss))
            if full:
                for stem, obj in (("results", full), ("per_view", per_view)):
                    with open(os.path.join(model_path,
                                           f"{stem}_{split}.json"), "w") as f:
                        json.dump(obj, f, indent=2)
    return 0


if __name__ == "__main__":
    sys.exit(main())
