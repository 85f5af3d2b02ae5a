"""A run with the timed path broken underneath comes out not correct.
Each test skips the look for a chip, plants one fault in the program
where its result is produced, and drives the rest of a run of a tiny
copy of the cell. The faults a cell can have: a step that returns its
state unchanged, half of the batch left out with the mean taken over the
rest (bsz > 1), an answer altered where it is produced; in the loop
also a densify round that leaves the state unchanged, and one whose new
Gaussians are altered. No cell runs on more than one chip, so none has an
exchange between chips to leave out."""

import time

import pytest
import torch

from gsbench import run
from gsbench.tests.tiny import CELLS, tiny_copy


def run_tiny(tmp_path, cell):
    base = tiny_copy(tmp_path)
    # long enough on the CPU for the viewer to reach every sampled pose
    return run.run_cell(cell, 21, 2.0, False, torch.device("cpu"),
                        time.perf_counter(), base=base)


def unchanged(real):
    def step(state, *args, **kw):
        _, metrics = real(state, *args, **kw)
        return state, metrics
    return step


def half_batch(real):
    def step(state, cams, gt, bg, cfg, sh, bsz, *args, **kw):
        h = bsz // 2
        cams = type(cams)(*(x[:h] for x in cams))
        return real(state, cams, gt[:h], bg, cfg, sh, h, *args, **kw)
    return step


def altered_images(real):
    """The rendered images wrong by 0.1 over their top quarter."""
    def render(*args, **kw):
        img, splats, aux = real(*args, **kw)
        img = img.clone()
        img[..., :img.shape[-2] // 4, :] += 0.1
        return img, splats, aux
    return render


def round_unchanged(real):
    """A densify round that reports its counts and leaves the state as it
    was."""
    def densify(params, alive, adam, stats, *args, **kw):
        info = real(params, alive, adam, stats, *args, **kw)[-1]
        return params, alive, adam, stats, info
    return densify


def round_altered(real):
    """A densify round whose new Gaussians sit 0.01 off in x."""
    def densify(params, alive, *args, **kw):
        out, alive_new, *rest = real(params, alive, *args, **kw)
        new = (alive_new & ~alive)[:, None]
        shift = torch.tensor([0.01, 0.0, 0.0], device=alive.device)
        means = torch.where(new, out.means3d + shift, out.means3d)
        return (out._replace(means3d=means), alive_new, *rest)
    return densify


TRAIN = "grendel_tpu_torch.engine.train"
LOOP = "grendel_tpu_torch.engine.trainer"
RENDER = "grendel_tpu_torch.engine.render"
FAULTS = [
    ("garden4k-train", TRAIN, "train_step", unchanged),
    ("garden4k-train", TRAIN, "render_batch", altered_images),
    ("truck1k-loop", LOOP, "train_step", unchanged),
    ("truck1k-loop", LOOP, "train_step", half_batch),
    ("truck1k-loop", TRAIN, "render_batch", altered_images),
    ("truck1k-loop", LOOP, "densify_and_prune", round_unchanged),
    ("truck1k-loop", LOOP, "densify_and_prune", round_altered),
    ("garden4k-render", RENDER, "render_batch", altered_images),
]


def test_every_cell_is_covered():
    assert {f[0] for f in FAULTS} == set(CELLS)


@pytest.mark.parametrize("cell,module,name,fault", FAULTS,
                         ids=[f"{c}-{f.__name__}" for c, _, _, f in FAULTS])
def test_fault_is_not_correct(cell, module, name, fault, tmp_path,
                              monkeypatch):
    import importlib

    mod = importlib.import_module(module)
    monkeypatch.setattr(mod, name, fault(getattr(mod, name)))
    res = run_tiny(tmp_path, cell)
    assert not res["correct"], res["limits"]


@pytest.mark.parametrize("cell", sorted({f[0] for f in FAULTS}))
def test_sound_run_is_correct(cell, tmp_path):
    res = run_tiny(tmp_path, cell)
    assert res["correct"], res["limits"]
    assert res["attempted"] > 0 and res["failed"] == 0
