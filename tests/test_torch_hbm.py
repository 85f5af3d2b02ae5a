"""The entry ceiling from the device's memory, against the JAX loop's:

  * ``utils/hbm.py entry_ceiling`` gives the integer that grendel_tpu's
    ``Trainer._update_hbm_ceiling`` sets (called unbound on a stub
    trainer and a stub compiled step, at 72 bytes an entry and
    ``GRENDEL_HBM_GB`` set), with the headroom above the step positive,
    zero or negative, and with a step larger than the device;
    ``device_bytes_limit`` reads ``GRENDEL_HBM_GB`` and gives None on the
    CPU without it; the ranks' minimum (``comm.all_reduce_min``) carries
    a ceiling past float32's exact integers unchanged;
  * with a device far larger than any card (``GRENDEL_HBM_GB`` 1024), the
    port's ceiling stops at ``ENTRY_CAP_MAX`` (2^31 - 2^27), where int32
    entry offsets would overflow, while the JAX loop's, on the same
    numbers and the same bytes per entry, passes 2^31 (a reference fault
    the port does not copy); the one-device loop's ceiling, its rounded
    capacities and a resumed capacity, and the ranks' agreed ceiling, all
    stay at or below the clamp, and the clamp is logged; the multi-rank
    loop counts the flat lists' bytes per entry at D > 1;
  * both packages' one-device loops, on a scene whose tile lists pass the
    2^14-entry floor of both tuners, with the same injected step bytes
    (zero headroom: the ceiling is the first capacity): both log the same
    ceiling line, neither runs a step above the ceiling, and both log the
    overflow at it instead of growing.
"""

import io
import json
import types

import pytest
import torch
import torch.distributed as dist

from grendel_tpu.engine.trainer import Trainer as JTrainer
from grendel_tpu.testing import SyntheticScene as JScene
from grendel_tpu_torch import testing
from grendel_tpu_torch.config import TrainConfig
from grendel_tpu_torch.engine.trainer import Trainer
from grendel_tpu_torch.engine.trainer_dist import MultiRankTrainer
from grendel_tpu_torch.parallel import comm
from grendel_tpu_torch.utils import hbm
from tests.test_torch_trainer_dist import jax_config, port_scene

GIB = 1 << 30
INT32_MAX = (1 << 31) - 1
CAP = 1 << 20
CEILING_LINE = "isect entry ceiling -> "
OVER_LINE = "at the HBM ceiling; dropping farthest entries"


@pytest.fixture(autouse=True, scope="module")
def _single_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("hbm_gb, step_bytes", [
    (16, 2 * GIB),                      # headroom positive
    (10, int(0.9 * 10 * GIB)),          # headroom zero
    (10, int(0.95 * 10 * GIB)),         # headroom negative
    (4, 9 * GIB),                       # the step larger than the device
], ids=["positive", "zero", "negative", "step_over_limit"])
def test_entry_ceiling_matches_jax(hbm_gb, step_bytes, monkeypatch):
    monkeypatch.setenv("GRENDEL_HBM_GB", str(hbm_gb))
    lines = []
    stub = types.SimpleNamespace(_log=lines.append,
                                 isect_capacity_ceiling=1 << 22)
    JTrainer._update_hbm_ceiling(
        stub, types.SimpleNamespace(mem_bytes=step_bytes),
        types.SimpleNamespace(isect_capacity=CAP))
    limit = hbm.device_bytes_limit("cpu")
    assert limit == hbm_gb * GIB
    got = hbm.entry_ceiling(CAP, step_bytes, limit, 72.0)
    assert got == stub.isect_capacity_ceiling
    assert lines[0].endswith(f"{CEILING_LINE}{got}")
    if 0.9 * limit <= step_bytes:
        assert got == CAP
    else:
        assert got > CAP


def test_device_bytes_limit(monkeypatch):
    monkeypatch.setenv("GRENDEL_HBM_GB", "12.5")
    assert hbm.device_bytes_limit("cpu") == int(12.5 * GIB)
    monkeypatch.delenv("GRENDEL_HBM_GB")
    assert hbm.device_bytes_limit("cpu") is None
    assert hbm.device_bytes_limit(torch.device("cpu")) is None


def test_all_reduce_min_is_exact():
    comm.init_group("cpu", rank=0, world_size=1, store=dist.HashStore())
    try:
        ceiling = (1 << 30) + 1               # float32 would round it
        low, share = comm.all_reduce_min([
            torch.tensor(ceiling, dtype=torch.int64),
            torch.tensor([0.25, -2.0])])
        assert low.dtype == torch.int64 and int(low) == ceiling
        assert share.dtype == torch.float32
        assert share.tolist() == [0.25, -2.0]
    finally:
        comm.destroy_group()


def _ceiling_stub(lines, bsz=2):
    """What Trainer._update_hbm_ceiling and _round_cap read of a loop."""
    return types.SimpleNamespace(
        device=torch.device("cpu"), _log=lines.append, hbm_readings=[],
        isect_capacity_ceiling=1 << 22,
        cfg=types.SimpleNamespace(dist=types.SimpleNamespace(bsz=bsz)),
        _bytes_per_entry=lambda: hbm.BYTES_PER_ISECT_ENTRY,
        _agreed_ceiling=lambda mine: mine)


@pytest.mark.parametrize("bsz", [1, 2, 3])
def test_ceiling_is_clamped_below_int32(bsz, monkeypatch):
    monkeypatch.setenv("GRENDEL_HBM_GB", "1024")
    step_bytes = 6 * GIB
    limit = hbm.device_bytes_limit("cpu")
    # the JAX loop's formula on the same numbers passes 2^31
    monkeypatch.setattr("grendel_tpu.utils.hbm.BYTES_PER_ISECT_ENTRY",
                        hbm.BYTES_PER_ISECT_ENTRY)
    jstub = types.SimpleNamespace(_log=lambda line: None,
                                  isect_capacity_ceiling=1 << 22)
    JTrainer._update_hbm_ceiling(
        jstub, types.SimpleNamespace(mem_bytes=step_bytes),
        types.SimpleNamespace(isect_capacity=CAP))
    unclamped = int(CAP + (0.9 * limit - step_bytes)
                    / hbm.BYTES_PER_ISECT_ENTRY)
    assert jstub.isect_capacity_ceiling == unclamped > INT32_MAX
    assert hbm.entry_ceiling(CAP, step_bytes, limit,
                             hbm.BYTES_PER_ISECT_ENTRY) == hbm.ENTRY_CAP_MAX
    # the one-device loop: its ceiling, every capacity it rounds, logged
    lines = []
    stub = _ceiling_stub(lines, bsz)
    Trainer._update_hbm_ceiling(stub, CAP, step_bytes)
    assert stub.isect_capacity_ceiling == hbm.ENTRY_CAP_MAX
    assert stub.hbm_readings == [(CAP, step_bytes, hbm.ENTRY_CAP_MAX)]
    assert lines == [
        f"compiled step reserves 6.00GB of 1024GB HBM; {CEILING_LINE}"
        f"{hbm.ENTRY_CAP_MAX}",
        f"isect entry ceiling clamped to {hbm.ENTRY_CAP_MAX}: entry "
        f"offsets are int32"]
    for target in (0.9 * hbm.ENTRY_CAP_MAX, hbm.ENTRY_CAP_MAX - 1,
                   hbm.ENTRY_CAP_MAX, 1.35 * hbm.ENTRY_CAP_MAX, 4e9, 1e12):
        assert Trainer._round_cap(stub, target) <= hbm.ENTRY_CAP_MAX
    # re-rounding the clamp (a resume) keeps it: it lies on the grid
    assert hbm.mantissa_round_cap(hbm.ENTRY_CAP_MAX, align=128 * bsz) \
        <= INT32_MAX


def test_resumed_capacity_stays_below_the_clamp(tmp_path):
    """An elastic resume scales the saved entry capacity by saved D / D and
    rounds it again; the clamp holds there too."""
    (tmp_path / "tuner.json").write_text(json.dumps(
        {"n_devices": 4, "isect_cap_current": hbm.ENTRY_CAP_MAX}))
    stub = types.SimpleNamespace(
        world=1, cfg=types.SimpleNamespace(dist=types.SimpleNamespace(bsz=2)),
        _restore_tuner=lambda saved, ratio: None, _max_alive=0,
        _log=lambda line: None)
    Trainer._restore_tuner_state(stub, str(tmp_path))
    assert stub._isect_cap_current == hbm.ENTRY_CAP_MAX


def test_ranks_agreed_ceiling_stays_below_the_clamp(monkeypatch):
    """Each rank clamps its own reading; the ranks take the smallest."""
    monkeypatch.setenv("GRENDEL_HBM_GB", "1024")
    comm.init_group("cpu", rank=0, world_size=1, store=dist.HashStore())
    try:
        lines = []
        stub = _ceiling_stub(lines)
        stub._agreed_ceiling = types.MethodType(
            MultiRankTrainer._agreed_ceiling, stub)
        Trainer._update_hbm_ceiling(stub, CAP, 6 * GIB)
        assert stub.isect_capacity_ceiling == hbm.ENTRY_CAP_MAX
        assert MultiRankTrainer._agreed_ceiling(stub, None) is None
    finally:
        comm.destroy_group()


@pytest.mark.parametrize("world, want", [
    (1, "BYTES_PER_ISECT_ENTRY"), (2, "BYTES_PER_FLAT_ENTRY"),
    (4, "BYTES_PER_FLAT_ENTRY")])
def test_multi_rank_loop_takes_its_lists_bytes_per_entry(world, want):
    """A rank at D > 1 builds the flat row-span lists and counts their
    measured bytes per entry; at world size 1 it takes the camera-blocked
    lists of the one-device loop, and their constant."""
    assert hbm.BYTES_PER_FLAT_ENTRY != hbm.BYTES_PER_ISECT_ENTRY
    rank = types.SimpleNamespace(world=world)
    assert MultiRankTrainer._bytes_per_entry(rank) == getattr(hbm, want)
    assert Trainer._bytes_per_entry(rank) == hbm.BYTES_PER_ISECT_ENTRY


# about 32,000 entries a camera at 256x192 in 16x16 tiles: past the first
# capacity (the 2^14 floor, with isect_capacity_factor 1)
def ceiling_scene():
    return JScene(n_cams=4, n_test=1, width=256, height=192,
                  n_gaussians=400, n_init_points=2500, sh_degree=1, seed=5)


RUN = dict(
    model=dict(sh_degree=1),
    dist=dict(bsz=1),
    pipeline=dict(tile_w=16, tile_h=16, isect_capacity_factor=1.0),
    opt=dict(iterations=6, densify_from_iter=1000, densify_until_iter=0),
    checkpoint_iterations=[], test_iterations=[], save_iterations=[],
    log_interval=100, quiet=True)
HBM_GB = 1
STEP_BYTES = int(0.9 * HBM_GB * GIB)        # no headroom


def test_loop_ceiling_matches_jax(tmp_path, monkeypatch, eight_devices):
    monkeypatch.setenv("GRENDEL_HBM_GB", str(HBM_GB))
    monkeypatch.setattr("grendel_tpu.utils.hbm.compiled_bytes",
                        lambda *args: STEP_BYTES)
    monkeypatch.setattr(hbm, "BYTES_PER_ISECT_ENTRY", 72.0)
    monkeypatch.setattr(Trainer, "_step_bytes", lambda self: STEP_BYTES)
    jscene = ceiling_scene()
    logs, caps, ceilings = {}, {}, {}

    # the JAX loop: the entry capacity of every compiled step it runs
    log = io.StringIO()
    jt = JTrainer(jax_config(RUN, str(tmp_path / "jax"), d_count=1), jscene,
                  devices=eight_devices[:1], log_file=log)
    j_caps = []
    get_trainer = jt._trainer

    def tapped(sh_degree):
        st = get_trainer(sh_degree)
        if not getattr(st, "_cap_tapped", False):
            real_step = st.step

            def step(*args, **kw):
                j_caps.append(st.cfg.isect_capacity)
                return real_step(*args, **kw)

            st.step, st._cap_tapped = step, True
        return st

    jt._trainer = tapped
    jt.train()
    logs["jax"], caps["jax"] = log.getvalue(), j_caps
    ceilings["jax"] = jt.isect_capacity_ceiling

    log = io.StringIO()
    cfg = testing.apply_config(TrainConfig(), dict(
        RUN, model=dict(sh_degree=1, model_path=str(tmp_path / "port"))))
    tr = Trainer(cfg, port_scene(jscene), device="cpu", log_file=log)
    t_caps, entries = [], []
    real_step = tr._step

    def step(*args):
        t_caps.append(tr._isect_cap())
        state, m = real_step(*args)
        entries.append(int(m["num_isects"][0]))
        return state, m

    tr._step = step
    tr.train()
    logs["port"], caps["port"] = log.getvalue(), t_caps
    ceilings["port"] = tr.isect_capacity_ceiling

    assert min(entries) > 1 << 14
    first = t_caps[0]
    want = hbm.entry_ceiling(first, STEP_BYTES, HBM_GB * GIB, 72.0)
    assert want == first          # no headroom: the first capacity
    assert ceilings == {"jax": want, "port": want}
    assert caps["jax"][0] == first and len(caps["jax"]) == len(t_caps) == 6
    for pkg, text in logs.items():
        lines = [ln.split("] ", 1)[1] for ln in text.splitlines()
                 if CEILING_LINE in ln]
        assert lines == [f"compiled step reserves 0.90GB of 1GB HBM; "
                         f"{CEILING_LINE}{want}"], (pkg, text)
        assert OVER_LINE in text, (pkg, text)
        assert "growing entry buffer" not in text, (pkg, text)
        assert max(caps[pkg]) <= want, pkg
    assert tr.hbm_readings == [(first, STEP_BYTES, want)]
    assert tr._memory_fraction() == pytest.approx(0.9)
