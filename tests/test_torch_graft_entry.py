"""Port parity of the graft entry points: grendel_tpu_torch/graft_entry.py
against the repo's __graft_entry__.py.

  * ``entry``: JAX's ``entry()`` arguments, taken to numpy and carried over
    with convert.py, through the port's ``fn`` (the plain versions on the
    CPU), within 1e-5 of ``jax.jit(fn)(*args)``, the bound
    tests/test_torch_render.py holds on this scene; the port's flagship
    scene is testing.py's padding of its numpy draws.
  * ``dryrun_multichip``: the port's dry run on 2 gloo ranks, on JAX's dry
    run scene, held to JAX's 2-device summary line on the 8-device CPU mesh
    (tests/data/graft_entry/jax_dryrun2.json, written by make_reference.py
    beside it: a live JAX dry run takes about 112 s). The schedule's counts
    are equal; n_alive and the resumed n_alive within max(2, 2%), the bound
    JAX's own dry run holds between world sizes (__graft_entry__.py:212);
    the run's own parity against one rank at __graft_entry__.py's bounds.
    The densify threshold is JAX's, 1e-9: so far below every seen
    Gaussian's gradient that JAX's D-times-larger distributed gradients
    (ROADMAP queue 3) decide no Gaussian differently. The port draws the
    JAX package's random numbers (utils/prng.py), so the run is also held
    to JAX's run itself (make_reference.py records it): every densify
    round's counts and every step's losses.
  * No fallback: on the card the dry run takes one NCCL rank per card and
    raises when the machine has fewer.
  * The port's ici_scaling parser reads the port's line, JAX's line and
    MULTICHIP_r05.json's into the same keys.
"""

import base64
import json
import os
import re

import jax
import numpy as np
import pytest
import torch

import __graft_entry__ as jentry
from grendel_tpu_torch import convert, graft_entry, testing
from grendel_tpu_torch.cameras import camera_arrays
from grendel_tpu_torch.scripts import ici_scaling

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF = os.path.join(ROOT, "tests", "data", "graft_entry", "jax_dryrun2.json")
D = 2


def decode(d):
    return np.frombuffer(base64.b64decode(d["b64"]),
                         dtype=d["dtype"]).reshape(d["shape"]).copy()


@pytest.fixture(scope="module")
def ref():
    with open(REF) as f:
        return json.load(f)


def jax_scene(ref):
    return convert.scene_from_arrays({
        k: v if k == "extent" else decode(v)
        for k, v in ref["scene"].items()})


@pytest.fixture(scope="module")
def dryrun(ref):
    return graft_entry.dryrun_multichip(D, device="cpu", scene=jax_scene(ref))


def within_alive(got, want):
    return abs(got - want) <= max(2, 0.02 * want)


def test_entry_matches_jax():
    jfn, jargs = jentry.entry()
    want = np.asarray(jax.jit(jfn)(*jargs))
    params, alive, viewmat, full_proj, campos, tanfov = jargs
    t_params, t_alive = convert.params_from_numpy(
        {k: np.asarray(v) for k, v in params._asdict().items()},
        np.asarray(alive), "cpu")
    fn, _ = graft_entry.entry("cpu")
    got = fn(t_params, t_alive, *(torch.tensor(np.asarray(x)) for x in
                                  (viewmat, full_proj, campos, tanfov)))
    assert got.shape == want.shape == (3, 128, 160)
    assert bool(torch.isfinite(got).all())
    err = float(np.abs(got.numpy() - want).max())
    assert err <= 1e-5, err
    assert float(got.mean()) > 0.01


def test_flagship_scene_is_testings_padding():
    params, alive, cam, hw = graft_entry._flagship_scene(device="cpu")
    fields, al = testing.params_fields(
        *testing.random_gaussians(0, 300, sh_degree=3), 512)
    assert hw == (128, 160)
    for k, v in fields.items():
        assert torch.equal(getattr(params, k), torch.from_numpy(v)), k
    assert torch.equal(alive, torch.from_numpy(al))
    assert int(alive.sum()) == 300
    want = camera_arrays(testing.make_test_camera(160, 128), "cpu")
    for a, b in zip(cam, want):
        assert torch.equal(a, b)
    _, args = graft_entry.entry("cpu")
    assert all(torch.equal(a, b) for a, b in zip(args[0], params))
    assert torch.equal(args[1], alive)
    assert all(torch.equal(a, b) for a, b in zip(args[2:], cam))


def test_dryrun_scene_is_jaxs(ref):
    """The dry run's own scene (testing.SyntheticScene with the JAX
    package's draws) against JAX's dry-run scene: cameras, initial points,
    colors and extent equal; the ground truth, rendered by each package's
    renderer, equal but for a pixel or so a view one step apart (measured:
    1 value in 18,432 of the held-out views)."""
    mine = convert.scene_arrays(testing.SyntheticScene(
        **graft_entry.DRYRUN_SCENE, device="cpu"))
    theirs = ref["scene"]
    assert set(mine) == set(theirs)
    for k, v in theirs.items():
        if k == "extent":
            assert float(mine[k]) == v
            continue
        want = decode(v)
        assert mine[k].dtype == want.dtype and mine[k].shape == want.shape, k
        if k.endswith("gt_u8"):
            diff = np.abs(mine[k].astype(np.int16) - want)
            assert diff.max() <= 1 and (diff > 0).mean() < 1e-3, k
        else:
            np.testing.assert_array_equal(mine[k], want, err_msg=k)


def test_dryrun_matches_jax_line(dryrun, ref):
    j = ref["keys"]
    assert j["n_devices"] == dryrun["n_devices"] == D
    for key in ("iters", "n_local0", "n_local", "densify_rounds",
                "capacity_events", "opacity_resets", "ckpt_resume_iter",
                "resumed_to_iter", "a2a_send_cap"):
        assert dryrun[key] == j[key], (key, dryrun[key], j[key])
    assert (f"{dryrun['a2a_fwd_volume_mb']:.2f}"
            == f"{j['a2a_fwd_volume_mb']:.2f}")
    assert within_alive(dryrun["n_alive"], j["n_alive"]), (
        dryrun["n_alive"], j["n_alive"])
    assert within_alive(dryrun["resume_n_alive"], j["resume_n_alive"]), (
        dryrun["resume_n_alive"], j["resume_n_alive"])


FIELDS = ("iter", "clone", "split", "prune", "alive", "dropped")


def rounds(history):
    return [tuple(h[k] for k in FIELDS) for h in history]


def test_dryrun_densify_rounds_match_jax(dryrun, ref):
    """The port draws JAX's split noise and redistribution destinations
    (utils/prng.py), so its densify rounds are JAX's: the first four
    equal, count for count; after them float drift moves a few Gaussians
    across the clone/split or prune lines (measured: at most 7, 0.6%)."""
    mine = rounds(dryrun["densify_history"])
    theirs = rounds(ref["runs"]["main"]["densify_history"])
    assert len(mine) == len(theirs) == 6
    assert mine[:4] == theirs[:4], (mine, theirs)
    for a, b in zip(mine[4:], theirs[4:]):
        assert a[0] == b[0] and a[-1] == b[-1] == 0, (a, b)
        assert all(abs(x - y) <= max(2, 0.01 * y)
                   for x, y in zip(a[1:-1], b[1:-1])), (a, b)
    j_ref = ref["runs"]["reference"]["densify_history"][-1]["alive"]
    assert abs(dryrun["ref_n_alive"] - j_ref) <= max(2, 0.01 * j_ref), (
        dryrun["ref_n_alive"], j_ref)


def test_dryrun_losses_track_jax(dryrun, ref):
    """Every step's total loss and L1 on rank 0 against JAX's 2-device
    run's: before the first densify (4 steps) within 1e-5 relative
    (measured 7.0e-7), through the schedule within 1e-3 (measured
    5.5e-4: float drift, with the same random draws)."""
    got = np.asarray(dryrun["losses"])
    want = np.asarray(ref["runs"]["main"]["losses"])
    assert got.shape == want.shape == (24, 2)
    rel = np.abs(got - want) / np.abs(want)
    assert rel[:4].max() < 1e-5, rel[:4]
    assert rel.max() < 1e-3, rel.max(axis=1)


def test_dryrun_parity_against_one_rank(dryrun):
    assert dryrun["rel_l1_step0"] < 1e-4
    assert dryrun["max_rel_loss_diff"] < 0.1
    n_1 = dryrun["n_alive"] - dryrun["dn_alive"]
    assert within_alive(dryrun["n_alive"], n_1)
    assert dryrun["dpsnr"] < 0.3
    assert np.isfinite(dryrun["eval"]["psnr"]) and dryrun["eval"]["n"] == 2
    assert dryrun["backend"] == "gloo" and dryrun["ranks_agree"]
    assert dryrun["redistributions"] >= 1
    hist = dryrun["densify_history"]
    assert all(h["clone"] + h["split"] > 0 for h in hist)
    # 24 steps, each through the plain versions on the CPU: no launch
    assert len(dryrun["losses"]) == len(dryrun["launches"]) == 24
    assert all(v == 0 for s in dryrun["launches"] for v in s.values())
    assert dryrun["device_ms_per_step"] == [None] * D
    assert dryrun["nccl_ms_per_step"] == [None] * D


def test_summary_line_has_jax_format(dryrun, ref):
    keys = re.compile(r"([a-z_0-9]+)=")
    assert keys.findall(dryrun["line"]) == keys.findall(ref["line"])
    assert dryrun["line"].startswith(f"dryrun_multichip({D}): ok, iters=48 ")
    assert dryrun["line"] == graft_entry.summary_line(D, dryrun)


@pytest.mark.parametrize("cards, ranks", [(None, 2), (2, 3)])
def test_no_fallback_without_a_card_per_rank(monkeypatch, cards, ranks):
    if cards is not None:
        monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    have = torch.cuda.device_count()

    def no_spawn(*args, **kw):
        raise AssertionError("ranks were started")

    monkeypatch.setattr(graft_entry, "_spawn", no_spawn)
    with pytest.raises(RuntimeError, match=rf"dryrun_multichip\({ranks}\) "
                       rf"runs one NCCL rank per card and this machine has "
                       rf"{have} card"):
        graft_entry.dryrun_multichip(ranks, device="cuda")
    with pytest.raises(ValueError):
        graft_entry.dryrun_multichip(ranks, device="cuda:1")


def test_ici_scaling_parser_reads_both_packages(dryrun, ref):
    with open(os.path.join(ROOT, "MULTICHIP_r05.json")) as f:
        tail = json.load(f)["tail"].strip()
    port, jax_line, r05 = (ici_scaling.parse_line(s)
                           for s in (dryrun["line"], ref["line"], tail))
    assert set(port) == set(jax_line) == set(r05) == {
        k for k, _, _ in ici_scaling.KEYS}
    j = ref["keys"]
    assert jax_line == dict(
        send_cap=j["a2a_send_cap"], a2a_fwd_mb_dev_step=j["a2a_fwd_volume_mb"],
        n_alive=j["n_alive"], events=str(j["capacity_events"]),
        max_rel_loss_diff=j["max_rel_loss_diff"], dpsnr=j["dpsnr"])
    assert port["send_cap"] == dryrun["a2a_send_cap"]
    assert port["n_alive"] == dryrun["n_alive"]
    assert port["events"] == str(dryrun["capacity_events"])
    assert port["dpsnr"] == pytest.approx(dryrun["dpsnr"], abs=1e-4)
    assert (r05["n_alive"], r05["send_cap"], r05["dpsnr"]) == (
        5733, 1024, 0.1137)


def test_ici_scaling_sizes(monkeypatch):
    assert ici_scaling.default_sizes("cpu") == [2, 4, 8]
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert ici_scaling.default_sizes("cuda") == [2, 4]
    with pytest.raises(ValueError, match="exceed the 4 card"):
        ici_scaling.main(["--device", "cuda", "--sizes", "2", "8"])
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert ici_scaling.default_sizes("cuda") == [1]


def test_parity_miss_names_the_bound_and_keeps_the_line(dryrun):
    ref = dict(losses=dryrun["losses"], eval=dryrun["eval"],
               n_alive=dryrun["n_alive"] + 200)
    main = dict(ref, n_alive=dryrun["n_alive"])
    values, missed = graft_entry._parity(main, ref, D)
    assert values["dn_alive"] == -200 and values["dpsnr"] == 0.0
    assert missed == [f"n_alive {main['n_alive']} against {ref['n_alive']}, "
                      f"bound {0.02 * ref['n_alive']:.0f}"]
    line = graft_entry.summary_line(D, dict(dryrun, **values),
                                    f"FAILED ({missed[0]})")
    assert line.startswith(f"dryrun_multichip({D}): FAILED (n_alive ")
    assert ici_scaling.parse_line(line)["n_alive"] == dryrun["n_alive"]
    assert graft_entry._parity(main, main, D)[1] == []
