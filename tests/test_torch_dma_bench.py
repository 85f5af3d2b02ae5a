"""The DMA microbenchmark's plain versions (of kernels K4 and K5) against
numpy, and the microbenchmark's CLI on the CPU.

The JAX script's kernels write placeholders, so there is no JAX output to
compare with: the port's kernels fold what they load into per-chunk
checksums, the wrap-around int32 sum of the float32 bit patterns, and
these tests hold the plain versions (which the kernels are held to
bit for bit on the card) to a numpy computation of the same checksums,
exactly.
"""

import json

import numpy as np
import pytest
import torch

from grendel_tpu_torch.ops import dma_bench as D
from grendel_tpu_torch.scripts import microbench_dma as M


@pytest.fixture(autouse=True, scope="module")
def _single_torch_thread():
    """Parallel test workers share the cores; torch's spinning intra-op
    threads would then slow every test on the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np_wrap_sum(words: np.ndarray) -> np.ndarray:
    """Row sums of int32 words modulo 2^32, as int32."""
    return (words.astype(np.int64).sum(axis=1) % 2 ** 32).astype(
        np.uint32).view(np.int32)


def _np_scattered(table, ids, vpu_iters):
    n = table.shape[0]
    valid = (ids >= 0) & (ids < n)
    rows = np.where(valid[:, None], table[np.clip(ids, 0, n - 1)],
                    np.float32(0.0)).astype(np.float32)
    for _ in range(vpu_iters):
        rows = rows * np.float32(1.000001) + np.float32(0.5)
    return _np_wrap_sum(rows.view(np.int32).reshape(-1,
                                                     128 * table.shape[1]))


@pytest.mark.parametrize("n_chunks", [1, 7, 64])
def test_contig_plain_matches_numpy(n_chunks):
    rng = np.random.default_rng(n_chunks)
    src = rng.normal(size=(n_chunks, 16, 128)).astype(np.float32)
    want = _np_wrap_sum(src.view(np.int32).reshape(n_chunks, -1))
    got = D.contig_checksum_plain(torch.from_numpy(src))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    # the wrapper takes the plain version for a CPU tensor
    np.testing.assert_array_equal(
        D.contig_checksum(torch.from_numpy(src)).numpy(), want)
    # the sum wraps: large words do overflow int32
    assert np.abs(src.view(np.int32).astype(np.int64).sum(1)).max() > 2 ** 31


@pytest.mark.parametrize("width,vpu_iters", [(16, 0), (16, 24), (128, 0),
                                             (128, 3)])
def test_scattered_plain_matches_numpy(width, vpu_iters):
    rng = np.random.default_rng(width + vpu_iters)
    table = rng.normal(size=(300, width)).astype(np.float32)
    ids = rng.integers(0, 300, 5 * 128).astype(np.int32)
    ids[[3, 200]] = [-1, 300]              # out of range: a row of zeros
    want = _np_scattered(table, ids, vpu_iters)
    got = D.scattered_checksum(torch.from_numpy(table), torch.from_numpy(ids),
                               vpu_iters)
    assert got.dtype == torch.int32 and got.shape == (5,)
    np.testing.assert_array_equal(got.numpy(), want)
    # the checksum sees every row: a changed row changes its chunk only
    table2 = table.copy()
    table2[ids[130]] += 1.0
    got2 = D.scattered_checksum_plain(torch.from_numpy(table2),
                                      torch.from_numpy(ids), vpu_iters)
    expect = np.zeros(5, bool)
    expect[np.nonzero(ids == ids[130])[0] // 128] = True
    assert expect[1]
    np.testing.assert_array_equal(got2.numpy() != want, expect)


def test_wrappers_refuse_bad_inputs():
    t = torch.zeros(10, 16)
    with pytest.raises(ValueError, match="W in"):
        D.scattered_checksum(torch.zeros(10, 32), torch.zeros(128,
                                                              dtype=torch.int32))
    with pytest.raises(ValueError, match="divisible"):
        D.scattered_checksum(t, torch.zeros(100, dtype=torch.int32))
    with pytest.raises(ValueError, match="int32"):
        D.scattered_checksum(t, torch.zeros(128, dtype=torch.int64))
    with pytest.raises(ValueError, match="vpu_iters"):
        D.scattered_checksum(t, torch.zeros(128, dtype=torch.int32), -1)
    with pytest.raises(ValueError, match="16, 128"):
        D.contig_checksum(torch.zeros(2, 8, 128))


def test_microbench_cli_on_cpu(capsys):
    assert M.main(["--device", "cpu", "--n", "1000", "--cap", "1000",
                   "--steps", "2", "--vpu_iters", "4",
                   "--row_width", "128"]) == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert res["device"] == "cpu" and res["row_width"] == 128
    assert res["rows"] == 896                 # whole chunks of 128 ids
    table, ids, _ = M.make_inputs(1000, 1000, 128, "cpu")
    assert res["distinct_rows"] == len(np.unique(ids.numpy())) < 896
    assert res["checksum_max_abs_err"] == {"dma_contig": 0,
                                           "dma_scattered": 0}
    for m in M.MODES:
        assert res[f"{m}_ns_per_row"] > 0
        assert res[f"{m}_ns_per_row"] == pytest.approx(
            res[f"{m}_ms"] * 1e6 / 896)
    # the defaults are the JAX script's
    a = M.build_parser().parse_args([])
    assert (a.n, a.cap, a.steps, a.vpu_iters, a.row_width, a.device) == (
        262_144, 1_048_576, 20, 24, 16, "cuda")


def test_microbench_checks_every_mode_against_plain(monkeypatch):
    table, ids, src = M.make_inputs(500, 512, 16, "cpu", seed=1)
    assert M.check_checksums(table, ids, src, 5) == {"dma_contig": 0,
                                                     "dma_scattered": 0}
    # a kernel that disagrees with its plain version fails the check
    monkeypatch.setattr(D, "scattered_checksum",
                        lambda t, i, v=0: D.scattered_checksum_plain(
                            t, i, v) + 1)
    with pytest.raises(RuntimeError, match="differ"):
        M.check_checksums(table, ids, src, 5)
