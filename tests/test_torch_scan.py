"""Port parity: the inclusive int32 scan (kernel K3's plain version and its
wrapper's CPU path) against grendel_tpu's Pallas scan in interpret mode and
against jnp.cumsum. Integer adds are exact, so the results must be
bit-equal. Lengths stay within two 32768-element Pallas blocks to keep
interpret mode cheap, and are not multiples of the block."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from grendel_tpu.ops.scan_pallas import cumsum_i32_multi as j_scan
from grendel_tpu_torch.ops import scan_cuda


@pytest.fixture(autouse=True, scope="module")
def _single_torch_thread():
    """Parallel test workers share the cores; torch's spinning intra-op
    threads would then slow every test on the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _channels(c, m, seed):
    rng = np.random.default_rng(seed)
    # counts and signed scatter deltas, as the tile-list build scans
    return [rng.integers(-2000, 5000, m).astype(np.int32) for _ in range(c)]


@pytest.mark.parametrize("c,m", [(1, 40_000), (3, 1_237), (4, 65_535)])
def test_scan_matches_pallas_and_jnp(c, m):
    xs = _channels(c, m, seed=c * 7 + m)
    plain = scan_cuda.cumsum_i32_multi_plain([torch.tensor(x) for x in xs])
    wrapped = scan_cuda.cumsum_i32_multi([torch.tensor(x) for x in xs])
    pallas = j_scan([jnp.asarray(x) for x in xs], interpret=True)
    for x, p, w, j in zip(xs, plain, wrapped, pallas):
        assert p.dtype == w.dtype == torch.int32
        np.testing.assert_array_equal(p.numpy(), np.asarray(j))
        np.testing.assert_array_equal(w.numpy(), np.asarray(j))
        np.testing.assert_array_equal(p.numpy(), np.asarray(jnp.cumsum(x)))


def test_scan_single_channel_and_input_checks():
    x = np.arange(-50, 77, dtype=np.int64)
    np.testing.assert_array_equal(scan_cuda.cumsum_i32(torch.tensor(x)).numpy(),
                                  np.cumsum(x).astype(np.int32))
    assert scan_cuda.cumsum_i32(torch.zeros(0, dtype=torch.int32)).shape == (0,)
    with pytest.raises(ValueError):
        scan_cuda.cumsum_i32_multi([torch.zeros(4), torch.zeros(5)])
    with pytest.raises(ValueError):
        scan_cuda.cumsum_i32_multi([])
    with pytest.raises(ValueError):
        scan_cuda.cumsum_i32_multi([torch.zeros(3)] * (scan_cuda.MAX_CHANNELS + 1))


def test_wrappers_refuse_devices_without_a_kernel():
    meta = torch.zeros(8, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no scan kernel"):
        scan_cuda.cumsum_i32_multi([meta])
    from grendel_tpu_torch.ops.rasterize_cuda import rasterize_slots_fwd

    z = lambda *s, dt=torch.float32: torch.zeros(*s, dtype=dt, device="meta")
    with pytest.raises(ValueError, match="no blend kernel"):
        rasterize_slots_fwd(z(4, 2), z(4, 3), z(4, 3), z(4), z(8, dt=torch.int32),
                            z(3, dt=torch.int32), z(2, dt=torch.int32),
                            z(2, dt=torch.int32), 16, 16, 64)


def test_kernel_build_is_keyed_and_needs_nvcc(monkeypatch):
    from grendel_tpu_torch import kernels

    path = kernels.library_path("scan")
    assert path.parent == kernels.BUILD_DIR and path.suffix == ".so"
    assert path != kernels.library_path("rasterize_fwd")
    monkeypatch.setattr(kernels.shutil, "which", lambda name: None)
    monkeypatch.setattr(kernels.os.path, "exists", lambda p: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        kernels.nvcc_path()
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        kernels.check(700, "test launch")
    kernels.check(0, "test launch")
