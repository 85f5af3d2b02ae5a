"""Dynamic tile-row workload division (pixel-parallelism load balancer).

Counterpart of grendel_tpu/parallel/division.py, numpy with the same
outputs. Host-side planner after the reference's
gaussian_renderer/workload_division.py live path (SURVEY.md §2.2): the
unit of partition is a row of tiles; the tile rows of all ``bsz`` images
are flattened into one global row axis of length ``bsz * tiles_y`` (row =
cam * tiles_y + ty) and split into ``D`` contiguous chunks of
approximately equal heuristic mass via prefix-sum + searchsorted (ref:
division_pos_heuristic, workload_division.py:75-94). Per-camera heuristics are EMA-updated from
measured per-row costs (ref: DivisionStrategyHistoryFinal,
workload_division.py:806-849, with --heuristic_decay).

Where the reference uses measured per-GPU kernel times spread uniformly
over owned rows (workload_division.py:980-998), we use the *exact per-row
intersection-entry counts* the device step reports — the deterministic
quantity those times are a proxy for (SURVEY.md §7 "load balancing without
device-side timers").

All numpy, runs on host between steps; the resulting ``division_pos``
(D+1 int32) and sliced GT rows are data inputs to the distributed step
(parallel/sharded.py).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from ..cameras import Camera


def divide_rows(
    heuristic: np.ndarray,   # (total_rows,) positive per-row cost
    n_devices: int,
    max_rows_per_device: int,
    rows_per_image: int = 0,
    border_coeff: float = 0.0,
) -> np.ndarray:
    """Split rows into D contiguous chunks of ~equal mass.

    Returns division_pos (D+1,) int32 with pos[0]=0, pos[D]=total_rows,
    each span <= max_rows_per_device (capacity of the static row buffer).

    With ``rows_per_image`` and ``border_coeff`` > 0, interior division
    points within ``border_coeff`` rows of an image boundary snap TO the
    boundary (ref --border_divpos_coeff, workload_division.py:889-906:
    a sliver of an image on a device costs a whole extra kernel launch /
    GT slice for negligible balancing gain).
    """
    total = heuristic.shape[0]
    assert n_devices * max_rows_per_device >= total, (
        f"row capacity too small: {n_devices} x {max_rows_per_device} < {total}"
    )
    h = np.maximum(np.asarray(heuristic, np.float64), 1e-8)
    cum = np.cumsum(h)
    targets = cum[-1] * np.arange(1, n_devices) / n_devices
    # smallest p such that the first p rows carry >= target mass
    pos = np.searchsorted(cum, targets, side="left").astype(np.int64) + 1
    pos = np.concatenate([[0], np.minimum(pos, total), [total]])
    if rows_per_image > 0 and border_coeff > 0:
        for i in range(1, n_devices):
            r = pos[i] % rows_per_image
            if r != 0 and r + border_coeff >= rows_per_image:
                pos[i] = min(pos[i] - r + rows_per_image, total)
            elif r != 0 and r - border_coeff <= 0:
                pos[i] = pos[i] - r
    # enforce monotonicity and the per-device row cap
    for i in range(1, n_devices + 1):
        pos[i] = max(pos[i], pos[i - 1])
        if pos[i] - pos[i - 1] > max_rows_per_device:
            pos[i] = pos[i - 1] + max_rows_per_device
    # make sure the tail still covers all rows (push back from the right)
    pos[n_devices] = total
    for i in range(n_devices - 1, 0, -1):
        if pos[i + 1] - pos[i] > max_rows_per_device:
            pos[i] = pos[i + 1] - max_rows_per_device
        pos[i] = max(pos[i], 0)
    for i in range(1, n_devices + 1):
        assert 0 <= pos[i] - pos[i - 1] <= max_rows_per_device, pos
    return pos.astype(np.int32)


def rows_of_device(division_pos: np.ndarray, d: int) -> range:
    return range(int(division_pos[d]), int(division_pos[d + 1]))


def divide_rows_whole_images(
    bsz: int, tiles_y: int, n_devices: int
) -> np.ndarray:
    """Division at whole-image boundaries: camera i is rendered entirely by
    device i * D // bsz (no pixel parallelism within an image).

    This is the reference's --local_sampling division (camera idx //
    (bsz/ws) when bsz % ws == 0, workload_division.py:858-877) and our
    realization of --image_distribution=False with other axes kept (the
    reference's live path asserts that combination out on multi-GPU,
    gaussian_renderer/__init__.py:895-897 — whole-image assignment is its
    natural meaning). Devices beyond bsz get empty spans when bsz < D.
    """
    cams = np.minimum(
        np.arange(n_devices + 1, dtype=np.int64) * bsz // n_devices, bsz)
    # when bsz >= D make the assignment i*D//bsz-consistent: contiguous
    # near-equal camera chunks, exactly bsz/D each when divisible
    return (cams * tiles_y).astype(np.int32)


class DivisionHistory:
    """Per-camera-uid EMA of per-tile-row cost (ref:
    DivisionStrategyHistoryFinal, workload_division.py:806-849)."""

    def __init__(self, tiles_y: int, decay: float = 0.0):
        self.tiles_y = tiles_y
        self.decay = decay
        self._h: Dict[int, np.ndarray] = {}

    def heuristic_for(self, cams: Sequence[Camera]) -> np.ndarray:
        """Concatenated (bsz * tiles_y,) heuristic for a camera batch.
        Unseen cameras get uniform cost."""
        parts = []
        for c in cams:
            parts.append(self._h.get(c.uid, np.ones(self.tiles_y)))
        return np.concatenate(parts)

    def update(
        self,
        cams: Sequence[Camera],
        division_pos: np.ndarray,
        per_device_row_costs: np.ndarray,  # (D, max_rows) measured costs
    ) -> None:
        """Fold measured per-row costs back into per-camera heuristics."""
        total = len(cams) * self.tiles_y
        flat = np.zeros(total)
        d_count = division_pos.shape[0] - 1
        for d in range(d_count):
            lo, hi = int(division_pos[d]), int(division_pos[d + 1])
            n = hi - lo
            if n > 0:
                flat[lo:hi] = per_device_row_costs[d, :n]
        flat = np.maximum(flat, 1e-8)
        for b, c in enumerate(cams):
            new = flat[b * self.tiles_y:(b + 1) * self.tiles_y]
            if self.decay > 0.0 and c.uid in self._h:
                self._h[c.uid] = self.decay * self._h[c.uid] + (1 - self.decay) * new
            else:
                self._h[c.uid] = new.copy()


def pack_gt_rows(
    cams: Sequence[Camera],
    division_pos: np.ndarray,
    n_devices: int,
    max_rows: int,
    tile_h: int,
    img_h: int,
    img_w: int,
    gt_override: Optional[List[np.ndarray]] = None,
    out: Optional[np.ndarray] = None,
) -> np.ndarray:
    """Slice each device's GT tile rows into a (D, max_rows, 3, tile_h, W)
    uint8 buffer (the reference's row-span GT upload,
    loss_distribution.py:2395-2533). Rows beyond [lo, hi) or beyond the
    image bottom are zero; the device step masks them out. Each camera's
    image comes from ``Camera.gt()``, once, and only for cameras with rows
    in the spans, so a lazily stored camera decodes only where its rows
    are packed. ``out``, where given, is the buffer filled (a pinned
    staging buffer's view), else a new one."""
    tiles_y = -(-img_h // tile_h)
    if out is None:
        out = np.zeros((n_devices, max_rows, 3, tile_h, img_w), np.uint8)
    else:
        out.fill(0)
    images: Dict[int, Optional[np.ndarray]] = {}
    for d in range(n_devices):
        lo, hi = int(division_pos[d]), int(division_pos[d + 1])
        for slot, row in enumerate(range(lo, hi)):
            if slot >= max_rows:
                break
            b, ty = divmod(row, tiles_y)
            if b not in images:
                images[b] = (gt_override[b] if gt_override is not None
                             else cams[b].gt())
            img = images[b]
            if img is None:
                continue
            y0 = ty * tile_h
            y1 = min(y0 + tile_h, img_h)
            out[d, slot, :, : y1 - y0, :] = img[:, y0:y1, :]
    return out
