"""The bookkeeping of kernel K3's scratch (ops/scan_cuda.py ScanScratch),
which runs on the host and so without a card: the status words and the
ticket counter are allocated once per device and stream and reused, grow
when a launch needs more blocks, carry a ticket base that wraps with the
kernel's uint32 counter, and are cleared only when the epoch wraps."""

import torch

from grendel_tpu_torch.ops import scan_cuda


def _scratch():
    made = []

    def alloc(n):
        made.append(n)
        return torch.zeros(n, dtype=torch.int64)

    return scan_cuda.ScanScratch(alloc), made


def test_scan_scratch_grows_and_is_reused_across_calls():
    """The status words and the ticket counter are allocated once and
    reused; a launch of more blocks than there are status words gets a
    new, zeroed array whose counter starts again at 0."""
    scratch, made = _scratch()
    words, base, epoch = scratch.reserve(3)
    assert made == [257] and words.numel() == 257    # counter + 256 words
    assert (base, epoch) == (0, 1)
    scratch.issued(3)
    for k in range(2, 6):
        w, base, epoch = scratch.reserve(200)
        assert w is words and (base, epoch) == (3 + 200 * (k - 2), k)
        scratch.issued(200)
    words[0] = 803            # the device counter, as the kernel left it
    w, base, epoch = scratch.reserve(300)
    assert made == [257, 513] and w.numel() == 513 and (base, epoch) == (0, 1)
    assert int(w.abs().sum()) == 0


def test_scan_scratch_ticket_base_wraps_with_the_uint32_counter():
    scratch, _ = _scratch()
    scratch.reserve(10)
    scratch.tickets = (1 << 32) - 4
    scratch.issued(10)
    assert scratch.reserve(10)[1] == 6


def test_scan_scratch_epoch_wraps_and_clears_the_status_words():
    """Epochs run 1 .. EPOCH_MAX; the call after EPOCH_MAX zeroes the
    status words (not the counter) and starts again at 1, so no word
    left from an earlier epoch can pass for this call's."""
    scratch, made = _scratch()
    words, _, _ = scratch.reserve(4)
    scratch.epoch = scan_cuda.EPOCH_MAX - 1
    words[0], words[1:5] = 40, 7
    assert scratch.reserve(4)[2] == scan_cuda.EPOCH_MAX
    assert int(words[1]) == 7                         # not cleared yet
    w, _, epoch = scratch.reserve(4)
    assert w is words and epoch == 1 and made == [257]
    assert int(words[0]) == 40 and int(words[1:].abs().sum()) == 0
    assert scratch.reserve(4)[2] == 2
    assert scan_cuda.EPOCH_MAX == (1 << 30) - 1      # csrc/scan.cu kEpochMask
