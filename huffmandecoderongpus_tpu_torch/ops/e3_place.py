"""E3: place every lane's phase-shifted granules into the payload.

Replaces ``huffmandecoderongpus_tpu/ops/pallas_encode.py`` ``e3_place`` /
``_e3_kernel``.  CUDA source: ``csrc/e3_place.cu``.

Lane g's granule row of ``shifted`` (G, ORP) lands at global granule
``word_off[g]``; its first ``occ[g]`` granules carry bits, and a granule
two or more lanes share holds disjoint bit ranges, so OR (here: ADD) is
exact in any order.  The output (NROWS, 128) int32 holds the payload's u16
granules, row-major, as the TPU kernel's does.  Unlike the TPU package,
which places payloads over 8 MiB on the host (``place_lanes``), the port
runs E3 at every size.
"""

from __future__ import annotations

import torch

from huffmandecoderongpus_tpu_torch.ops import _build

#: kernel launches made by ``e3_place`` on CUDA tensors
launches = 0


def occupancy(shift, lane_bits):
    """Granules lane g's L code bits at phase a occupy:
    ``((a + L - 1) >> 4) + 1``, or 0 for an empty lane (int32)."""
    L = lane_bits.to(torch.int64)
    occ = ((shift.to(torch.int64) + L - 1) >> 4) + 1
    return torch.where(L > 0, occ, 0).to(torch.int32)


def e3_place(shifted, word_off, occ, *, NROWS):
    """(NROWS, 128) int32 payload granules from ``shifted`` (G, ORP)
    int32, ``word_off`` (G,) int32 and ``occ`` (G,) int32.  CPU tensors run
    the plain version; CUDA tensors launch the kernel (after zeroing its
    output)."""
    if shifted.device.type == "cpu":
        return e3_place_ref(shifted, word_off, occ, NROWS=NROWS)
    global launches
    _build.require_cuda("e3_place", shifted, word_off, occ)
    G, ORP = shifted.shape
    if (word_off.shape != (G,) or occ.shape != (G,)
            or {shifted.dtype, word_off.dtype, occ.dtype} != {torch.int32}):
        raise ValueError("e3_place: shifted (G, ORP), word_off and occ (G,), "
                         "all int32")
    out = torch.zeros((NROWS, 128), dtype=torch.int32, device=shifted.device)
    rc = _build.get_lib().ws_e3_place(
        shifted.data_ptr(), word_off.data_ptr(), occ.data_ptr(),
        out.data_ptr(), G, ORP, NROWS * 128, _build.stream_ptr(shifted))
    launches += 1
    _build.check(rc, "e3_place")
    return out


def e3_place_ref(shifted, word_off, occ, *, NROWS):
    """Plain torch E3: one index_add of every occupied granule at its
    payload index (ADD equals OR on disjoint bit ranges)."""
    G, ORP = shifted.shape
    n = NROWS * 128
    i = torch.arange(ORP, device=shifted.device)
    idx = word_off.to(torch.int64)[:, None] + i
    keep = (i < occ[:, None]) & (idx < n)
    out = torch.zeros(n + 1, dtype=torch.int64, device=shifted.device)
    out.index_add_(0, torch.where(keep, idx, n).reshape(-1),
                   torch.where(keep, shifted, 0).to(torch.int64).reshape(-1))
    return out[:n].to(torch.int32).reshape(NROWS, 128)
