"""E2: per-lane compaction of E1's granule rows into dense rows.

Replaces ``huffmandecoderongpus_tpu/ops/pallas_encode.py`` ``e2_compact``
/ ``_e2_kernel``.  CUDA source: ``csrc/e2_compact.cu``.

Row g of ``denseT`` (G, ORP) int32 holds lane g's valid granules in row
order.  Ranks at or past ORP are dropped (the caller checks the counts),
and the rest of the row is zero; the TPU kernel leaves the words past the
largest count unwritten, so a comparison with it stops at the counts.
Unlike the TPU kernel, E2 reads E1's (2K, G) rows as they are: no
transpose and no padding to ``rows_p``.
"""

from __future__ import annotations

import torch

from huffmandecoderongpus_tpu_torch.ops import _build

#: kernel launches made by ``e2_compact`` on CUDA tensors
launches = 0


def e2_compact(gran, gval, *, ORP):
    """denseT (G, ORP) int32 from ``gran`` (2K, G) int32 and ``gval``
    (2K, G) uint8.  CPU tensors run the plain version; CUDA tensors launch
    the kernel."""
    if gran.device.type == "cpu":
        return e2_compact_ref(gran, gval, ORP=ORP)
    global launches
    _build.require_cuda("e2_compact", gran, gval)
    rows, G = gran.shape
    if (gval.shape != gran.shape or gran.dtype != torch.int32
            or gval.dtype != torch.uint8 or ORP < 1):
        raise ValueError("e2_compact: gran (2K, G) int32, gval (2K, G) "
                         "uint8, ORP >= 1")
    out = torch.empty((G, ORP), dtype=torch.int32, device=gran.device)
    rc = _build.get_lib().ws_e2_compact(
        gran.data_ptr(), gval.data_ptr(), out.data_ptr(), rows, G, ORP,
        _build.stream_ptr(gran))
    launches += 1
    _build.check(rc, "e2_compact")
    return out


def e2_compact_ref(gran, gval, *, ORP):
    """Plain torch E2: a cumulative sum over each lane's valid rows gives
    every granule its rank, then one scatter."""
    G = gran.shape[1]
    valid = gval.t() > 0
    rank = torch.cumsum(valid.to(torch.int64), dim=1) - 1
    dst = torch.where(valid & (rank < ORP), rank, ORP)
    out = torch.zeros((G, ORP + 1), dtype=torch.int32, device=gran.device)
    out.scatter_(1, dst, torch.where(valid, gran.t(), 0))
    return out[:, :ORP].contiguous()
