"""Per-column compaction of padded lane-DFA emissions to dense rows.

Replaces ``huffmandecoderongpus_tpu/ops/pallas_lanedfa.py``
``compact_pallas`` / ``_compact_kernel``.  CUDA source: ``csrc/compact.cu``.

``cum`` (steps, G) int32 is each column's inclusive emission count
(``cumsum(valid, 0)`` of a lane scan) and ``sym`` (steps, G) uint8 its
per-row symbols.  Output (out_rows, G) uint8: row i of column g holds
``sym[r, g]`` for r the row of the column's (i+1)-th emission; rows at or
past the column's count are zero (the JAX function leaves them
unspecified).  Any number of columns.
"""

from __future__ import annotations

import torch

from huffmandecoderongpus_tpu_torch.ops import _build

#: kernel launches made by ``compact`` on CUDA tensors
launches = 0


def compact(cum, sym, *, out_rows):
    """Dense (out_rows, G) uint8 from ``cum`` (steps, G) int32 and ``sym``
    (steps, G) uint8.  CPU tensors run the plain version; CUDA tensors
    launch the kernel."""
    if cum.device.type == "cpu":
        return compact_ref(cum, sym, out_rows=out_rows)
    global launches
    _build.require_cuda("compact", cum, sym)
    steps, G = cum.shape
    if (cum.dtype != torch.int32 or sym.dtype != torch.uint8
            or sym.shape != cum.shape or out_rows < 0):
        raise ValueError("compact: cum must be (steps, G) int32 and sym "
                         "(steps, G) uint8")
    out = torch.empty((out_rows, G), dtype=torch.uint8, device=cum.device)
    rc = _build.get_lib().ws_compact(cum.data_ptr(), sym.data_ptr(),
                                     out.data_ptr(), steps, G, out_rows,
                                     _build.stream_ptr(cum))
    launches += 1
    _build.check(rc, "compact")
    return out


def compact_ref(cum, sym, *, out_rows):
    """Plain torch compaction: the JAX kernel's binary search as
    ``torch.searchsorted`` over each column's count, then a gather, with
    the rows past the column's count zeroed."""
    steps, G = cum.shape
    cum_t = cum.t().contiguous()
    want = torch.arange(1, out_rows + 1, dtype=cum.dtype,
                        device=cum.device).expand(G, out_rows).contiguous()
    row = torch.searchsorted(cum_t, want).clamp_(max=steps - 1)
    out = sym.t().gather(1, row)
    out[want > cum_t[:, -1:]] = 0
    return out.t().contiguous()
