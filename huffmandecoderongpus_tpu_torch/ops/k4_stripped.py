"""P4: K4 cut down to its transpose or its prefix stage, for timing.

Replaces ``scripts/hw_k4probe.py:120`` (``_k4_stripped`` :42-78).  CUDA
source: ``csrc/k4_stripped.cu``.  Inputs are the port's K4 layout, ``sym``
(cells_p, G) int32 and ``nib`` (cells_p, G) uint8; cells are padded with
zeros to a whole number of 128-cell windows w:

  transpose  out[g, j] = XOR_w (sym[w*128 + j, g] ^ nib[w*128 + j, g]) & 0xFF
  prefix     per window, cum = the inclusive prefix over j of
             popcount(nib & 0xF); acc[j] ^= cum[j] ^ sym[w*128 + j, g] and
             wpre += cum[127]; out[g, j] = (acc[j] + wpre) & 0xFF

for j < 128; columns 128 and up of the (G, ORP) uint8 output are zero.
"""

from __future__ import annotations

import torch

from huffmandecoderongpus_tpu_torch.ops import _build

#: kernel launches made by ``k4_stripped`` on CUDA tensors
launches = 0
STAGES = ("transpose", "prefix")
WIN = 128
#: lanes a block of the kernel
LANES = 64


def _check(sym, nib, ORP, stage):
    if stage not in STAGES:
        raise ValueError(f"k4_stripped: stage {stage!r} not in {STAGES}")
    if (sym.dim() != 2 or nib.shape != sym.shape or sym.dtype != torch.int32
            or nib.dtype != torch.uint8):
        raise ValueError("k4_stripped: sym (cells_p, G) int32 and nib of its "
                         "shape uint8")
    if ORP < WIN or ORP % 4:
        raise ValueError("k4_stripped: ORP must be a multiple of 4, >= 128")


def k4_stripped(sym, nib, *, ORP, stage):
    """(G, ORP) uint8.  CPU tensors run the plain version; CUDA tensors
    launch the kernel (G a multiple of 64)."""
    _check(sym, nib, ORP, stage)
    if sym.device.type == "cpu":
        return k4_stripped_ref(sym, nib, ORP=ORP, stage=stage)
    global launches
    _build.require_cuda("k4_stripped", sym, nib)
    cells_p, G = sym.shape
    if G % LANES:
        raise ValueError(f"k4_stripped: G must be a multiple of {LANES}")
    out = torch.empty((G, ORP), dtype=torch.uint8, device=sym.device)
    rc = _build.get_lib().ws_k4_stripped(
        sym.data_ptr(), nib.data_ptr(), out.data_ptr(), G, cells_p, ORP,
        int(stage == "prefix"), _build.stream_ptr(sym))
    launches += 1
    _build.check(rc, "k4_stripped")
    return out


def k4_stripped_ref(sym, nib, *, ORP, stage):
    """Plain torch stages: the padded cells as (windows, 128, G), XOR
    folded over the windows."""
    _check(sym, nib, ORP, stage)
    cells_p, G = sym.shape
    cw = -(-cells_p // WIN)
    pad = cw * WIN - cells_p
    s = torch.nn.functional.pad(sym.to(torch.int64), (0, 0, 0, pad))
    v = torch.nn.functional.pad(nib.to(torch.int64), (0, 0, 0, pad))
    s, v = s.reshape(cw, WIN, G), v.reshape(cw, WIN, G)
    if stage == "transpose":
        term, wpre = s ^ v, 0
    else:
        c2 = sum((v >> b) & 1 for b in range(4))
        cum = torch.cumsum(c2, dim=1)
        term, wpre = cum ^ s, cum[:, -1].sum(0)
    acc = torch.zeros((WIN, G), dtype=torch.int64, device=sym.device)
    for w in range(cw):
        acc = acc ^ term[w]
    out = torch.zeros((G, ORP), dtype=torch.uint8, device=sym.device)
    out[:, :WIN] = ((acc + wpre) & 0xFF).t().to(torch.uint8)
    return out
