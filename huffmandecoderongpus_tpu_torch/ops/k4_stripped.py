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

On the card (plan ``p4_plan``) a block owns 32 lanes and a thread a range
of ``jr`` window columns of ``vec`` lanes (four lanes' low bytes in one
word: XOR does not carry, and the prefix sums are added a byte at a time),
over every window; the prefix stage scans the ranges' popcounts in shared
memory a window at a time for each range's carry.  The block writes its
lanes' rows as one stretch, 16 bytes a store where ORP and the output's
address allow.
"""

from __future__ import annotations

import torch

from huffmandecoderongpus_tpu_torch.ops import _build
from huffmandecoderongpus_tpu_torch.utils import trace

STAGES = ("transpose", "prefix")
WIN = 128
#: G must be a multiple of this; a block of the kernel owns LANES lanes
G_MULTIPLE = 64
LANES = 32
#: bytes of a lane's row staged in shared memory (128 and 16 of padding)
STRIDE = WIN + 16


def p4_plan(G: int, sym_ptr: int = 0, nib_ptr: int = 0,
            out_ptr: int = 0, ORP: int = WIN) -> dict:
    """Launch plan of P4: ``lanes`` (32) a block, ``vec`` lanes a thread (4,
    read as one 16-byte sym vector and one 4-byte nib word a cell, where G
    and both addresses allow; else 1), ``jr`` window columns a thread (8,
    or 16 with one lane), ``threads`` a block (a thread for each lane group
    and column range), ``shared`` its bytes (the staged rows and two
    buffers of the ranges' sums), ``store`` the output's store width (16
    where ORP and ``out_ptr`` allow, else 4) and ``blocks``."""
    vec = 4 if G % 4 == 0 and sym_ptr % 16 == 0 and nib_ptr % 4 == 0 else 1
    jr = 8 if vec == 4 else 16
    groups, ranges = LANES // vec, WIN // jr
    return dict(lanes=LANES, vec=vec, jr=jr, threads=groups * ranges,
                shared=LANES * STRIDE + 2 * ranges * groups * 4,
                store=16 if ORP % 16 == 0 and out_ptr % 16 == 0 else 4,
                blocks=G // LANES)


def p4_plan_ok(p: dict, G: int, ORP: int, sym_ptr: int, nib_ptr: int,
               out_ptr: int) -> bool:
    """The launcher's check (``csrc/k4_stripped.cu`` ``ws_k4_stripped``)
    mirrored: the only plan it takes is ``p4_plan``'s for these pointers,
    or the same with narrower loads or stores."""
    if G < 0 or G % G_MULTIPLE or ORP < WIN or ORP % 4:
        return False
    if p["vec"] == 4 and (G % 4 or sym_ptr % 16 or nib_ptr % 4):
        return False
    if p["store"] == 16 and (ORP % 16 or out_ptr % 16):
        return False
    if p["store"] not in (4, 16) or out_ptr % 4:
        return False
    q = p4_plan(G, sym_ptr=0 if p["vec"] == 4 else 1)
    return all(p[k] == q[k] for k in ("lanes", "vec", "jr", "threads",
                                      "shared"))


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
    launch the kernel with ``p4_plan``'s plan (G a multiple of 64)."""
    _check(sym, nib, ORP, stage)
    if sym.device.type == "cpu":
        return k4_stripped_ref(sym, nib, ORP=ORP, stage=stage)
    _build.require_cuda("k4_stripped", sym, nib)
    cells_p, G = sym.shape
    if G % G_MULTIPLE:
        raise ValueError(f"k4_stripped: G must be a multiple of {G_MULTIPLE}")
    out = torch.empty((G, ORP), dtype=torch.uint8, device=sym.device)
    p = p4_plan(G, sym.data_ptr(), nib.data_ptr(), out.data_ptr(), ORP)
    rc = _build.get_lib().ws_k4_stripped(
        sym.data_ptr(), nib.data_ptr(), out.data_ptr(), G, cells_p, ORP,
        int(stage == "prefix"), p["lanes"], p["vec"], p["jr"], p["threads"],
        p["shared"], int(p["store"] == 16), _build.stream_ptr(sym))
    trace.count("launch.k4_stripped")
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
