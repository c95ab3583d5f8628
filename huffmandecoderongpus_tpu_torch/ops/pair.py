"""Torch helpers shared by the plain versions of the 1-bit kernels.

The pair table (``widescan.pack_pair_table``) holds one 32-bit word per
state whose 16-bit half ``b`` is the entry for reading bit ``b``; row c of
the (NS, 128) table holds states [c*128, c*128+128), so the flattened table
is indexed by the state itself.  Entries come in two layouts: compact (up to
128 states, ``NS == 1``) sym<<8 | emit<<7 | next state, and wide (``NS >
1``) emit<<15 | sym<<1 when emitting (the next state is the root), the bare
state otherwise.
"""

from __future__ import annotations

import torch

from huffmandecoderongpus_tpu_torch.ops.quad import u32


def bit_rows(wmat: torch.Tensor, nrows: int) -> torch.Tensor:
    """Bits 0..nrows-1 of every lane, (nrows, G) int64, from the halo'd
    word matrix ``wmat`` (steps_w, G) int32 (bit j of a lane is bit j % 32
    of its word row j // 32)."""
    j = torch.arange(nrows, device=wmat.device, dtype=torch.int64)
    return (u32(wmat)[j >> 5] >> (j & 31)[:, None]) & 1


def pair_entry(tab: torch.Tensor, node, b):
    """16-bit entry of state ``node`` for bit ``b``; ``tab`` is the
    (NS * 128,) int64 flattened pair table."""
    return (tab[node] >> (b << 4)) & 0xFFFF


def e1_fields(e, NS: int):
    """(emit, sym, node) of a 16-bit pair entry: ``sym`` is zero where
    nothing is emitted, ``node`` the state after the bit."""
    if NS > 1:
        emit = (e >> 15) & 1
        return emit, emit * ((e >> 1) & 0xFF), (1 - emit) * (e & 0x7FFF)
    return (e >> 7) & 1, e >> 8, e & 127
