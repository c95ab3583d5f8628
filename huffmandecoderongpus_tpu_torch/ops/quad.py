"""Torch helpers shared by the plain versions of the chunked kernels.

The quad table (``widescan.pack_quad_tables``) holds, for every state and
first chunk bit b0, one 32-bit word whose 16-bit half b1 is the entry for the
2-bit chunk (b0, b1).  Entries come in two layouts: compact (up to 127
states, ``NS == 1``) and wide (``NS > 1``).  Values are carried as int64 so
the table's uint32 bit patterns never meet a sign.
"""

from __future__ import annotations

import torch

#: md-slots packed per int32 cell (a symbol byte each) and per u8 nibble
CELL = 4


def u32(t: torch.Tensor) -> torch.Tensor:
    """int32 bit patterns -> int64 values in [0, 2**32)."""
    return t.to(torch.int64) & 0xFFFFFFFF


def to_i32(t: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2**32) -> the int32 with that bit pattern."""
    return torch.where(t >= 1 << 31, t - (1 << 32), t).to(torch.int32)


def chunk_rows(wmat: torch.Tensor, nrows: int):
    """(b0, b1) of chunk rows 0..nrows-1 of every lane, each (nrows, G)
    int64: chunk i is lane bits 2i and 2i+1 of the halo'd word matrix
    ``wmat`` (steps_w, G) int32 (bit j of a lane is bit j % 32 of its word
    row j // 32)."""
    j = 2 * torch.arange(nrows, device=wmat.device, dtype=torch.int64)
    w = u32(wmat)[j >> 5]
    sh = (j & 31)[:, None]
    return (w >> sh) & 1, (w >> (sh + 1)) & 1


def quad_entry(tab: torch.Tensor, NS: int, node, b0, b1):
    """16-bit chunk entry of state ``node`` for chunk bits (b0, b1);
    ``tab`` is the (2 * NS * 128,) int64 flattened quad table."""
    idx = (b0 * NS + (node >> 7)) * 128 + (node & 127)
    return (tab[idx] >> (b1 << 4)) & 0xFFFF


def decode_entry(e, NS: int, rc):
    """(emit, pos, sym, node) of a 16-bit chunk entry.  ``sym`` is zero
    where nothing is emitted; ``node`` is the post-chunk state (``rc``,
    the root child of the chunk's second bit, rebuilds it in the wide
    layout)."""
    if NS > 1:
        emit = (e >> 15) & 1
        pos = e & 1
        sym = emit * ((e >> 1) & 0xFF)
        node = torch.where(emit > 0, (1 - pos) * rc, e & 0x7FFF)
        return emit, pos, sym, node
    emit = (e >> 7) & 1
    node = e & 127
    pos = torch.where(node == 0, emit, 0)
    return emit, pos, e >> 8, node


def scatter_slots(cells: torch.Tensor, nib: torch.Tensor, jbit: int, pos,
                  emit, sym, md: int) -> None:
    """OR an emission into its md-slot, in place: the emission ending a
    chunk at lane bit ``jbit + pos`` lands in slot ``(jbit + pos) // md``,
    byte ``slot % CELL`` of cell ``slot // CELL`` (two emissions never
    share a slot, so adding disjoint bit fields is OR)."""
    G = cells.shape[1]
    slot = (jbit + pos) // md
    idx = (slot // CELL) * G + torch.arange(G, device=cells.device)
    byte = slot % CELL
    cells.view(-1).scatter_add_(0, idx, (sym * emit) << (8 * byte))
    nib.view(-1).scatter_add_(0, idx, emit << byte)
