"""S4: the serial LUT walk in one CUDA thread, the sanity baseline.

The port of ``huffmandecoderongpus_tpu/models/onethread.py``
``_onethread_decode`` (:23-36), a ``lax.while_loop`` on one scalar unit
there and the reference's ``<<<1,1>>>`` decoder (``onethread.cu:13-52``):
from bit 0 while the position is inside the stream, the window's symbol
goes to ``out[n]`` (dropped past ``size``, while ``n`` keeps counting) and
the position moves by its code length.  CUDA source: ``csrc/onethread.cu``:
the walk reads a packed table (``pack_table``: one 16-bit entry a window,
symbol and length together) from shared memory where it fits (height up to
16), else from device memory, and its bits from a register buffer topped
up a word ahead, so a symbol's chain is one table load.
"""

from __future__ import annotations

import torch

from huffmandecoderongpus_tpu_torch.ops import _build
from huffmandecoderongpus_tpu_torch.utils import trace


def pack_table(lut_sym, lut_len):
    """The packed table, (2^h rounded up to 8,) int16 on the tables'
    device: ``(sym << 5) | ((len - 1) & 31)`` a window (lengths 1-22 take
    the low 5 bits as 0-21, the symbol the 8 above; a window that matches
    no code, length 0, packs as 31, so its symbol bits stay whole), zeros in
    the padding.  S1 (``csrc/spec_all_bits.cu``) packs the same entry
    inside its launch and reads the length as ``((e & 31) + 1) & 31``.
    Torch ops."""
    n = lut_sym.numel()
    tab = torch.zeros(-(-n // 8) * 8, dtype=torch.int16,
                      device=lut_sym.device)
    tab[:n] = (lut_sym.to(torch.int16) << 5) | (
        (lut_len - 1) & 31).to(torch.int16)
    return tab


def onethread(words, lut_sym, lut_len, *, bits: int, size: int,
              height: int):
    """(out uint8 (size,), n int32 ()): the symbols the walk decoded (zeros
    where it decoded none) and how many it decoded.  ``words`` are the
    payload's uint32 bit patterns as int32 with a zero pad word.  CPU
    tensors run the plain version; CUDA tensors launch the kernel."""
    if words.dtype != torch.int32 or lut_sym.dtype != torch.uint8 or (
            lut_len.dtype != torch.int32):
        raise ValueError("onethread: words int32, lut_sym uint8, lut_len "
                         "int32")
    if not 1 <= height <= 22 or bits < 0 or size < 0:
        raise ValueError("onethread: height 1-22, bits and size >= 0")
    if words.numel() < (bits + 31) // 32 + 1:
        raise ValueError("onethread: words must end in a zero pad word")
    if words.is_cpu:
        return onethread_ref(words, lut_sym, lut_len, bits=bits, size=size,
                             height=height)
    _build.require_cuda("onethread", words, lut_sym, lut_len)
    if lut_sym.numel() != 1 << height or lut_len.numel() != 1 << height:
        raise ValueError("onethread: the tables hold 2^height entries")
    tab = pack_table(lut_sym, lut_len)
    out = torch.empty(size, dtype=torch.uint8, device=words.device)
    n = torch.empty((), dtype=torch.int32, device=words.device)
    rc = _build.get_lib().ws_onethread(
        words.data_ptr(), tab.data_ptr(), out.data_ptr(), n.data_ptr(),
        words.numel(), bits, size, height, _build.stream_ptr(words))
    trace.count("launch.onethread")
    _build.check(rc, "onethread")
    return out, n


def onethread_ref(words, lut_sym, lut_len, *, bits: int, size: int,
                  height: int):
    """Plain walk, one symbol a step, on the host's copies of the
    tensors."""
    w = [x & 0xFFFFFFFF for x in words.tolist()]
    syms, lens = lut_sym.tolist(), lut_len.tolist()
    mask = (1 << height) - 1
    out = [0] * size
    pos = n = 0
    while pos < bits:
        q, r = pos >> 5, pos & 31
        win = ((w[q] | (w[q + 1] << 32)) >> r) & mask
        if n < size:
            out[n] = syms[win]
        pos += lens[win]
        n += 1
    dev = words.device
    return (torch.tensor(out, dtype=torch.uint8, device=dev),
            torch.tensor(n, dtype=torch.int32, device=dev))
