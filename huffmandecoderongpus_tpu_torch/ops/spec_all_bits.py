"""S1: the speculative pipeline's decode from every bit offset.

The port of the first stage of ``huffmandecoderongpus_tpu/ops/
speculative.py`` ``speculative_decode_xla`` (:105-111), XLA ops there and
no Pallas kernel: for every bit offset the height-bit window, its first
symbol and code length from the full-height table, and ``step0`` (the
length, or -1 where the code runs past ``bits``).  CUDA source:
``csrc/spec_all_bits.cu``.  ``step0`` is int16, the type the JAX pipeline
keeps level 0 in.

The kernel looks each window up with one load of a packed 16-bit entry (the
entry of ``onethread.pack_table``, packed inside the launch), a thread takes
``RUN`` consecutive offsets from one 64-bit window, and persistent blocks
take the runs grid-stride.  A table up to ``SHARED_HEIGHT`` sits whole in
each block's shared memory; a taller one is a two-level table: its first
``2^SHARED_HEIGHT`` entries in shared memory, taken where their length is
1..SHARED_HEIGHT, and the whole table packed into device memory for the
other windows, which relies on ``build_decode_lut``'s rule that a code of
length L fills every window agreeing with it in the low L bits.
"""

from __future__ import annotations

import torch

from huffmandecoderongpus_tpu_torch.ops import _build
from huffmandecoderongpus_tpu_torch.ops.quad import u32
from huffmandecoderongpus_tpu_torch.utils import trace

#: tables up to this height sit whole in a block's shared memory; a taller
#: one is looked up in two levels (``csrc/spec_all_bits.cu``)
SHARED_HEIGHT = 14
#: consecutive offsets a thread takes from one funnel window
RUN = 8


def _check_inputs(words, lut_sym, lut_len, bits: int, height: int) -> None:
    """Refuse what the kernel does not take.  The table must be a decode
    table as ``build_decode_lut`` (or the JAX package's) writes it: above
    ``SHARED_HEIGHT`` the kernel takes a window's entry from its low
    ``SHARED_HEIGHT`` bits wherever that entry's length is 1..SHARED_HEIGHT,
    which holds only for a table in which a code of length L fills every
    window that agrees with it in the low L bits; up to ``SHARED_HEIGHT``
    any table is looked up whole.  Lengths are 0..22."""
    if words.dtype != torch.int32 or words.numel() < (bits + 31) // 32 + 1:
        raise ValueError("spec_all_bits: words must be int32 with a pad word")
    if lut_sym.dtype != torch.uint8 or lut_len.dtype != torch.int32:
        raise ValueError("spec_all_bits: the table is uint8 symbols and int32 "
                         "lengths")
    if not 1 <= height <= 22 or lut_sym.numel() != 1 << height or (
            lut_len.numel() != 1 << height):
        raise ValueError(f"spec_all_bits: a height-{height} table has "
                         f"{1 << height} entries (height 1-22)")
    if bits < 1:
        raise ValueError("spec_all_bits: bits must be positive")


def spec_all_bits(words, lut_sym, lut_len, *, bits: int, height: int):
    """(step0 int16 (bits,), sym uint8 (bits,)) of the payload ``words``
    (little-endian uint32 bit patterns as int32, with a zero pad word) under
    the table (``lut_sym`` uint8, ``lut_len`` int32, 2^height entries each).
    CPU tensors run the plain version; CUDA tensors launch the kernel."""
    _check_inputs(words, lut_sym, lut_len, bits, height)
    if words.is_cpu:
        return spec_all_bits_ref(words, lut_sym, lut_len, bits=bits,
                                 height=height)
    _build.require_cuda("spec_all_bits", words, lut_sym, lut_len)
    step0 = torch.empty(bits, dtype=torch.int16, device=words.device)
    sym = torch.empty(bits, dtype=torch.uint8, device=words.device)
    packed = (torch.empty(1 << height, dtype=torch.int16, device=words.device)
              if height > SHARED_HEIGHT else None)
    rc = _build.get_lib().ws_spec_all_bits(
        words.data_ptr(), lut_sym.data_ptr(), lut_len.data_ptr(),
        0 if packed is None else packed.data_ptr(), step0.data_ptr(),
        sym.data_ptr(), bits, height, _build.stream_ptr(words))
    trace.count("launch.spec_all_bits")
    _build.check(rc, "spec_all_bits")
    return step0, sym


def extract_windows(words, b, height: int):
    """``height``-bit LSB-first windows (int64) starting at bit offsets
    ``b`` of ``words`` (uint32 bit patterns as int32, >= 1 zero pad word),
    as the JAX ``extract_windows``."""
    b = b.to(torch.int64)
    w = u32(words)
    q, r = b >> 5, b & 31
    lo = w[q] >> r
    # (hi << (32 - r)) has no bits below 32 - r: at r = 0 nothing of it
    # lands under the mask, which the JAX version masks by hand
    hi = (w[q + 1] << (32 - r)) & 0xFFFFFFFF
    return (lo | hi) & ((1 << height) - 1)


def spec_all_bits_ref(words, lut_sym, lut_len, *, bits: int, height: int):
    """Plain torch S1: windows, two table lookups, the stream-end cut."""
    b = torch.arange(bits, dtype=torch.int64, device=words.device)
    win = extract_windows(words, b, height)
    ln = lut_len[win].to(torch.int64)
    step0 = torch.where(b + ln <= bits, ln, -1).to(torch.int16)
    return step0, lut_sym[win]
