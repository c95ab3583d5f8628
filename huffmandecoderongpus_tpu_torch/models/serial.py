"""Serial host decoders: the CPU baselines of the registry.

The port's copy of the JAX package's ``models/serial.py``: semantics
parity with the reference's inline serial decoders (mainrun.c:28-352), the
decode loops in the port's C++ runtime (``native``), the table builders in
numpy on the port's ``ops.lut.build_decode_lut``.  They run on the host
whatever the lookup's device.
"""

from __future__ import annotations

import numpy as np

from huffmandecoderongpus_tpu_torch import native
from huffmandecoderongpus_tpu_torch.models import register
from huffmandecoderongpus_tpu_torch.ops.lut import build_decode_lut


@register("justreaddata", backend="host-native", checks_output=False)
def justreaddata(hf, param=None, *, device) -> np.ndarray:
    """Memory-bandwidth floor: touch every compressed byte
    (readDataByte, mainrun.c:28-36)."""
    native.sum_bytes(hf.payload)
    return np.zeros(0, dtype=np.uint8)


@register("simple", backend="host-native")
def simple(hf, param=None, *, device) -> np.ndarray:
    """Bit-at-a-time tree walk, the oracle (mainrun.c:38-55)."""
    return native.simple_decode(hf)


@register("simple_rp", backend="host-native")
def simple_rp(hf, param=None, *, device) -> np.ndarray:
    """Register-cached byte variant (mainrun.c:76-117)."""
    return native.simple_decode_rp(hf)


def build_packed_lut(tree: np.ndarray, height: int | None = None):
    """(sym << 8) | len packed u16 entries (struct bigTable,
    mainrun.c:120-135); returns (entries, height)."""
    lut = build_decode_lut(tree, height)
    packed = (lut.sym.astype(np.uint16) << 8) | lut.length.astype(np.uint16)
    return np.ascontiguousarray(packed), lut.height


@register("bigtable_v1", backend="host-native")
def bigtable_v1(hf, param=None, *, device) -> np.ndarray:
    """Full-height LUT, packed u16 entries (decodeBigtableV1,
    mainrun.c:142-195)."""
    packed, h = build_packed_lut(hf.tree)
    return native.bigtable_decode_packed(hf, packed, h)


@register("bigtable_simple", backend="host-native")
def bigtable_simple(hf, param=None, *, device) -> np.ndarray:
    """Full-height LUT, separate sym/len arrays (decodeBigtableSimple,
    mainrun.c:251-297)."""
    return native.bigtable_decode(hf)


def build_multisym_lut(tree: np.ndarray, height: int | None = None,
                       maxsym: int = 6):
    """Multi-symbol LUT: each h-bit window stores every codeword fully
    inside it, up to ``maxsym`` (struct bigTableMulti + lookupsymbols,
    mainrun.c:197-247), built over all 2^h windows at once.  Returns
    (syms (2^h, maxsym), count, consumed, h, maxsym)."""
    lut = build_decode_lut(tree, height)
    h = lut.height
    size = 1 << h
    win = np.arange(size, dtype=np.uint32)
    syms = np.zeros((size, maxsym), dtype=np.uint8)
    count = np.zeros(size, dtype=np.uint8)
    consumed = np.zeros(size, dtype=np.int32)
    pos = np.zeros(size, dtype=np.int32)
    active = np.ones(size, dtype=bool)
    for j in range(maxsym):
        sub = (win >> pos.astype(np.uint32)) & np.uint32(lut.mask)
        ln = lut.length[sub]
        fits = active & (pos + ln <= h)
        syms[fits, j] = lut.sym[sub[fits]]
        pos = np.where(fits, pos + ln, pos)
        count += fits.astype(np.uint8)
        consumed = np.where(fits, pos, consumed)
        active = fits
    return syms, count, consumed, h, maxsym


@register("bigtable_multisym", backend="host-native")
def bigtable_multisym(hf, param=None, *, device) -> np.ndarray:
    """Multi-symbol LUT decode with a serial tail (decodeBigtableMultiSym,
    mainrun.c:300-352)."""
    syms, count, consumed, h, maxsym = build_multisym_lut(hf.tree)
    data = hf.payload_padded(4)
    head, pos = native.multisym_decode_raw(
        np.ascontiguousarray(syms), count, consumed, maxsym, h,
        data, hf.bits, hf.uncompressed_size,
    )
    tail = native.tail_decode(
        hf.tree, 0, data, pos, hf.bits, hf.uncompressed_size - head.size
    )
    return np.concatenate([head, tail])
