"""Full-height decode lookup tables, in numpy.

The port's copy of ``huffmandecoderongpus_tpu.ops.lut``: for every
``height``-bit window (LSB-first) the first symbol decoded from it and its
code length, so that decoding at a bit offset is one table lookup.  The JAX
package walks the tree once a window in its C++ runtime; here each leaf of
code ``c`` and length ``L`` fills every window ``w`` with
``w & ((1 << L) - 1) == c`` at once (``2**(h - L)`` windows a leaf).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from huffmandecoderongpus_tpu_torch.huffio import (
    table_height,
    table_min_depth,
    tree_codes,
)

MAX_LUT_HEIGHT = 22  # 2^22 entries; every shipped corpus has height <= 20


@dataclasses.dataclass(frozen=True)
class DecodeLUT:
    """(sym, len) lookup over h-bit LSB-first windows, plus tree metadata."""

    height: int  # table height h; index = window & (2^h - 1)
    sym: np.ndarray  # (2^h,) uint8: first symbol decoded in the window
    length: np.ndarray  # (2^h,) int32: its code length (1..h)
    min_depth: int

    @property
    def mask(self) -> int:
        return (1 << self.height) - 1


def build_decode_lut(tree: np.ndarray, height: int | None = None) -> DecodeLUT:
    """The table of ``tree`` at ``height`` (default: the tree's height, at
    least 1).  Raises NotImplementedError past MAX_LUT_HEIGHT, as the JAX
    ``build_decode_lut`` does."""
    h = table_height(tree) if height is None else height
    if h > MAX_LUT_HEIGHT:
        raise NotImplementedError(
            f"tree height {h} > {MAX_LUT_HEIGHT}: full-height LUT unsupported "
            "(chunked DFA walk not yet implemented)"
        )
    h = max(h, 1)
    code, length, present = tree_codes(tree)
    if int(length.max(initial=0)) > h:  # the JAX runtime's error -2
        raise RuntimeError(f"table height {h} is under the tree's height")
    size = 1 << h
    lut_sym = np.zeros(size, dtype=np.uint8)
    lut_len = np.zeros(size, dtype=np.int32)
    for s in np.nonzero(present)[0]:
        L = int(length[s])
        # the windows whose low L bits are the code: c, c + 2^L, c + 2*2^L...
        w = np.arange(int(code[s]), size, 1 << L)
        lut_sym[w] = s
        lut_len[w] = L
    return DecodeLUT(height=h, sym=lut_sym, length=lut_len,
                     min_depth=table_min_depth(tree))


def lut_from_arrays(height: int, sym, length, min_depth: int) -> DecodeLUT:
    """A DecodeLUT from arrays made elsewhere (the JAX package's
    ``DecodeLUT`` fields), so that both pipelines can run on one table."""
    sym = np.ascontiguousarray(sym, dtype=np.uint8)
    length = np.ascontiguousarray(length, dtype=np.int32)
    if sym.shape != (1 << height,) or length.shape != sym.shape:
        raise ValueError(f"a height-{height} table has {1 << height} entries")
    return DecodeLUT(height=int(height), sym=sym, length=length,
                     min_depth=int(min_depth))
