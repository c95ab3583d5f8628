"""Device encoder by per-symbol code lookup and a scatter-add into words.

Port of ``huffmandecoderongpus_tpu/ops/encode_ops.py`` ``encode_device``
(an XLA program there, torch ops here; no kernel of its own).  Each symbol
gets its code and length by lookup and its bit offset by an exclusive
cumsum; a code straddles at most two 32-bit words (lengths <= 31), and
both contributions are added into int64 words with ``index_add_``: codes
pack adjacently, so contributions to one word occupy disjoint bits and
ADD equals OR.
"""

from __future__ import annotations

import numpy as np
import torch

from huffmandecoderongpus_tpu_torch.huffio import (
    HuffFile,
    as_u8,
    build_tree,
    require_codes,
    tree_codes,
)
from huffmandecoderongpus_tpu_torch.ops.lanedfa_decode import require_device


def encode_device(data, tree=None, *, device) -> HuffFile:
    """Encode bytes on ``device`` into a HuffFile (the payload comes back
    once); raises ValueError for empty input and for a symbol the tree has
    no code for."""
    device = require_device(device)
    arr = as_u8(data)
    if arr.size == 0:
        raise ValueError("cannot encode empty input")
    hist = np.bincount(arr, minlength=256)
    if tree is None:
        tree = build_tree(hist)
    code, length, present = tree_codes(tree)
    require_codes(hist, present)
    sym = torch.from_numpy(arr).to(device).to(torch.int64)
    codes = torch.from_numpy(code.astype(np.int64)).to(device)[sym]
    lens = torch.from_numpy(length.astype(np.int64)).to(device)[sym]
    offs = torch.cumsum(lens, 0) - lens  # exclusive: bit offset per symbol
    bits = int(offs[-1] + lens[-1])
    if bits > 2**31 - 1:
        raise ValueError(f"{bits} bits overflow the int32 header")
    q, r = offs >> 5, offs & 31
    lo = (codes << r) & 0xFFFFFFFF
    hi = torch.where(r == 0, 0, codes >> (32 - r))
    words = torch.zeros(bits // 32 + 2, dtype=torch.int64, device=device)
    words.index_add_(0, q, lo)
    words.index_add_(0, q + 1, hi)
    b = (words[:, None] >> torch.arange(0, 32, 8, device=device)) & 0xFF
    payload = b.reshape(-1)[: (bits + 7) // 8].to(torch.uint8)
    return HuffFile(tree=tree, bits=bits, uncompressed_size=int(arr.size),
                    payload=payload.cpu().numpy())
