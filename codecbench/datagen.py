"""The data of a configuration, made from the seed on the device.

A configuration fixes the file's byte histogram: ``bytes`` in all over
``symbols`` byte values, rank r being byte value r.  Optionally the top
rank holds ``lead_share`` of the file (a dominant byte); the next ranks
follow a Zipf-Mandelbrot law (r + 1 + ``zipf_q``) ** -``zipf_s``, and the
last ``tail_symbols`` ranks fall geometrically from there to
``min_count`` occurrences.  Every count is at least 1 and the top rank
takes the rounding, so the histogram, and with it the Huffman code, the
stream's bit count and every launch geometry, is the same for every seed.

The seed only orders the bytes.  A fixed base order (a permutation drawn
from ``BASE_SEED``) deals the histogram into blocks of
``shuffle_block_bytes``, so every block, such as a page of a paged cell,
also has the same histogram for every seed; the seed then shuffles the
bytes inside each block.  Order-0 Huffman work depends on the code and
the size, not on the order of the symbols.
"""

from __future__ import annotations

import numpy as np
import torch

#: seed of the base order, shared by every run
BASE_SEED = 0x5EED


def histogram(cfg: dict) -> np.ndarray:
    """(256,) int64 byte counts of the configuration, summing to
    ``cfg["bytes"]``."""
    n_bytes, n = int(cfg["bytes"]), int(cfg["symbols"])
    tail = int(cfg["tail_symbols"])
    lead = float(cfg.get("lead_share") or 0.0)
    n_head = n - tail - (1 if lead else 0)
    if n_head < 1 or n > 256:
        raise ValueError("a histogram needs 1-256 symbols and a head")
    w = (np.arange(n_head) + 1 + float(cfg["zipf_q"])) ** -float(cfg["zipf_s"])
    w /= w.sum()
    head_mass = 1.0 - lead
    t = np.geomspace(w[-1] * head_mass, int(cfg["min_count"]) / n_bytes,
                     tail + 1)[1:]
    p = np.concatenate([[lead] if lead else [], w * (head_mass - t.sum()), t])
    counts = np.maximum(1, np.round(p * n_bytes)).astype(np.int64)
    counts[0] += n_bytes - counts.sum()
    return np.pad(counts, (0, 256 - n))


def entropy_bits(hist) -> float:
    """Order-0 entropy of a histogram, bits a byte."""
    p = np.asarray(hist, dtype=np.float64)
    p = p[p > 0] / p.sum()
    return float(-(p * np.log2(p)).sum())


def generate(cfg: dict, seed: int, device) -> torch.Tensor:
    """The configuration's bytes for ``seed``: a (bytes,) uint8 tensor on
    ``device``, its histogram ``histogram(cfg)``."""
    device = torch.device(device)
    counts = torch.from_numpy(histogram(cfg)).to(device)
    n = int(cfg["bytes"])
    block = int(cfg["shuffle_block_bytes"])
    ranked = torch.repeat_interleave(
        torch.arange(256, dtype=torch.uint8, device=device), counts)
    base_gen = torch.Generator(device=device)
    base_gen.manual_seed(BASE_SEED)
    base = ranked[torch.randperm(n, generator=base_gen, device=device)]
    del ranked
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    out = torch.empty_like(base)
    for start in range(0, n, block):
        stop = min(start + block, n)
        perm = torch.randperm(stop - start, generator=gen, device=device)
        out[start:stop] = base[start:stop][perm]
    return out
