"""What makes every request of a cell a new input, so that no cache keyed
on the input can hit, and a stale one answers wrong.

Real traffic brings a new file a request: a new tree and a new payload.
A cell holds one generated file (or one set of pages) and varies it
between requests at no cost to the work:

- ``relabel``: the tree's leaves take new byte values (a permutation drawn
  a request).  The code's shape, and with it every decode's work, stays;
  the decoded bytes become ``perm[data]``.
- ``Swaps``: pairs of adjacent, different symbols whose order a request
  flips or keeps.  Their two codewords trade places in the payload (the
  stream's length and every other bit stay), and the two bytes trade
  places in the plain data.

A request's variation is drawn from the run's seed before the request is
sent, outside its timed call.
"""

from __future__ import annotations

import numpy as np
import torch

from codecbench import reference

#: every answer's bytes at one offset in STRIDE are compared in the window
STRIDE = 4096


def relabel(tree: np.ndarray, perm: np.ndarray) -> np.ndarray:
    """``tree`` with each leaf's symbol s replaced by ``perm[s]``."""
    out = tree.copy()
    leaf = out[:, 1] == reference.LEAF
    out[leaf, 0] = perm[out[leaf, 0] & 0xFF]
    return out


def get_bits(buf: np.ndarray, off: int, n: int) -> int:
    """Stream bits ``[off, off + n)`` of an LSB-first payload as an int
    (bit k of the result is stream bit ``off + k``)."""
    b0, b1 = off // 8, (off + n + 7) // 8
    word = int.from_bytes(buf[b0:b1].tobytes(), "little")
    return (word >> (off % 8)) & ((1 << n) - 1)


def put_bits(buf: np.ndarray, off: int, n: int, value: int) -> None:
    """Write ``value`` to stream bits ``[off, off + n)`` of ``buf``."""
    b0, b1 = off // 8, (off + n + 7) // 8
    word = int.from_bytes(buf[b0:b1].tobytes(), "little")
    mask = ((1 << n) - 1) << (off % 8)
    word = (word & ~mask) | ((value << (off % 8)) & mask)
    buf[b0:b1] = np.frombuffer(word.to_bytes(b1 - b0, "little"), np.uint8)


def pick_pairs(plain: np.ndarray, count: int, lo: int = 0) -> np.ndarray:
    """Up to ``count`` positions p >= ``lo``, spread over ``plain``, with
    ``plain[p] != plain[p + 1]`` and no two pairs sharing a byte."""
    n = plain.size
    out = []
    for k in range(count):
        start = max(lo + (n - lo) * k // count, out[-1] + 2 if out else lo)
        stop = min(n - 1, lo + (n - lo) * (k + 1) // count)
        diff = np.nonzero(plain[start:stop] != plain[start + 1:stop + 1])[0]
        if diff.size:
            out.append(start + int(diff[0]))
    return np.asarray(out, dtype=np.int64)


def bit_offsets(data: torch.Tensor, positions, length: np.ndarray):
    """Stream bit offset of the symbol at each of the sorted ``positions``
    of ``data`` (a uint8 tensor) under code lengths ``length`` (256,)."""
    lens = torch.from_numpy(np.asarray(length, np.int64)).to(data.device)
    offs, acc, prev = [], 0, 0
    for p in (int(p) for p in positions):
        counts = torch.bincount(data[prev:p], minlength=256)
        acc += int((counts.to(torch.int64) * lens).sum())
        offs.append(acc)
        prev = p
    return np.asarray(offs, dtype=np.int64)


class Swaps:
    """Pairs of adjacent symbols of one stream whose order a request
    flips.  ``state`` has bit k set where pair k is swapped."""

    def __init__(self, plain: np.ndarray, positions, offsets, tree):
        code, length, _present = reference.tree_codes(tree)
        self.pos = np.asarray(positions, dtype=np.int64)
        self.off = [int(o) for o in offsets]
        x = plain[self.pos].astype(np.int64)
        y = plain[self.pos + 1].astype(np.int64)
        self.width = [int(length[a] + length[b]) for a, b in zip(x, y)]
        # the pair's bits in order (state 0) and swapped (state 1)
        self.bits = [(int(code[a]) | int(code[b]) << int(length[a]),
                      int(code[b]) | int(code[a]) << int(length[b]))
                     for a, b in zip(x, y)]
        self.state = 0

    def __len__(self) -> int:
        return self.pos.size

    def touched(self) -> np.ndarray:
        """Every plain position a pair covers."""
        return np.concatenate([self.pos, self.pos + 1])

    def draw(self, rng) -> int:
        return rng.getrandbits(len(self)) if len(self) else 0

    def move(self, state: int, plain=None, payload=None) -> None:
        """Go to ``state``: swap the bytes of ``plain`` and rewrite the bits
        of ``payload`` of every pair whose bit changes."""
        change = self.state ^ state
        for k in range(len(self)):
            if change >> k & 1:
                if plain is not None:
                    p = self.pos[k]
                    plain[p], plain[p + 1] = plain[p + 1], plain[p]
                if payload is not None:
                    put_bits(payload, self.off[k], self.width[k],
                             self.bits[k][state >> k & 1])
        self.state = state

    def payload_bytes(self, payload: np.ndarray, state: int) -> dict:
        """{byte index: value} of ``payload`` (in state 0) once in
        ``state``; only the bytes the swapped pairs touch."""
        out = {}
        for k in range(len(self)):
            if state >> k & 1:
                o, w = self.off[k], self.width[k]
                b0, b1 = o // 8, (o + w + 7) // 8
                part = np.array([out.get(b, payload[b]) for b in range(b0, b1)],
                                dtype=np.uint8)
                put_bits(part, o - 8 * b0, w, self.bits[k][1])
                out.update(zip(range(b0, b1), part.tolist()))
        return out

    def pair_values(self, payload: np.ndarray) -> list[int]:
        """The bits of each pair as ``payload`` holds them."""
        return [get_bits(payload, o, w) for o, w in zip(self.off, self.width)]

    def expected_values(self, state: int) -> list[int]:
        return [self.bits[k][state >> k & 1] for k in range(len(self))]
