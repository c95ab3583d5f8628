"""Whole-file decode through the port's registry:
``get_decoder("lane_wide", device=...)(hf)``, a `.huff` file in host
memory to its bytes in host memory.  The file is the configuration's data
encoded whole by the plain reference; every request relabels its tree
and flips some of its pairs (``variation``), so each request is a new
file of the same code's shape."""

from __future__ import annotations

import random
import sys

import numpy as np

from codecbench import reference, roofline, variation
from codecbench.inputs import huff_file

SPANS = (("huffmandecoderongpus_tpu_torch.ops.widescan",
          "stage_widescan_inputs", "stage"),)

#: pairs a file flips
PAIRS = 64


class Cell:
    def __init__(self, data, cfg, traffic, device, seed):
        from huffmandecoderongpus_tpu_torch import HuffFile, get_decoder

        self.HuffFile = HuffFile
        self.device = str(device)
        self.hf, stats = huff_file(data)
        self.plain = data.cpu().numpy().copy()  # the decoded bytes, swaps applied
        _code, length, _present = reference.tree_codes(self.hf.tree)
        pos = variation.pick_pairs(self.plain, PAIRS)
        self.swaps = variation.Swaps(
            self.plain, pos, variation.bit_offsets(data, pos, length),
            self.hf.tree)
        self.checked = self.swaps.touched()
        self.rng = random.Random(seed)
        self.decode = get_decoder("lane_wide", device=self.device)
        self.current = self.hf
        print(f"[setup] {cfg['name']}: {self.hf.uncompressed_size} bytes, "
              f"{self.hf.bits} bits, code height {stats['height']}, minimum "
              f"depth {stats['min_depth']}, {stats['states']} internal "
              f"nodes", file=sys.stderr)

    def warmup(self):
        self.decode(self.hf)

    def prepare(self, i) -> dict:
        """Make request i's file; returns what its check needs."""
        perm = np.array(self.rng.sample(range(256), 256), dtype=np.uint8)
        state = self.swaps.draw(self.rng)
        self.swaps.move(state, self.plain, self.hf.payload)
        self.current = self.HuffFile(
            tree=variation.relabel(self.hf.tree, perm), bits=self.hf.bits,
            uncompressed_size=self.hf.uncompressed_size,
            payload=self.hf.payload)
        return dict(perm=perm, state=state)

    def request(self, i):
        return self.decode(self.current)

    def glance(self, note: dict, out) -> None:
        """Note the bad bytes of answer ``out`` at one offset in ``STRIDE``
        and at every flipped pair, checked as it comes."""
        note["bad"] = glance_bytes(out, self.plain, note["perm"],
                                   self.checked,
                                   self.rng.randrange(variation.STRIDE))

    def work(self, i) -> dict:
        size, comp = self.hf.uncompressed_size, self.hf.payload_bytes
        return dict(in_bytes=comp, out_bytes=size,
                    moved_bytes=roofline.decode_bytes(comp, size))

    def check(self, samples, notes):
        """The glances' bad bytes over every answer, and each sampled
        answer's with every byte compared; the requests found wrong."""
        wrong = {i for i, note in notes.items() if note["bad"]}
        bad = 0
        for i, out in samples:
            self.swaps.move(notes[i]["state"], self.plain)
            b = reference.bad_bytes(out, notes[i]["perm"][self.plain])
            bad += b
            if b:
                wrong.add(i)
        every = sum(note["bad"] for note in notes.values())
        return {"bad_bytes": (bad, 0), "glanced_bad_bytes": (every, 0)}, wrong


def glance_bytes(out, plain, perm, checked, offset) -> int:
    """Bytes of ``out`` that differ from ``perm[plain]`` at ``checked`` and
    at every ``STRIDE``-th position from ``offset``; a length that differs
    counts whole."""
    out = np.asarray(out, dtype=np.uint8).ravel()
    if out.size != plain.size:
        return abs(out.size - plain.size) + min(out.size, plain.size)
    at = slice(offset % max(1, min(variation.STRIDE, plain.size)), None,
               variation.STRIDE)
    return (int(np.count_nonzero(out[at] != perm[plain[at]]))
            + int(np.count_nonzero(out[checked] != perm[plain[checked]])))
