"""Paged decode: the file cut into pages, each page encoded with its own
tree by the plain reference, and each request one
``decode_widescan_batch(pages, device=...)`` call over
``pages_per_request`` pages, host bytes to host bytes.  Request i takes
the pages from ``i * pages_per_request`` on, round the file, so every page
is decoded in turn; each request relabels its pages' trees and flips some
of their pairs (``variation``), so no page comes twice alike."""

from __future__ import annotations

import random
import sys

import numpy as np

from codecbench import reference, roofline, variation
from codecbench.entries.lane_wide import glance_bytes
from codecbench.inputs import huff_file

SPANS = (("huffmandecoderongpus_tpu_torch.ops.widescan",
          "stage_widescan_inputs", "stage"),
         ("huffmandecoderongpus_tpu_torch.ops.batch", "stage_batch_inputs",
          "stage"))

#: pairs a page flips
PAIRS = 4


class Cell:
    def __init__(self, data, cfg, traffic, device, seed):
        from huffmandecoderongpus_tpu_torch import HuffFile
        from huffmandecoderongpus_tpu_torch.ops.batch import (
            decode_widescan_batch,
        )

        self.HuffFile = HuffFile
        self.batch = decode_widescan_batch
        self.device = str(device)
        page = int(traffic["page_bytes"])
        self.per = int(traffic["pages_per_request"])
        self.hfs, self.plain, self.swaps, heights = [], [], [], []
        for start in range(0, data.numel(), page):
            part = data[start:start + page]
            hf, stats = huff_file(part)
            plain = part.cpu().numpy().copy()
            _code, length, _present = reference.tree_codes(hf.tree)
            pos = variation.pick_pairs(plain, PAIRS)
            self.swaps.append(variation.Swaps(
                plain, pos, variation.bit_offsets(part, pos, length),
                hf.tree))
            self.hfs.append(hf)
            self.plain.append(plain)
            heights.append(stats["height"])
        self.rng = random.Random(seed)
        self.current = [self.hfs[k] for k in self.pages(0)]
        print(f"[setup] {cfg['name']}: {len(self.hfs)} pages of {page} "
              f"bytes, code heights {min(heights)}-{max(heights)}",
              file=sys.stderr)

    def pages(self, i) -> list[int]:
        return [(i * self.per + j) % len(self.hfs) for j in range(self.per)]

    def warmup(self):
        for i in range(-(-len(self.hfs) // self.per)):  # every page once
            self.batch([self.hfs[k] for k in self.pages(i)],
                       device=self.device)

    def prepare(self, i) -> dict:
        """Make request i's pages; returns what its check needs."""
        perm = np.array(self.rng.sample(range(256), 256), dtype=np.uint8)
        states = []
        self.current = []
        for k in self.pages(i):
            hf = self.hfs[k]
            states.append(self.swaps[k].draw(self.rng))
            self.swaps[k].move(states[-1], self.plain[k], hf.payload)
            self.current.append(self.HuffFile(
                tree=variation.relabel(hf.tree, perm), bits=hf.bits,
                uncompressed_size=hf.uncompressed_size, payload=hf.payload))
        return dict(i=i, perm=perm, states=states)

    def request(self, i):
        return self.batch(self.current, device=self.device)

    def glance(self, note: dict, outs) -> None:
        """Note the bad bytes of each page of ``outs`` at one offset in
        ``STRIDE`` and at every flipped pair; a page missing or too many
        counts whole."""
        outs, ks = list(outs), self.pages(note["i"])
        offset = self.rng.randrange(variation.STRIDE)
        bad = sum(np.asarray(o).size for o in outs[len(ks):])
        bad += sum(self.plain[k].size for k in ks[len(outs):])
        for out, k in zip(outs, ks):
            bad += glance_bytes(out, self.plain[k], note["perm"],
                                self.swaps[k].touched(), offset)
        note["bad"] = bad

    def work(self, i) -> dict:
        size = sum(self.hfs[k].uncompressed_size for k in self.pages(i))
        comp = sum(self.hfs[k].payload_bytes for k in self.pages(i))
        return dict(in_bytes=comp, out_bytes=size,
                    moved_bytes=roofline.decode_bytes(comp, size))

    def check(self, samples, notes):
        """The glances' bad bytes over every answer, and each sampled
        answer's with every byte compared; the requests found wrong."""
        wrong = {i for i, note in notes.items() if note["bad"]}
        bad = 0
        for i, outs in samples:
            note, ks = notes[i], self.pages(i)
            wants = []
            for k, state in zip(ks, note["states"]):
                self.swaps[k].move(state, self.plain[k])
                wants.append(note["perm"][self.plain[k]])
            outs = list(outs)
            # a page missing from the answer, or one too many, is all bad
            n = max(len(outs), len(wants))
            outs += [np.zeros(0, np.uint8)] * (n - len(outs))
            wants += [np.zeros(0, np.uint8)] * (n - len(wants))
            b = sum(reference.bad_bytes(o, w) for o, w in zip(outs, wants))
            bad += b
            if b:
                wrong.add(i)
        every = sum(note["bad"] for note in notes.values())
        return {"bad_bytes": (bad, 0), "glanced_bad_bytes": (every, 0)}, wrong
