"""Whole-file encode: ``encode_lanes(data, device=...)`` from bytes in host
memory to a HuffFile whose payload is in host memory.

Every request is a new file of the same size: its first block holds
either the data as made or the same block with two byte values traded
(the block's most frequent and the file's rarest), which gives another
histogram and another tree, and some pairs of adjacent bytes are flipped
(``variation``).  Each answer's header is checked as it comes and its
payload at one byte in ``STRIDE`` and at every flipped pair; once the
window has closed, the plain reference encodes both versions on the
device and the sampled answers are compared with it byte for byte."""

from __future__ import annotations

import random
import sys

import numpy as np
import torch

from codecbench import reference, roofline, variation

SPANS = (("huffmandecoderongpus_tpu_torch.ops.encode", "_prepare", "stage"),
         ("huffmandecoderongpus_tpu_torch.ops.encode", "_stage", "stage"))

#: pairs the file flips
PAIRS = 64


class Cell:
    def __init__(self, data, cfg, traffic, device, seed):
        from huffmandecoderongpus_tpu_torch.ops.encode import encode_lanes

        self.encode = encode_lanes
        self.device = str(device)
        n = data.numel()
        self.region = min(int(cfg["shuffle_block_bytes"]), n // 2)
        head = data[:self.region]
        hist = torch.bincount(data, minlength=256)
        a = int(torch.bincount(head, minlength=256).argmax())
        rare = torch.where(hist > 0, hist, hist.max() + 1)
        rare[a] = hist.max() + 1
        b = int(rare.argmin())
        traded = torch.where(head == a, b, torch.where(head == b, a, head))
        self.heads = [head.cpu().numpy().copy(),
                      traded.to(torch.uint8).cpu().numpy()]
        versions = [data, torch.cat([traded.to(torch.uint8),
                                     data[self.region:]])]
        self.data = data.cpu().numpy().copy()  # the next request's input
        pos = variation.pick_pairs(self.data, PAIRS, lo=self.region)
        self.trees, self.bits, self.swaps = [], [], []
        for version in versions:
            hist = torch.bincount(version, minlength=256).cpu().numpy()
            tree = reference.build_tree(hist)
            stats = reference.code_stats(tree, hist)
            _code, length, _present = reference.tree_codes(tree)
            self.trees.append(tree)
            self.bits.append(stats["bits"])
            self.swaps.append(variation.Swaps(
                self.data, pos, variation.bit_offsets(version, pos, length),
                tree))
        if np.array_equal(self.trees[0], self.trees[1]):
            raise ValueError("the traded block leaves the tree as it was")
        self.version = 0
        self.rng = random.Random(seed)
        print(f"[setup] {cfg['name']}: {n} bytes, {self.bits[0]} and "
              f"{self.bits[1]} bits, code height {stats['height']}",
              file=sys.stderr)

    @property
    def current(self) -> np.ndarray:
        """The next request's input."""
        return self.data

    @property
    def tree(self) -> np.ndarray:
        """The tree of the current input."""
        return self.trees[self.version]

    def warmup(self):
        self.encode(self.data, device=self.device)

    def prepare(self, i) -> dict:
        """Make request i's file in place; returns what its check needs."""
        version = self.rng.getrandbits(1)
        if version != self.version:
            self.data[:self.region] = self.heads[version]
            self.version = version
        state = self.swaps[0].draw(self.rng)
        self.swaps[0].move(state, self.data)
        return dict(version=version, state=state)

    def request(self, i):
        return self.encode(self.data, device=self.device)

    def glance(self, note: dict, hf) -> None:
        """Note the answer's header and its payload at one byte in
        ``STRIDE`` and at every flipped pair, to compare once the window
        has closed."""
        v = note["version"]
        payload = np.asarray(hf.payload, dtype=np.uint8).ravel()
        note["head"] = int(hf.bits != self.bits[v]
                           or hf.uncompressed_size != self.data.size
                           or not np.array_equal(hf.tree, self.trees[v]))
        want = (self.bits[v] + 7) // 8
        note["short"] = abs(payload.size - want)
        if note["short"]:
            note["short"] += min(payload.size, want)
            return
        note["offset"] = self.rng.randrange(variation.STRIDE)
        note["strided"] = payload[note["offset"]::variation.STRIDE].copy()
        note["pairs"] = self.swaps[v].pair_values(payload)

    def work(self, i) -> dict:
        out = (self.bits[self.version] + 7) // 8
        return dict(in_bytes=int(self.data.size), out_bytes=out,
                    moved_bytes=roofline.encode_bytes(self.data.size, out))

    def reference_payloads(self) -> list[np.ndarray]:
        """Each version's payload by the plain reference, no pair flipped."""
        self.swaps[0].move(0, self.data)
        out = []
        for v, tree in enumerate(self.trees):
            self.data[:self.region] = self.heads[v]
            got_tree, bits, payload = reference.encode(
                torch.from_numpy(self.data).to(self.device), tree)
            assert bits == self.bits[v] and got_tree is tree
            out.append(payload.cpu().numpy())
        self.version = len(self.trees) - 1
        return out

    def check(self, samples, notes):
        """Headers and glances of every answer, and each sampled answer's
        payload with every byte compared; the requests found wrong."""
        want = self.reference_payloads()
        glanced, heads, wrong = 0, 0, set()
        for i, note in notes.items():
            v, state = note["version"], note["state"]
            bad = note["short"]
            if not bad:
                flipped = self.swaps[v].payload_bytes(want[v], state)
                off = note["offset"]
                exp = want[v][off::variation.STRIDE].copy()
                for b, value in flipped.items():
                    if b >= off and (b - off) % variation.STRIDE == 0:
                        exp[(b - off) // variation.STRIDE] = value
                bad = int(np.count_nonzero(exp != note["strided"]))
                bad += sum(g != e for g, e in zip(
                    note["pairs"], self.swaps[v].expected_values(state)))
            glanced += bad
            heads += note["head"]
            if bad or note["head"]:
                wrong.add(i)
        bad = 0
        for i, hf in samples:
            v, state = notes[i]["version"], notes[i]["state"]
            exp = want[v].copy()
            for b, value in self.swaps[v].payload_bytes(want[v], state).items():
                exp[b] = value
            b = reference.bad_bytes(hf.payload, exp)
            bad += b
            if b:
                wrong.add(i)
        return {"bad_bytes": (bad, 0), "glanced_bad_bytes": (glanced, 0),
                "bad_headers": (heads, 0)}, wrong
