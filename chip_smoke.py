"""GPU smoke run of the PyTorch/CUDA lane-parallel codec: decode and encode.

    python3 chip_smoke.py

Needs one CUDA card, the CUDA toolkit (nvcc) and this repository.  Nine
seeded streams, drawn in this order from one generator:

  (a) kjv-sized text-like (min code length 2): K1-K4
  (b) 8 MiB over all 256 symbols (md 6, the wide quad table): K1-K4
  (c) 8 MiB, byte 0 at weight 300 over 256 (md 1, the wide pair table):
      the 1-bit k1_scan/k3_fix with K2/K4
  (d) kjv-sized text-like with a 256 KiB run of its most frequent byte:
      its lanes inside the run overflow the dense rows, so after K1-K4
      the decode falls back to the lane-DFA candidate_scan/lane_scan
  (e) 2,000 text-like bytes: too small for the wide lanes, the lane-DFA
      chain alone
  (f) paper1-sized text, 53,161 bytes (0.26 Mbit)
  (g) news-sized text, 377,109 bytes (1.83 Mbit)
  (h) 256 KiB over all 256 symbols (1.90 Mbit, md 6, the wide quad table)
  (i) 400,000 bytes uniform over 12 symbols (1.47 Mbit, md 3: odd-md slot
      splitting)
      (f)-(i) are under ONESHOT_MAX_BITS and one-shot eligible, so
      lane_wide decodes each in one launch of the fused kernel
  then, drawn after them: five paper1-sized text streams over 84, 64, 96,
  72 and 90 symbols (each its own tree) and a book2-sized text stream
  (610,856 bytes); (a), (b) and (i) encoded again with a `.huffidx` index of
  512, 1024 and 512 symbols a block, and (c) with one of 4096;
  and two encoder streams off the first plan: Fibonacci weights over 26
  symbols (24-bit deepest codes) with a tail run of the deepest symbol, at
  128 lanes, whose tail lanes overflow their dense rows, so encode_lanes
  runs E2 and E3 again with a larger ORP; and the same over 30 symbols
  (29-bit deepest codes, past E1's two 13-bit halves), which encode_lanes
  hands to encode_device; both on the card

Phases, each printing its own lines; any failure raises and exits non-zero:

  1. device   the card's name and power limit (nvidia-smi)
  2. build    the kernels from csrc/ with nvcc, and the build time
  3. kernels  each kernel against its plain torch version on the same CUDA
              inputs, at the shapes its decode path gives it: K1-K4 on (a),
              (b) and (d) (whose lanes overflow their rows, so (d) is not
              trimmed), k1_scan/K2/k3_fix/K4 on (c), with K1's plan, its
              own time on the card (profiler) and its chain floor (the
              longest lane's chunks x CHAIN_CYCLES_A_ROW) on (a), (b), (d)
              and K1''s (its bits to row B + H, a lookup a bit) on (c)
              ([k1] lines), K3''s card time beside its longest cut's
              floor on (c) ([k3]), K2's card time and kernel launches a call
              beside its bytes bound and the launch floor (P1's card time)
              on (a)-(d) and both batches ([k2] lines) and K4's own time
              on the card against its bytes bound ([k4] lines), both K1
              kernels also at their edges
              (probes.streams.K1_CASES: md 2 at G 512, md 6 with two table
              chunks at G 16,384, md 8, one candidate chain, a 128-tall
              tree at two G, lanes past the stream end, a blank run, a
              batch ending in pad lanes; a [k1] line each), K1' and K3'
              at theirs (probes.streams.K1P_CASES: a two-leaf tree, 128
              and 255 states, a 31-bit comb tree, 1 and 37 lanes, lanes
              past the stream end, a phase-locked run, (c)'s plan at an
              eighth, K3' cuts on a cell boundary, mid-cell and past the
              last segment; a [k1] and a [k3] line each),
              K4 also at its plan's edges (probes.streams.K4_CASES: one
              lane, three, a tail block, lanes past ORP, none valid, views
              at an offset, rows in windows), candidate_scan/
              lane_scan on (d), each scan also on the card (profiler) in
              cycles a bit row at the maximum SM clock beside the floor of
              its chain of dependent lookups (CHAIN_CYCLES_A_ROW), and at
              the edges of their staged bit tiles (TILE_CASES: one lane,
              lane counts that are not multiples of 16 or 32, the stream
              end mid-tile, misaligned matrices, rows= under one tile,
              trees 40 and 140 tall), the one-shot kernel on (f)-(i) (its whole
              dense rows, counts and total) and at its edges
              (probes.streams.ONESHOT_CASES: one candidate chain, md 8, a
              tree 128 tall, the envelope-edge stream, G = 128 and 4,096),
              the encoder's E1/E2/E3 on the
              staging of (a)-(c) and (e)-(i), with an [e1] and an [e2]
              line each (the plan, the card time (profiler, taken in a
              fresh process of this script run with --encode-card-ms,
              which prints it as JSON and exits) and the bytes bound),
              E1 and E2 also at their edges (probes.streams.
              E_CASES: all 256 symbols, 26-bit codes, a one-symbol tree,
              lanes with no symbol, row blocks starting in pad rows and
              inside a granule, the overflow stream; E2 also at an ORP
              that drops ranks, E_SMALL_ORP); K1's main scan
              (k1_main) and K4 on the indexed (a), (b) and (i) (a [k1]
              line each: card ms, plan, chain floor), k1_main also at its
              edges (probes.streams.K1_MAIN_CASES: every block ending on
              the last bit of steps_p beside pad lanes, one lane, md 3, 5
              and 7, NS 2 and 8) and K2 at the edges of its tiles
              (K2_CASES: one lane, part tiles, HP 128 from start 127,
              entries past HP, 65 tiles, merged maps), the
              indexed lane scan on the indexed (a) and (c); the batched
              K1/K3 (k1_scan2_c01, k3_fix2_c01), K2 and K4 on the five small
              streams and on (f), (g) and the book2-sized one (a [k1]
              line each); the
              self-synchronizing
              discovery's short candidate scan on the first round of (a)
              and (d) in lane_dfa_sync's geometry (all five outputs), and
              the lane scan cut at that round's W rows (its fix scan) from
              the true entry offsets; the dense lane decode on (a) and (d)
              in the tiled geometry from the entry offsets of
              candidate_scan + compose, and the compaction on (d) from
              cumsum(valid) and sym of the lane scan, each trimmed by its
              counts to the input; bit-exact (tolerance 0), with both
              times from CUDA events (and for the compaction the time of
              torch.searchsorted + gather, the same function in library
              calls)
  4. slice    get_decoder("lane_wide", device="cuda") on each stream, the
              launch counts set to 0 just before and read just after:
              bytes equal to the input, and each stream's kernels launched
              ((d) through the fallback, (f)-(i) the one-shot alone); then
              get_decoder("lane_oneshot", ...) on (f)-(i) and on (c), which
              falls back to lane_wide's md = 1 kernels; decode_widescan on
              two trees of exactly 128 internal states (129 symbols, md 1
              and md >= 2, seed 1) through the four kernels and, for md >=
              2, the one-shot, each decode counted on its own; then for (a)-(c)
              the device program's median time over 25 runs (CUDA events)
              and its device time by kernel (torch.profiler), for (f)-(i)
              the one-shot and the four-kernel program the same way, and
              the decode wall time (host clock) of (a)-(d) and of both
              routes of (f)-(i), and an [oneshot] line each: the kernel's
              card time (profiler), its phases, K1's chain floor (the
              longest lane's chunks x CHAIN_CYCLES_A_ROW) and the
              four-kernel program's time.  Then
              encode_lanes(..., device="cuda") on (a)-(i), the launch
              counts set to 0 just before and read just
              after: E1, E2 and E3 once each, no host fallback, payload,
              bits and tree equal to the host encode_bytes; lane_wide
              decodes the device-encoded (a), (c) and (f) back to their
              input; the overflow stream re-runs E2 and E3 on the card
              (E1 once, E2 and E3 twice, one retry) and the long-code
              stream goes to encode_device (no E1-E3, one retry), both
              byte-equal; encode_device on (a) is byte-equal.  For
              (a)-(c): the encode program's median time (CUDA events) and
              split by kernel (torch.profiler), and the walls (host clock)
              of the histogram and tree, the whole staging, encode_lanes,
              encode_device and the host encode_bytes.
              The indexed route, each decode counted on its own:
              decode_widescan_indexed on the indexed (a), (b) and (i)
              launches k1_main and K4 once each and nothing else; the
              encode command writes (a) with --index 512, and
              get_decoder("lane_dfa") on the file read back with its
              sidecar launches the indexed lane scan alone; (c)'s index is
              refused by the wide program (EnvelopeError) and lane_dfa
              decodes it through the scan; the indexed program timed
              against the discovery program and split by kernel
              (torch.profiler), with the walls of both.
              The batch route: decode_widescan_batch on the five small
              streams, and with auto_split=False on (f), (g) and the
              book2-sized one, launches k1_scan2_c01, K2, k3_fix2_c01 and
              K4 once each; with (a) added and auto_split on, (a) decodes
              alone through K1-K4; a batch holding (h) (255 states),
              auto_split=False, raises EnvelopeError; each batch program
              and each member's routed solo program timed (CUDA events),
              the batch program split by kernel, and the walls of both.
              The sync route, each decode counted on its own:
              get_decoder("lane_dfa_sync") on (a), (d) and (e) launches the
              short candidate scan once a round, the lane scan once (and
              once more for its fix scan), candidate_scan once (the tail
              lane) and nothing else, with the rounds printed;
              decode_lanedfa_tiled(discovery="sync") on (a) the same; the
              dense pipeline on (a) and (d) (candidate_scan, compose,
              lane_decode_dense) and the compaction pipeline on (d)
              (candidate_scan, compose, lane_scan, compact), each kernel
              once; then for (a) and (d) the device time of sync discovery
              (0-chain to splice) beside candidate discovery and
              candidate_scan alone (CUDA events), sync split by kernel,
              and the walls of lane_dfa_sync and lane_dfa
  5. probes   the four probe kernels (probe_inc, probe_arith, probe_gather,
              k4_stripped) against their plain versions at every shape of
              the scripts/ sites they replace (the chained gathers also on
              seeded inputs whose rows differ), bit-exact, with kernel,
              plain and library times and their bounds (bytes, or integer
              ops and shared-memory loads at the card's peak rates and its
              maximum SM clock); then the six probe programs
              (probes.run: dispatch, k1fixed on (f) and (a), k4 on (a),
              gather, vpu, vpu2), the probe kernels' launch counts set to
              0 just before and read just after, each kernel launched and
              no line WRONG; then the prof command's breakdown of (a)
              widescan and (d) lanedfa, every stage present and >= 0; then
              the host's split of a probe_inc launch (probes.hw_dispatch:
              checks, output, library, stream, pointers, ctypes call,
              launch, check, each timed over 1,000 calls), on the wrappers'
              path and on one that makes a Python object at each step, and
              the host's time a whole call of probe_inc, probe_gather and
              probe_roll beside x + 1, torch.gather and torch.roll.
              P1 and P3 are timed in turns with their PyTorch call (x + 1,
              torch.gather, torch.roll), both also on the card (profiler)
  6. result   one JSON line for the twenty-three kernels (times, launches,
              error, and the bound: the bytes each must move at 3.35 TB/s,
              or the operations it does), the card,
              then the last line {"ok": true, "device": {...}}
"""

from __future__ import annotations

import json
import pathlib
import statistics
import subprocess
import sys
import time

import numpy as np

from huffmandecoderongpus_tpu_torch.harness.timing import event_ms
from huffmandecoderongpus_tpu_torch.probes.streams import (
    KJV_BYTES,
    PAPER1_BYTES,
    text_like,
)

SEED = 0
#: the text streams are ``probes.streams.text_like``: Zipf(1.1) over 84
#: symbols, kjv's tree shape (min code length 2, height 9, 83 states); (a)
#: and (d) at the size of kjv.txt (KJV_BYTES)
WIDE_BYTES = 8 << 20
#: stream (d): bytes [RUN_START, RUN_END) of a kjv-sized stream set to its
#: most frequent byte
RUN_START, RUN_END, RUN_BYTE = 2_621_440, 2_883_584, 32
TINY_BYTES = 2000
#: the trees of exactly 128 internal states (129 symbols, drawn from seed
#: 1), which the port packs compact in one table chunk
STATES128_BYTES = 60_000
#: the one-shot streams (f)-(i): paper1- (PAPER1_BYTES) and news-sized
#: text, 256 KiB over all 256 symbols, 400,000 bytes uniform over 12 symbols
NEWS_BYTES = 377_109
ALPHA_BYTES = 256 << 10
UNIFORM12_BYTES = 400_000
#: the indexed streams and their index's symbols a block; the md = 1 stream
#: whose index the wide program refuses and lane_dfa decodes
INDEXED = {"a": 512, "b": 1024, "i": 512}
INDEXED_MD1 = ("c", 4096)
#: the batch streams: five paper1-sized text streams over these alphabet
#: sizes, and a book2-sized text stream with (f) and (g) (the JAX package's
#: ``batch`` suite: paper1, news, book2)
BATCH_SYMBOLS = (84, 64, 96, 72, 90)
BOOK2_BYTES = 610_856
#: the lane-DFA scans at the tiling's edge cases (check_scan_tiles): stream,
#: lanes, and "cut" (the stream end mid-tile) or "views" (misaligned copies
#: and a rows= cut under one tile).  (e) at one lane is sync discovery's
#: tail column; 3, 20 and 100 lanes are not multiples of 16 or 32 (under 32
#: one block holds every lane and copies whole rows); the comb
#: trees are 40 and 140 tall (L*H past 1024 threads at 32 lanes)
TILE_CASES = (("e", 1, None), ("e", 3, "cut"), ("e", 20, "cut"),
              ("e", 20, "views"),
              ("f", 100, "cut"), ("f", 64, "views"), ("comb40", 48, None),
              ("comb140", 8, "cut"))
#: symbols of the comb-tree streams, and the run of the deepest code in
#: their middle
COMB_BYTES, COMB_DEEP = 6000, 20
#: cycles a bit row of a lane-DFA scan's chain: a dependent shared-memory
#: lookup (30-38 cycles) and two dependent integer ops (about 5 each), as
#: the probes measured them (PERF.md); the one-shot's K1 floor takes the
#: same a 2-bit chunk of its main chain (one quad-table lookup)
CHAIN_CYCLES_A_ROW = 40
#: the card's memory rate (bytes/s): NVIDIA's data sheet, H100 SXM
HBM_BYTES_PER_S = 3.35e12
#: the card's peak rates an SM a clock for the operation-bound probes: a
#: 32-bit integer instruction a lane at the FP32 lanes' rate (128: each of
#: the four sub-partitions issues one warp instruction a clock, and the
#: compiler sends integer adds to the FMA pipe as IMAD beside the 64 INT32
#: lanes; 132 SMs x 128 x 1.98 GHz is 33.5 T a second, half the 67 TFLOP/s
#: float32 peak, which counts an FMA as two), and a 4-byte shared-memory
#: load (32 banks a clock)
OPS_PER_SM_CLOCK = {"int32": 128, "shared loads": 32}
TIMED_RUNS = 25
WARMUP = 3
WALL_RUNS = 10
#: host-clock runs of the numpy encoder, timed as context only
HOST_RUNS = 3
#: the encoder overflow stream: Fibonacci weights over FIB_SYMBOLS symbols,
#: FIB_BODY symbols drawn from them, then FIB_DEEP copies of the deepest
FIB_SYMBOLS, FIB_BODY, FIB_DEEP = 26, 16000, 600
#: symbols of the long-code stream: its deepest codes are 29 bits
LONG_SYMBOLS = 30

DEVICE = "cuda"

_CSRC = "huffmandecoderongpus_tpu_torch/csrc/"
_PWS = "huffmandecoderongpus_tpu/ops/pallas_widescan.py:"
_PLD = "huffmandecoderongpus_tpu/ops/pallas_lanedfa.py:"
_PEN = "huffmandecoderongpus_tpu/ops/pallas_encode.py:"
#: phase-3 results of the indexed and batch checks are keyed by these
IDX = {k: f"{k}@{K}" for k, K in (*INDEXED.items(), INDEXED_MD1)}
#: and those of the sync discovery's checks (lane_dfa_sync's geometry)
SYNC = {k: f"{k} sync" for k in "ad"}
BATCH5, TRIO = "five small", "paper1+news+book2"
#: name -> (CUDA source, the TPU kernel it replaces, the stream whose times
#: the result line reports)
KERNELS = {
    "k1_scan2": (_CSRC + "k1_scan2.cu", _PWS + "769", "a"),
    "k2_compose": (_CSRC + "k2_compose.cu", _PWS + "1254", "a"),
    "k3_fix2": (_CSRC + "k3_fix2.cu", _PWS + "1456", "a"),
    "k4_compact": (_CSRC + "k4_compact.cu", _PWS + "1617", "a"),
    "k1_scan": (_CSRC + "k1_scan.cu", _PWS + "347", "c"),
    "k3_fix": (_CSRC + "k3_fix.cu", _PWS + "1319", "c"),
    "candidate_scan": (_CSRC + "candidate_scan.cu", _PLD + "296", "d"),
    "lane_scan": (_CSRC + "lane_scan.cu", _PLD + "74", "d"),
    "oneshot": (_CSRC + "oneshot.cu",
                "huffmandecoderongpus_tpu/ops/pallas_oneshot.py:62", "g"),
    "e1_pack": (_CSRC + "e1_pack.cu", _PEN + "92", "a"),
    "e2_compact": (_CSRC + "e2_compact.cu", _PEN + "195", "a"),
    "e3_place": (_CSRC + "e3_place.cu", _PEN + "308", "a"),
    "k1_main": (_CSRC + "k1_main.cu", _PWS + "819", IDX["a"]),
    "lane_scan_indexed": (_CSRC + "lane_scan_indexed.cu", _PLD + "393",
                          IDX["a"]),
    "k1_scan2_c01": (_CSRC + "k1_scan2_c01.cu", _PWS + "762", TRIO),
    "k3_fix2_c01": (_CSRC + "k3_fix2_c01.cu", _PWS + "1449", TRIO),
    "short_candidate_scan": (
        _CSRC + "short_candidate_scan.cu",
        "huffmandecoderongpus_tpu/ops/lanedfa_sync.py:50", SYNC["d"]),
    "lane_decode_dense": (_CSRC + "lane_decode_dense.cu", _PLD + "230", "d"),
    "compact": (_CSRC + "compact.cu", _PLD + "520", "d"),
}
#: the probe kernels: name -> (CUDA source, the script site it replaces, the
#: start of the shape whose numbers the result line reports)
PROBE_KERNELS = {
    "probe_inc": (_CSRC + "probe_inc.cu", "scripts/hw_dispatch.py:52",
                  "(8,128)"),
    "probe_arith": (_CSRC + "probe_arith.cu", "scripts/probe_vpu2.py:62",
                    "xor3 P=8"),
    "probe_gather": (_CSRC + "probe_gather.cu", "scripts/probe_gather.py:26",
                     "axis1 (256,1536)"),
    "k4_stripped": (_CSRC + "k4_stripped.cu", "scripts/hw_k4probe.py:120",
                    "prefix"),
}
#: the kernels of the indexed wide program and of the batched program,
#: once each a decode
INDEXED_PATH = ("k1_main", "k4_compact")
BATCH_PATH = ("k1_scan2_c01", "k2_compose", "k3_fix2_c01", "k4_compact")
#: the encoder's kernels, which encode_lanes must launch once each
ENCODE_PATH = ("e1_pack", "e2_compact", "e3_place")
#: the streams whose staging phase 3 runs E1-E3 on, and those whose
#: device-encoded stream lane_wide decodes in phase 4
ENCODE_CHECKED = "abcefghi"
ENCODE_DECODED = "acf"
#: the one-shot streams
ONESHOT = "fghi"
MD1_PATH = ("k1_scan", "k2_compose", "k3_fix", "k4_compact")
#: the kernels each stream's decode must launch, once each
PATHS = {
    "a": ("k1_scan2", "k2_compose", "k3_fix2", "k4_compact"),
    "b": ("k1_scan2", "k2_compose", "k3_fix2", "k4_compact"),
    "c": MD1_PATH,
    "d": ("k1_scan2", "k2_compose", "k3_fix2", "k4_compact",
          "candidate_scan", "lane_scan"),
    "e": ("candidate_scan", "lane_scan"),
    **{k: ("oneshot",) for k in ONESHOT},
}
#: the streams lane_dfa_sync decodes in phase 4, and the kernels of the
#: dense and the compaction pipelines, once each
SYNC_DECODED = "ade"
DENSE_PATH = ("candidate_scan", "lane_decode_dense")
COMPACT_PATH = ("candidate_scan", "lane_scan", "compact")
#: the kernels get_decoder("lane_oneshot") must launch, once each
ONESHOT_PATHS = {"c": MD1_PATH, **{k: ("oneshot",) for k in ONESHOT}}

#: device function names of each kernel
DEVICE_SYMBOLS = {"k1_scan2": ("k1_scan2_kernel",),
                  "k2_compose": ("k2_compose_kernel",),
                  "k3_fix2": ("k3_fix2_kernel",),
                  "k4_compact": ("k4_compact_kernel",),
                  "k1_scan": ("k1_scan_kernel",),
                  "k3_fix": ("k3_fix_kernel",),
                  "oneshot": ("oneshot_kernel",),
                  "e1_pack": ("e1_pack_kernel",),
                  "e2_compact": ("e2_compact_kernel",),
                  "e3_place": ("e3_place_kernel",),
                  "k1_main": ("k1_main_kernel",),
                  "k1_scan2_c01": ("k1_scan2_c01_kernel",),
                  "k3_fix2_c01": ("k3_fix2_c01_kernel",),
                  # before candidate_scan: its name holds candidate_scan's
                  "short_candidate_scan": ("short_candidate_scan_kernel",),
                  "candidate_scan": ("candidate_scan_kernel",),
                  "lane_scan": ("lane_scan_kernel",),
                  "lane_decode_dense": ("lane_decode_dense_kernel",),
                  "compact": ("lanedfa_compact_kernel",)}


def full_alphabet(rng, n):
    w = rng.random(256) ** 3 + 1e-4
    return rng.choice(np.arange(256, dtype=np.uint8), size=n,
                      p=w / w.sum()).astype(np.uint8)


def dominant_byte(rng, n):
    w = np.full(256, 1.0)
    w[0] = 300.0
    return rng.choice(np.arange(256, dtype=np.uint8), size=n,
                      p=w / w.sum()).astype(np.uint8)


def uniform12(rng, n):
    return rng.choice(np.arange(65, 77, dtype=np.uint8), size=n).astype(
        np.uint8)


def with_run(raw):
    raw[RUN_START:RUN_END] = RUN_BYTE
    return raw


def fib_stream(rng, build_tree, n_sym):
    """(raw, tree) of an encoder stream off the first plan: the tree from
    Fibonacci weights over ``n_sym`` symbols (not the sample), so the tail
    symbol keeps its deepest code however often it appears."""
    fib = [1, 1]
    while len(fib) < n_sym:
        fib.append(fib[-1] + fib[-2])
    counts = np.array(fib[::-1], dtype=np.int64)
    body = rng.choice(np.arange(n_sym, dtype=np.uint8), size=FIB_BODY,
                      p=counts / counts.sum()).astype(np.uint8)
    raw = np.concatenate([body, np.full(FIB_DEEP, n_sym - 1,
                                        dtype=np.uint8)])
    freqs = np.zeros(256, dtype=np.int64)
    freqs[:n_sym] = counts
    return raw, build_tree(freqs)


def draw_streams(rng):
    """{key: (name, raw)} of the streams (a)-(i), drawn from ``rng`` in
    this order (the batch streams are drawn after them)."""
    streams = {"a": ("kjv-sized text", text_like(rng, KJV_BYTES)),
               "b": ("8MiB full-alphabet", full_alphabet(rng, WIDE_BYTES))}
    streams["c"] = ("8MiB dominant byte", dominant_byte(rng, WIDE_BYTES))
    streams["d"] = ("kjv-sized text with a blank run",
                    with_run(text_like(rng, KJV_BYTES)))
    streams["e"] = ("2000-byte text", text_like(rng, TINY_BYTES))
    streams["f"] = ("paper1-sized text", text_like(rng, PAPER1_BYTES))
    streams["g"] = ("news-sized text", text_like(rng, NEWS_BYTES))
    streams["h"] = ("256KiB full-alphabet", full_alphabet(rng, ALPHA_BYTES))
    streams["i"] = ("400KB uniform over 12", uniform12(rng, UNIFORM12_BYTES))
    return streams


def max_abs_err(torch, got, want) -> int:
    err = 0
    for g, w in zip(got, want):
        if g.shape != w.shape or g.dtype != w.dtype:
            raise AssertionError(f"shape/dtype {g.shape} {g.dtype} vs "
                                 f"{w.shape} {w.dtype}")
        d = (g.to(torch.int64) - w.to(torch.int64)).abs()
        err = max(err, int(d.max()) if d.numel() else 0)
    return err


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def k3_moved(tab, cut, cut_slot) -> int:
    """Bytes K3 must move on these inputs: the entries, cuts and cut slots
    (12 a lane), the table, and for each lane it fixes the words up to its
    cut and the cells below its cut slot (4 slots a cell, 4 symbol bytes
    and a nibble byte each), written once."""
    fixed = cut > 0
    words = int(((cut[fixed].long() + 31) // 32).sum()) * 4
    cells = int(((cut_slot[fixed].long() + 3) // 4).sum()) * 5
    return 12 * cut.numel() + nbytes(tab) + words + cells


def comparer(torch, name, rows):
    """compare(kname, kernel, plain, inputs, moved=None): run both on the
    same inputs, record {err, ms, plain_ms, bound_ms, bound_by} in ``rows``
    and raise on any difference; returns the kernel's outputs.  The bound
    is the least time the card's memory rate allows for the bytes the
    kernel must move: ``moved``, or else each of ``inputs`` read once and
    each output written once."""

    def compare(kname, kernel, plain, inputs, moved=None):
        got = kernel()
        torch.cuda.synchronize()
        want = plain()
        torch.cuda.synchronize()
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        err = max_abs_err(torch, got, want)
        ms = statistics.median(event_ms(kernel, 20))
        plain_ms = statistics.median(event_ms(plain, 2))
        if moved is None:
            moved = nbytes(*inputs, *got)
        bound_ms = moved / HBM_BYTES_PER_S * 1e3
        rows[kname] = dict(err=err, ms=ms, plain_ms=plain_ms,
                           bound_ms=bound_ms, bound_by="bytes")
        print(f"[kernels] {name}: {kname} max_abs_err {err} (tolerance 0) "
              f" kernel {ms:.4f} ms  plain {plain_ms:.4f} ms  bound "
              f"{bound_ms:.6f} ms ({moved} bytes)", flush=True)
        if err:
            raise AssertionError(f"{kname} differs from its plain version")
        return got

    return compare


def check_kernels(torch, name, raw, hf, dev, decodes=True):
    """Phase 3 on one stream of the wide program: K1-K4 (the 1-bit K1/K3
    for md = 1) against their plain versions on the inputs the slice gives
    them, then K4's own time on the card (profiler) against its bytes bound
    (a [k4] line).  Returns {kernel: (max_abs_err, kernel ms, plain ms)}
    and raises on any difference, or, with ``decodes``, unless the dense
    rows trimmed by the counts are the input (a stream whose lanes overflow
    their rows, as (d)'s, is checked kernel by kernel only)."""
    from huffmandecoderongpus_tpu_torch.ops import (
        k1_scan,
        k1_scan2,
        k2_compose,
        k3_fix,
        k3_fix2,
        k4_compact,
    )
    from huffmandecoderongpus_tpu_torch.ops import widescan as ws

    st = ws.stage_widescan_inputs(hf, device=dev)
    p = st["plan"]
    print(f"[kernels] {name}: {hf.bits} bits, G={p['G']} B={p['B']} "
          f"H={st['H']} md={st['md']} NS={st['NS']}", flush=True)
    wmat = ws.words_matrix(st["words"], -(-p["steps_p"] // 32))
    kw = dict(steps_p=p["steps_p"], SEG=p["SEG"], md=st["md"], NS=st["NS"])
    if st["chunk2"]:
        kw.update(C0=st["C0"], C1=st["C1"])
        scan = ("k1_scan2", k1_scan2.k1_scan2, k1_scan2.k1_scan2_ref)
        fix = ("k3_fix2", k3_fix2.k3_fix2, k3_fix2.k3_fix2_ref)
    else:
        scan = ("k1_scan", k1_scan.k1_scan, k1_scan.k1_scan_ref)
        fix = ("k3_fix", k3_fix.k3_fix, k3_fix.k3_fix_ref)
    k1a = dict(B=p["B"], H=st["H"], steps=p["steps"], **kw)
    rows = {}
    compare = comparer(torch, name, rows)
    sym, val, cntmap, exmap, mrowmap = compare(
        scan[0], lambda: scan[1](wmat, st["tab"], st["lim"], **k1a),
        lambda: scan[2](wmat, st["tab"], st["lim"], **k1a),
        (wmat, st["tab"], st["lim"]))
    if st["chunk2"]:
        k1_line(torch, name, "k1_scan2", lambda: scan[1](
            wmat, st["tab"], st["lim"], **k1a), st["lim"], k1a, rows)
    else:
        k1p_line(torch, name, lambda: scan[1](
            wmat, st["tab"], st["lim"], **k1a), st["lim"], k1a, rows)
    entry, _tot = compare("k2_compose",
                          lambda: k2_compose.k2_compose(exmap, 0),
                          lambda: k2_compose.k2_compose_ref(exmap, 0),
                          (exmap,))
    k2_line(torch, name, lambda: k2_compose.k2_compose(exmap, 0), exmap, rows)
    cut, cut_slot = ws.fix_rows(entry, mrowmap, st["lim"], st["H"], st["md"])
    # K3 splices in place and is idempotent on its own output, so repeated
    # timing runs on one copy do the same work
    s_k, v_k = sym.clone(), val.clone()
    s_p, v_p = sym.clone(), val.clone()
    msym, mval = compare(
        fix[0],
        lambda: fix[1](wmat, st["tab"], entry, cut, cut_slot, s_k, v_k, **kw),
        lambda: fix[2](wmat, st["tab"], entry, cut, cut_slot, s_p, v_p, **kw),
        (), moved=k3_moved(st["tab"], cut, cut_slot))
    if not st["chunk2"]:
        k3_line(torch, name, lambda: fix[1](
            wmat, st["tab"], entry, cut, cut_slot, s_k, v_k, **kw), cut,
            p["steps_p"], rows)
    (denseT,) = compare("k4_compact",
                        lambda: k4_compact.k4_compact(msym, mval, ORP=p["ORP"]),
                        lambda: k4_compact.k4_compact_ref(msym, mval,
                                                          ORP=p["ORP"]),
                        (msym, mval))
    card_ms = device_breakdown(torch, lambda: k4_compact.k4_compact(
        msym, mval, ORP=p["ORP"]), per_launch=True).get("k4_compact")
    k4 = rows["k4_compact"]
    k4["device_ms"] = card_ms
    plan = k4_compact.k4_plan(p["G"], msym.shape[0], p["ORP"],
                              msym.data_ptr(), mval.data_ptr())
    card = ("not measured" if card_ms is None else
            f"{card_ms:.4f} ms (profiler), {card_ms / k4['bound_ms']:.1f} "
            "times the bound")
    print(f"[k4] {name}: card {card}; events {k4['ms']:.4f} ms; bytes "
          f"bound {k4['bound_ms']:.6f} ms; G={p['G']} cells "
          f"{msym.shape[0]} ORP={p['ORP']}; plan {plan}", flush=True)
    if not decodes:
        print(f"[kernels] {name}: all four bit-exact", flush=True)
        return rows
    n = ws.select_h(cntmap, entry, st["H"])
    mask = torch.arange(p["ORP"], device=dev)[None, :] < n[:, None]
    if not np.array_equal(denseT[mask].cpu().numpy(), raw):
        raise AssertionError(f"{name}: the kernels' stages decoded wrong")
    print(f"[kernels] {name}: all four bit-exact; stream decoded", flush=True)
    return rows


def k1_line(torch, name, kname, kernel, lim, kw, rows):
    """A [k1] line for one K1 launch (``kernel()``, K1 ``kname`` on lanes
    of limits ``lim`` and keyword arguments ``kw``): its plan (T, lanes a
    block, blocks, waves, shared bytes), its card time (profiler, the mean
    a launch) and events time, and the chain floor: the longest lane's
    2-bit chunks x CHAIN_CYCLES_A_ROW at the maximum SM clock.  The card
    time goes into rows[kname] as device_ms."""
    from huffmandecoderongpus_tpu_torch.ops import _build
    from huffmandecoderongpus_tpu_torch.ops.k1_scan2 import k1_plan
    from huffmandecoderongpus_tpu_torch.probes._timing import sm_clock_mhz

    plan = k1_plan(lim.shape[0], kw["H"], kw["md"], kw["SEG"],
                   kw["steps_p"], kw.get("NS", 1), _build.sm_count(lim.device))
    card_ms = device_breakdown(torch, kernel, per_launch=True).get(kname)
    clock = sm_clock_mhz(DEVICE)[1] * 1e6
    chunks = min(int(lim.max()), kw["steps_p"]) // 2
    floor_ms = chunks * CHAIN_CYCLES_A_ROW / clock * 1e3
    rows[kname]["device_ms"] = card_ms
    card = ("not measured" if card_ms is None else
            f"{card_ms:.4f} ms (profiler), {card_ms / floor_ms:.1f} times "
            "the floor")
    print(f"[k1] {name}: {kname} card {card}; events "
          f"{rows[kname]['ms']:.4f} ms; chain floor {floor_ms:.4f} ms "
          f"({chunks} chunks x {CHAIN_CYCLES_A_ROW} cycles at "
          f"{clock / 1e6:.0f} MHz); plan T={plan['T']} lanes "
          f"{plan['lanes']} blocks {plan['blocks']} waves {plan['waves']} "
          f"shared {plan['shared']} on {plan['sm_count']} SMs; G="
          f"{lim.shape[0]} H={kw['H']} md={kw['md']} NS={kw.get('NS', 1)}",
          flush=True)


def k1p_line(torch, name, kernel, lim, kw, rows):
    """A [k1] line for one k1_scan launch (``kernel()`` on lanes of limits
    ``lim`` and keyword arguments ``kw``): its plan (T, lanes a block,
    blocks, waves, shared bytes), its card time (profiler, the mean a
    launch) and events time, and the chain floor: the longest lane's bits
    to row steps (B + H) x CHAIN_CYCLES_A_ROW at the maximum SM clock, one
    lookup a bit.  The card time goes into rows["k1_scan"] as device_ms."""
    from huffmandecoderongpus_tpu_torch.ops import _build
    from huffmandecoderongpus_tpu_torch.ops.k1_scan import k1_scan_plan
    from huffmandecoderongpus_tpu_torch.probes._timing import sm_clock_mhz

    plan = k1_scan_plan(lim.shape[0], kw["H"], kw["steps_p"], kw["NS"],
                        _build.sm_count(lim.device))
    card_ms = device_breakdown(torch, kernel, per_launch=True).get("k1_scan")
    clock = sm_clock_mhz(DEVICE)[1] * 1e6
    bits = max(min(int(lim.max()), kw["steps"]), 0)
    floor_ms = bits * CHAIN_CYCLES_A_ROW / clock * 1e3
    rows["k1_scan"]["device_ms"] = card_ms
    card = ("not measured" if card_ms is None else
            f"{card_ms:.4f} ms (profiler), {card_ms / floor_ms:.1f} times "
            "the floor" if floor_ms else f"{card_ms:.4f} ms (profiler)")
    print(f"[k1] {name}: k1_scan card {card}; events "
          f"{rows['k1_scan']['ms']:.4f} ms; chain floor {floor_ms:.4f} ms "
          f"({bits} bits x {CHAIN_CYCLES_A_ROW} cycles at "
          f"{clock / 1e6:.0f} MHz); plan T={plan['T']} lanes "
          f"{plan['lanes']} blocks {plan['blocks']} waves {plan['waves']} "
          f"shared {plan['shared']} on {plan['sm_count']} SMs; G="
          f"{lim.shape[0]} H={kw['H']} md=1 NS={kw['NS']}", flush=True)


def k3_line(torch, name, kernel, cut, steps_p, rows):
    """A [k3] line for one k3_fix launch (``kernel()`` on cut rows
    ``cut``): its card time (profiler, the mean a launch) and events time
    beside the chain floor: the longest cut in bits (at most steps_p) x
    CHAIN_CYCLES_A_ROW at the maximum SM clock.  The card time goes into
    rows["k3_fix"] as device_ms."""
    from huffmandecoderongpus_tpu_torch.probes._timing import sm_clock_mhz

    card_ms = device_breakdown(torch, kernel, per_launch=True).get("k3_fix")
    clock = sm_clock_mhz(DEVICE)[1] * 1e6
    longest = int(cut.clamp(0, steps_p).max()) if cut.numel() else 0
    floor_ms = longest * CHAIN_CYCLES_A_ROW / clock * 1e3
    rows["k3_fix"]["device_ms"] = card_ms
    card = ("not measured" if card_ms is None else
            f"{card_ms:.4f} ms (profiler), {card_ms / floor_ms:.1f} times "
            "the floor" if floor_ms else f"{card_ms:.4f} ms (profiler)")
    print(f"[k3] {name}: k3_fix card {card}; events "
          f"{rows['k3_fix']['ms']:.4f} ms; longest cut {longest} bits, "
          f"chain floor {floor_ms:.4f} ms ({CHAIN_CYCLES_A_ROW} cycles a bit "
          f"at {clock / 1e6:.0f} MHz); lanes fixed "
          f"{int((cut > 0).sum())} of {cut.numel()}", flush=True)


_launch_floor = []


def launch_floor_ms(torch, dev):
    """The card time of one launch of P1 (``probe_inc`` on an (8, 128)
    int32 tensor, profiler), measured once a run: the least a kernel
    launch takes on the card (None: not measured)."""
    from huffmandecoderongpus_tpu_torch.ops import probe_inc

    if not _launch_floor:
        x = torch.zeros((8, 128), dtype=torch.int32, device=dev)
        _launch_floor.append(device_breakdown(
            torch, lambda: probe_inc.probe_inc(x), per_launch=True,
            symbols={"probe_inc": ("probe_inc_kernel",)}).get("probe_inc"))
    return _launch_floor[0]


def k2_line(torch, name, kernel, exmap, rows):
    """A [k2] line for one K2 call (``kernel()`` on the (HP, G) maps
    ``exmap``): its card time a launch and kernel launches a call
    (profiler), its events time, its plan, and beside its bytes bound the
    launch floor (``launch_floor_ms``), which a bound under a microsecond
    says nothing without.  The card time a launch goes into
    rows["k2_compose"] as device_ms, the launches as kernels_a_call."""
    from huffmandecoderongpus_tpu_torch.ops import _build
    from huffmandecoderongpus_tpu_torch.ops.k2_compose import k2_plan

    HP, G = exmap.shape
    floor = launch_floor_ms(torch, exmap.device)
    plan = k2_plan(G, HP, _build.sm_count(exmap.device))
    times, launches = device_breakdown(torch, kernel, per_launch=True,
                                       counts=True)
    card_ms, per_call = times.get("k2_compose"), launches.get("k2_compose")
    row = rows["k2_compose"]
    row["device_ms"], row["kernels_a_call"] = card_ms, per_call
    card = ("not measured" if card_ms is None else
            f"{card_ms:.4f} ms a launch")
    calls = "not measured" if per_call is None else per_call
    print(f"[k2] {name}: card {card}, {calls} kernel launches a call; "
          f"events {row['ms']:.4f} ms; bytes bound "
          f"{row['bound_ms']:.6f} ms, launch floor "
          f"{'not measured' if floor is None else f'{floor:.5f} ms'}; "
          f"plan tile {plan['tile']} sub {plan['sub']} threads "
          f"{plan['threads']} tiles {plan['tiles']} waves {plan['waves']} "
          f"shared {plan['shared']}; G={G} HP={HP}", flush=True)


def k1_main_line(torch, name, kernel, lim, kw, rows):
    """A [k1] line for one k1_main launch (``kernel()`` on lanes of limits
    ``lim``, keyword arguments ``kw``): its plan, its card time (profiler,
    the mean a launch), events time and the chain floor (the longest
    lane's 2-bit chunks x CHAIN_CYCLES_A_ROW at the maximum SM clock).
    The card time goes into rows["k1_main"] as device_ms."""
    from huffmandecoderongpus_tpu_torch.ops import _build
    from huffmandecoderongpus_tpu_torch.ops.k1_main import k1_main_plan
    from huffmandecoderongpus_tpu_torch.probes._timing import sm_clock_mhz

    G = lim.shape[0]
    plan = k1_main_plan(G, kw["md"], kw["NS"], kw["steps_p"],
                        _build.sm_count(lim.device))
    card_ms = device_breakdown(torch, kernel, per_launch=True).get("k1_main")
    clock = sm_clock_mhz(DEVICE)[1] * 1e6
    chunks = min(int(lim.max()), kw["steps_p"]) // 2
    floor_ms = chunks * CHAIN_CYCLES_A_ROW / clock * 1e3
    rows["k1_main"]["device_ms"] = card_ms
    card = ("not measured" if card_ms is None else
            f"{card_ms:.4f} ms (profiler), {card_ms / floor_ms:.1f} times "
            "the floor")
    print(f"[k1] {name}: k1_main card {card}; events "
          f"{rows['k1_main']['ms']:.4f} ms; chain floor {floor_ms:.4f} ms "
          f"({chunks} chunks x {CHAIN_CYCLES_A_ROW} cycles at "
          f"{clock / 1e6:.0f} MHz); plan threads {plan['threads']} blocks "
          f"{plan['blocks']} waves {plan['waves']} shared {plan['shared']} "
          f"on {plan['sm_count']} SMs; G={G} md={kw['md']} NS={kw['NS']} "
          f"steps_p={kw['steps_p']}", flush=True)


def check_k1_main_cases(torch, dev):
    """Phase 3, K1's main scan at its edge cases
    (``probes.streams.K1_MAIN_CASES``: every block ending on the last bit
    of steps_p beside pad lanes, one lane, text at 512 symbols a block, md
    3, 5 and 7, NS 2 and 8) against its plain version.  Returns {case:
    rows}, as check_kernels."""
    from huffmandecoderongpus_tpu_torch.ops import k1_main
    from huffmandecoderongpus_tpu_torch.probes import streams as ps

    out = {}
    for case in ps.K1_MAIN_CASES:
        inputs, kw, _hf = ps.k1_main_case(case, dev)
        what = f"k1_main {case}"
        print(f"[kernels] {what}: G={inputs[0].shape[1]} {kw}", flush=True)
        rows = out[what] = {}
        comparer(torch, what, rows)(
            "k1_main", lambda: k1_main.k1_main(*inputs, **kw),
            lambda: k1_main.k1_main_ref(*inputs, **kw), inputs)
    return out


def check_k2_cases(torch, dev):
    """Phase 3, K2 at the edges of its tiles (``probes.streams.K2_CASES``:
    one lane, part tiles, HP 128 from start 127, entries past HP, 65
    tiles, merged maps) against its plain version.  Returns {case: rows},
    as check_kernels."""
    from huffmandecoderongpus_tpu_torch.ops import k2_compose
    from huffmandecoderongpus_tpu_torch.probes import streams as ps

    out = {}
    for case in ps.K2_CASES:
        G, HP, start, values = case
        ex = ps.k2_exmap(case, dev)
        what = f"k2 G={G} HP={HP} start {start} {values}"
        rows = out[what] = {}
        comparer(torch, what, rows)(
            "k2_compose", lambda: k2_compose.k2_compose(ex, start),
            lambda: k2_compose.k2_compose_ref(ex, start), (ex,))
    return out


def check_k1_cases(torch, dev):
    """Phase 3, both K1 kernels at their edge cases
    (``probes.streams.K1_CASES``: md 2 at G 512, md 6 with two table chunks
    at G 16,384, md 8, one candidate chain, a 128-tall tree at two G, lanes
    past the stream end, a blank run, a batch ending in pad lanes) against
    their plain versions, with a [k1] line each.  Returns {case: rows}, as
    check_kernels."""
    from huffmandecoderongpus_tpu_torch.ops import k1_scan2, k1_scan2_c01
    from huffmandecoderongpus_tpu_torch.probes import streams as ps

    out = {}
    for case in ps.K1_CASES:
        kernel, inputs, kw, _hfs = ps.k1_case(case, dev)
        mod = k1_scan2 if kernel == "k1_scan2" else k1_scan2_c01
        what = f"k1 {case}"
        rows = out[what] = {}
        comparer(torch, what, rows)(
            kernel, lambda: getattr(mod, kernel)(*inputs, **kw),
            lambda: getattr(mod, kernel + "_ref")(*inputs, **kw), inputs)
        k1_line(torch, what, kernel, lambda: getattr(mod, kernel)(
            *inputs, **kw), inputs[2], kw, rows)
    return out


def check_k1p_cases(torch, dev):
    """Phase 3, K1' and K3' at their edge cases (``probes.streams.
    K1P_CASES``: a two-leaf tree, 128 and 255 states, a 31-bit comb tree,
    1 and 37 lanes, lanes past the stream end, a phase-locked run, (c)'s
    plan at an eighth, and K3' cuts on a cell boundary, mid-cell and past
    the last segment) against their plain versions, with a [k1] and a [k3]
    line each.  Returns {case: rows}, as check_kernels."""
    from huffmandecoderongpus_tpu_torch.ops import k1_scan, k3_fix
    from huffmandecoderongpus_tpu_torch.probes import streams as ps

    out = {}
    for case in ps.K1P_CASES:
        inputs, kw, cuts, _hf = ps.k1p_case(case, dev)
        wmat, tab, lim = inputs
        what = f"k1p {case}"
        rows = out[what] = {}
        compare = comparer(torch, what, rows)
        compare("k1_scan", lambda: k1_scan.k1_scan(*inputs, **kw),
                lambda: k1_scan.k1_scan_ref(*inputs, **kw), inputs)
        k1p_line(torch, what, lambda: k1_scan.k1_scan(*inputs, **kw), lim,
                 kw, rows)
        ent, cut, cut_slot, sym, val = ps.k3p_inputs(inputs, kw, cuts)
        k3 = dict(steps_p=kw["steps_p"], SEG=kw["SEG"], md=1, NS=kw["NS"])
        s_k, v_k = sym.clone(), val.clone()
        s_p, v_p = sym.clone(), val.clone()

        def fix(s_k=s_k, v_k=v_k, ent=ent, cut=cut, cut_slot=cut_slot):
            return k3_fix.k3_fix(wmat, tab, ent, cut, cut_slot, s_k, v_k,
                                 **k3)

        compare("k3_fix", fix, lambda: k3_fix.k3_fix_ref(
            wmat, tab, ent, cut, cut_slot, s_p, v_p, **k3), (),
            moved=k3_moved(tab, cut, cut_slot))
        k3_line(torch, what, fix, cut, kw["steps_p"], rows)
    return out


def drive_states128(torch, mods, dev):
    """Phase 4, the trees of exactly 128 internal states (129 symbols,
    seed 1: one dominant byte, md 1; near-uniform weights, md >= 2), which
    the port packs compact in one table chunk: decode_widescan through the
    four-kernel program and, for md >= 2, the one-shot, each decode
    counted on its own; raises unless the bytes are the input and the
    path's kernels each launched once.  Returns the launch counts."""
    from huffmandecoderongpus_tpu_torch.huffio import encode_bytes
    from huffmandecoderongpus_tpu_torch.ops import widescan as ws
    from huffmandecoderongpus_tpu_torch.probes import streams as ps

    total = dict.fromkeys(mods, 0)
    for gen, path in ((lambda r: ps.dominant_byte(r, STATES128_BYTES, 129),
                       MD1_PATH),
                      (lambda r: ps.near_uniform(r, STATES128_BYTES, 129),
                       PATHS["a"])):
        raw = gen(np.random.default_rng(1))
        hf = encode_bytes(raw)
        st = ws.stage_widescan_inputs(hf, device=dev)
        what = f"128 states, md {st['md']}, NS {st['NS']}"
        routes = [(False, path)] + ([(True, ("oneshot",))]
                                    if st["md"] > 1 else [])
        for one, want in routes:
            out, ran = counted(torch, mods, lambda: ws.decode_widescan(
                hf, device=dev, oneshot=one))
            expect(f"{what}, {'one-shot' if one else 'four kernels'}",
                   np.array_equal(out, raw), ran, dict.fromkeys(want, 1))
            for n, c in ran.items():
                total[n] += c
    return total


def check_lanedfa(torch, name, raw, hf, dev):
    """Phase 3 on a stream of the lane-DFA chain: the candidate and lane
    scans against their plain versions on the inputs the fallback gives
    them (sym compared on every row).  Returns and raises as
    check_kernels."""
    from huffmandecoderongpus_tpu_torch.ops import candidate_scan, lane_scan
    from huffmandecoderongpus_tpu_torch.ops import lanedfa_decode as ld
    from huffmandecoderongpus_tpu_torch.probes._timing import sm_clock_mhz

    st = ld.stage_lanedfa(hf, device=dev)
    print(f"[kernels] {name}: {hf.bits} bits, lane-DFA G="
          f"{st['bits'].shape[1]} B={st['B']} H={st['H']}", flush=True)
    kw = dict(B=st["B"], H=st["H"], N=st["N"])
    bits, tab = st["bits"], st["tab"]
    rows = {}
    compare = comparer(torch, name, rows)
    cnt, ex = compare(
        "candidate_scan",
        lambda: candidate_scan.candidate_scan(bits, tab, **kw),
        lambda: candidate_scan.candidate_scan_ref(bits, tab, **kw),
        (bits, tab))
    entry = ld.compose(cnt, ex)[0]
    sym, valid = compare(
        "lane_scan",
        lambda: lane_scan.lane_scan(bits, tab, entry, **kw),
        lambda: lane_scan.lane_scan_ref(bits, tab, entry, **kw),
        (bits, tab, entry))
    if not np.array_equal(sym.t()[valid.t() > 0].cpu().numpy(), raw):
        raise AssertionError(f"{name}: the lane-DFA scans decoded wrong")
    print(f"[kernels] {name}: both scans bit-exact; stream decoded",
          flush=True)
    # each scan's own time on the card, in cycles a bit row against the
    # floor of its chain of dependent lookups (the bytes bound in the
    # kernels line is out of reach for a serial chain of B+H steps a lane)
    clock = sm_clock_mhz(DEVICE)[1] * 1e6  # nvidia-smi clocks.max.sm, Hz
    steps = bits.shape[0]
    floor_ms = steps * CHAIN_CYCLES_A_ROW / clock * 1e3
    for kname, fn in (
            ("candidate_scan",
             lambda: candidate_scan.candidate_scan(bits, tab, **kw)),
            ("lane_scan", lambda: lane_scan.lane_scan(bits, tab, entry,
                                                      **kw))):
        card_ms = device_breakdown(torch, fn, per_launch=True).get(kname)
        rows[kname]["device_ms"] = card_ms
        card = ("not measured" if card_ms is None else
                f"{card_ms:.4f} ms (profiler), "
                f"{card_ms * 1e-3 * clock / steps:.1f} cycles a row")
        print(f"[scan] {name}: {kname} card {card}; events "
              f"{rows[kname]['ms']:.4f} ms; {steps} rows at "
              f"{clock / 1e6:.0f} MHz (clocks.max.sm); chain floor "
              f"{CHAIN_CYCLES_A_ROW} cycles a row, {floor_ms:.4f} ms",
              flush=True)
    return rows


def check_scan_tiles(torch, hfs, dev):
    """Phase 3, the lane-DFA scans at the tiling's edge cases: each of
    TILE_CASES in decode_lanedfa's geometry at its lane count, candidate_scan
    and lane_scan (from random entry offsets, 0 in the first lane and H-1
    in the last) against their plain versions; "cut" moves the stream end
    to a third of the way into the last lane, mid-tile; "views" also runs
    both on copies of the matrix at 1 and 4 bytes past an aligned address
    (the byte and 4-byte copy paths) and lane_scan cut to fewer rows than
    one tile on a row slice of it.  Returns {case: rows}, as
    check_kernels."""
    from huffmandecoderongpus_tpu_torch.ops import candidate_scan, lane_scan
    from huffmandecoderongpus_tpu_torch.ops import lanedfa_decode as ld
    from huffmandecoderongpus_tpu_torch.ops.lanedfa import tile_plan
    from huffmandecoderongpus_tpu_torch.probes.streams import comb_stream

    streams = {k: hfs[k][1:] for k in "ef"}
    for k, _G, _how in TILE_CASES:
        if k.startswith("comb"):  # comb<height>
            streams[k] = comb_stream(int(k[4:]) + 1, COMB_BYTES, SEED,
                                     deep=COMB_DEEP)
    out = {}
    rng = np.random.default_rng(SEED)
    for k, G, how in TILE_CASES:
        raw, hf = streams[k]
        st = ld.stage_lanedfa(hf, device=dev, lanes=G, tiled=False)
        bits, tab, B, H = st["bits"], st["tab"], st["B"], st["H"]
        G = bits.shape[1]
        N = st["N"] - (B // 3 + 5 if how == "cut" else 0)
        kw = dict(B=B, H=H, N=N)
        start = rng.integers(0, H, G).astype(np.int32)
        start[0], start[-1] = 0, H - 1
        start = torch.from_numpy(start).to(dev)
        case = f"tiles {k} G={G}" + (f" {how}" if how else "")
        plans = [tile_plan(G, c, bits.data_ptr(), out_tiles=c == 1)
                 for c in (H, 1)]
        print(f"[kernels] {case}: B={B} H={H} rows {bits.shape[0]}, N={N}; "
              f"plans (candidate, lane) {plans}", flush=True)
        rows = out[case] = {}
        compare = comparer(torch, case, rows)
        mats = [("", bits)]
        if how == "views":
            for off in (1, 4):
                flat = torch.empty(bits.numel() + off, dtype=torch.uint8,
                                   device=dev)
                mats.append((f" at +{off}", flat[off:].view(bits.shape)))
                mats[-1][1].copy_(bits)
        for tag, m in mats:
            compare(f"candidate_scan{tag}",
                    lambda m=m: candidate_scan.candidate_scan(m, tab, **kw),
                    lambda m=m: candidate_scan.candidate_scan_ref(m, tab,
                                                                  **kw),
                    (m, tab))
            compare(f"lane_scan{tag}",
                    lambda m=m: lane_scan.lane_scan(m, tab, start, **kw),
                    lambda m=m: lane_scan.lane_scan_ref(m, tab, start, **kw),
                    (m, tab, start))
        if how == "views":
            W = min(40, bits.shape[0])
            compare(f"lane_scan rows={W}",
                    lambda: lane_scan.lane_scan(bits[:W], tab, start, rows=W,
                                                **kw),
                    lambda: lane_scan.lane_scan_ref(bits[:W], tab, start,
                                                    rows=W, **kw),
                    (bits[:W], tab, start))
    return out


def check_oneshot(torch, name, raw, hf, dev):
    """Phase 3 on a one-shot stream: the fused kernel against its plain
    version (the four kernels' plain stages) on the same staged inputs,
    over the whole dense rows, the counts and the total.  Returns and
    raises as check_kernels; raises too if the stream is not one that
    lane_wide routes to the one-shot."""
    from huffmandecoderongpus_tpu_torch.ops import oneshot
    from huffmandecoderongpus_tpu_torch.ops import widescan as ws

    st = ws.stage_widescan_inputs(hf, device=dev)
    p = st["plan"]
    print(f"[kernels] {name}: {hf.bits} bits, G={p['G']} B={p['B']} "
          f"H={st['H']} md={st['md']} NS={st['NS']} ORP={p['ORP']}",
          flush=True)
    if hf.bits >= ws.ONESHOT_MAX_BITS or not oneshot.oneshot_eligible(st):
        raise AssertionError(f"{name}: lane_wide does not route it to the "
                             "one-shot")
    args = (st["words"], st["tab"], st["lim"])
    kw = oneshot.program_args(st)
    rows = {}
    denseT, n, total = comparer(torch, name, rows)(
        "oneshot", lambda: oneshot.oneshot_program(*args, **kw),
        lambda: oneshot.oneshot_program_ref(*args, **kw), args)
    mask = torch.arange(p["ORP"], device=dev)[None, :] < n[:, None]
    if (int(total) != raw.size
            or not np.array_equal(denseT[mask].cpu().numpy(), raw)):
        raise AssertionError(f"{name}: the one-shot kernel decoded wrong")
    print(f"[kernels] {name}: oneshot bit-exact; stream decoded", flush=True)
    return rows


def check_k4_cases(torch, dev):
    """Phase 3, K4 at its plan's edge cases (``probes.streams.K4_CASES``:
    one lane, three, a tail block, lanes past ORP, none valid, views at an
    offset, rows past a block's staging and in windows) against its plain
    version.  Returns {case: rows}, as check_kernels."""
    from huffmandecoderongpus_tpu_torch.ops import k4_compact
    from huffmandecoderongpus_tpu_torch.probes import streams as ps

    out = {}
    for case in ps.K4_CASES:
        G, cells_p, ORP, fill, off = case
        sym, val = ps.k4_cells(case, dev)
        plan = k4_compact.k4_plan(G, cells_p, ORP, sym.data_ptr(),
                                  val.data_ptr())
        what = f"k4 G={G} cells {cells_p} ORP={ORP} {fill} +{off}"
        print(f"[kernels] {what}: plan {plan}", flush=True)
        rows = out[what] = {}
        comparer(torch, what, rows)(
            "k4_compact", lambda: k4_compact.k4_compact(sym, val, ORP=ORP),
            lambda: k4_compact.k4_compact_ref(sym, val, ORP=ORP), (sym, val))
    return out


def check_oneshot_cases(torch, dev):
    """Phase 3, the one-shot kernel at its edge cases
    (``probes.streams.ONESHOT_CASES``: one candidate chain, md 8, a tree
    128 tall, the envelope-edge stream, G = 128 and 4,096) against its
    plain version, whole rows, counts and total, and each decoded to its
    input.  Returns {case: rows}, as check_kernels."""
    from huffmandecoderongpus_tpu_torch.ops import oneshot
    from huffmandecoderongpus_tpu_torch.probes import streams as ps

    out = {}
    for case in ps.ONESHOT_CASES:
        raw, st = ps.oneshot_case(case, dev)
        p = st["plan"]
        plan = oneshot.oneshot_plan(p["G"], st["H"], st["md"], p["SEG"],
                                    p["steps_p"], p["ORP"], st["NS"])
        what = (f"oneshot {case} G={p['G']} H={st['H']} md={st['md']} "
                f"NS={st['NS']}")
        print(f"[kernels] {what}: T={plan['T']} blocks {plan['blocks']} "
              f"shared {plan['shared']}", flush=True)
        if not oneshot.oneshot_eligible(st):
            raise AssertionError(f"{what}: not one-shot eligible")
        args = (st["words"], st["tab"], st["lim"])
        kw = oneshot.program_args(st)
        rows = out[what] = {}
        denseT, n, total = comparer(torch, what, rows)(
            "oneshot", lambda: oneshot.oneshot_program(*args, **kw),
            lambda: oneshot.oneshot_program_ref(*args, **kw), args)
        mask = torch.arange(p["ORP"], device=dev)[None, :] < n[:, None]
        if (int(total) != raw.size
                or not np.array_equal(denseT[mask].cpu().numpy(), raw)):
            raise AssertionError(f"{what}: decoded wrong")
    return out


def check_encoder(torch, name, raw, hf, dev, card_ms):
    """Phase 3 of the encoder on one stream: E1, E2 and E3 against their
    plain versions on the staging encode_lanes gives them, each stage fed
    by the previous kernel's output, then the payload against the host
    encoder's; an [e1] and an [e2] line with ``card_ms`` ({kernel: card
    ms}, from ``encode_card_ms_fresh``).  Returns and raises as
    check_kernels."""
    from huffmandecoderongpus_tpu_torch.ops import (
        _build,
        e1_pack,
        e2_compact,
        e3_place,
        encode,
    )

    st = encode.stage_encode_inputs(raw, device=dev)
    p = st["plan"]
    print(f"[kernels] {name}: encode G={p['G']} K={p['K']} ORP={p['ORP']} "
          f"NROWS={p['NROWS']} bits={p['total_bits']}", flush=True)
    rows = {}
    compare = comparer(torch, name, rows)
    args = (st["data3"], st["lo"], st["hi"], st["nval"])
    gran, gval, cnt, bits = compare(
        "e1_pack", lambda: e1_pack.e1_pack(*args),
        lambda: e1_pack.e1_pack_ref(*args), args)
    e_line(name, "e1_pack", card_ms.get("e1_pack"),
           e1_pack.e1_plan(p["G"], p["K"], _build.sm_count(dev),
                           st["data3"].data_ptr()), rows)
    ORP, NROWS = p["ORP"], p["NROWS"]
    (denseT,) = compare(
        "e2_compact", lambda: e2_compact.e2_compact(gran, gval, ORP=ORP),
        lambda: e2_compact.e2_compact_ref(gran, gval, ORP=ORP), (gran, gval))
    e_line(name, "e2_compact", card_ms.get("e2_compact"),
           e2_compact.e2_plan(p["G"], 2 * p["K"], ORP, _build.sm_count(dev),
                              gran.data_ptr(), gval.data_ptr()), rows)
    shift, word_off, occ = encode.lane_offsets(bits)
    e3a = (encode.shift_lanes(denseT, cnt, shift), word_off, occ)
    # E3 reads only each lane's occupied granules, and writes the payload
    moved = (4 * int(torch.clamp(occ, max=ORP).sum()) + 8 * occ.numel()
             + 4 * 128 * NROWS)
    (out,) = compare("e3_place", lambda: e3_place.e3_place(*e3a, NROWS=NROWS),
                     lambda: e3_place.e3_place_ref(*e3a, NROWS=NROWS), (),
                     moved)
    payload = encode.payload_bytes(out, p["total_bits"]).cpu().numpy()
    if p["total_bits"] != hf.bits or not np.array_equal(payload, hf.payload):
        raise AssertionError(f"{name}: the encode kernels' payload differs "
                             "from the host encoder's")
    print(f"[kernels] {name}: E1-E3 bit-exact; payload equal to the host "
          "encoder's", flush=True)
    return rows


def e_line(name, kname, card_ms, plan, rows):
    """An [e1] or [e2] line for one E1 or E2 stream: the kernel's plan, its
    card time ``card_ms`` (or None) against its bytes bound, and its events
    time.  The card time goes into rows[kname] as device_ms."""
    r = rows[kname]
    r["device_ms"] = card_ms
    card = ("not measured" if card_ms is None else
            f"{card_ms:.4f} ms (profiler, a fresh process), "
            f"{card_ms / r['bound_ms']:.1f} times the bound")
    tag = "e1" if kname == "e1_pack" else "e2"
    print(f"[{tag}] {name}: {kname} card {card}; events {r['ms']:.4f} ms; "
          f"bytes bound {r['bound_ms']:.6f} ms; plan {plan}", flush=True)


#: the option that runs this script as encode_card_ms_fresh's child
ENCODE_CARD_ARG = "--encode-card-ms"


def encode_card_ms(torch, streams, dev):
    """{stream: {"e1_pack": ms, "e2_compact": ms}}: E1's and E2's card time
    a launch (profiler, device_breakdown's per_launch mean; None where it
    recorded none) on the encoder's staging of ENCODE_CHECKED."""
    from huffmandecoderongpus_tpu_torch.ops import e1_pack, e2_compact, encode

    out = {}
    for k in ENCODE_CHECKED:
        st = encode.stage_encode_inputs(streams[k][1], device=dev)
        args = (st["data3"], st["lo"], st["hi"], st["nval"])
        gran, gval, _cnt, _bits = e1_pack.e1_pack(*args)
        ORP = st["plan"]["ORP"]
        out[k] = {
            "e1_pack": device_breakdown(
                torch, lambda: e1_pack.e1_pack(*args),
                per_launch=True).get("e1_pack"),
            "e2_compact": device_breakdown(
                torch, lambda: e2_compact.e2_compact(gran, gval, ORP=ORP),
                per_launch=True).get("e2_compact")}
    return out


def encode_card_ms_fresh():
    """encode_card_ms from a fresh process of this script (its last line):
    this long process's profiler records nothing in most sessions after its
    first phases (PERF.md section 7), a new one's in each.  {} if the child
    fails."""
    r = subprocess.run([sys.executable, str(pathlib.Path(__file__).resolve()),
                        ENCODE_CARD_ARG], capture_output=True, text=True,
                       timeout=600)
    lines = r.stdout.strip().splitlines()
    if r.returncode or not lines:
        print(f"[e1] the card-time process failed (rc {r.returncode}): "
              f"{r.stderr.strip()[-500:]}", flush=True)
        return {}
    return json.loads(lines[-1])


def check_encoder_cases(torch, dev):
    """Phase 3, E1 and E2 at their edge cases (``probes.streams.E_CASES``)
    against their plain versions: E1 on the case's staging, E2 on E1's rows
    at the plan's ORP and at E_SMALL_ORP, which drops ranks.  Returns
    {case: rows}, as check_kernels."""
    from huffmandecoderongpus_tpu_torch.ops import _build, e1_pack, e2_compact
    from huffmandecoderongpus_tpu_torch.probes import streams as ps

    out = {}
    for case in ps.E_CASES:
        _raw, _tree, _lanes, st = ps.e_case(case, dev)
        p = st["plan"]
        args = (st["data3"], st["lo"], st["hi"], st["nval"])
        what = f"encode {case} G={p['G']} K={p['K']}"
        plan = e1_pack.e1_plan(p["G"], p["K"], _build.sm_count(dev),
                               st["data3"].data_ptr())
        print(f"[kernels] {what}: E1 plan {plan}", flush=True)
        rows = out[what] = {}
        gran, gval, _cnt, _bits = comparer(torch, what, rows)(
            "e1_pack", lambda: e1_pack.e1_pack(*args),
            lambda: e1_pack.e1_pack_ref(*args), args)
        for ORP in (p["ORP"], ps.E_SMALL_ORP):
            at = f"{what} ORP={ORP}"
            comparer(torch, at, out.setdefault(at, {}))(
                "e2_compact",
                lambda: e2_compact.e2_compact(gran, gval, ORP=ORP),
                lambda: e2_compact.e2_compact_ref(gran, gval, ORP=ORP),
                (gran, gval))
    return out


def check_indexed(torch, name, raw, hf, dev):
    """Phase 3 on an indexed stream: K1's main scan (``k1_main``) against
    its plain version on the indexed staging, then K4 and the trim by the
    index counts.  Returns and raises as check_kernels."""
    from huffmandecoderongpus_tpu_torch.ops import k1_main, k4_compact
    from huffmandecoderongpus_tpu_torch.ops import widescan as ws

    st = ws.stage_widescan_indexed(hf, *hf.index, device=dev)
    p = st["plan"]
    print(f"[kernels] {name}: {hf.bits} bits, {st['nb']} blocks, G={p['G']} "
          f"steps_p={p['steps_p']} SEG={p['SEG']} md={st['md']} "
          f"NS={st['NS']} ORP={p['ORP']}", flush=True)
    wmat = ws.normalize_lane_words(st["raw"], st["sh"]).t().contiguous()
    kw = dict(steps_p=p["steps_p"], md=st["md"], C0=st["C0"], C1=st["C1"],
              NS=st["NS"])
    rows = {}
    sym, val = comparer(torch, name, rows)(
        "k1_main", lambda: k1_main.k1_main(wmat, st["tab"], st["lim"], **kw),
        lambda: k1_main.k1_main_ref(wmat, st["tab"], st["lim"], **kw),
        (wmat, st["tab"], st["lim"]))
    k1_main_line(torch, name, lambda: k1_main.k1_main(
        wmat, st["tab"], st["lim"], **kw), st["lim"], kw, rows)
    (denseT,) = comparer(torch, name, rows)(
        "k4_compact", lambda: k4_compact.k4_compact(sym, val, ORP=p["ORP"]),
        lambda: k4_compact.k4_compact_ref(sym, val, ORP=p["ORP"]),
        (sym, val))
    counts = torch.from_numpy(st["counts"]).to(dev)
    mask = torch.arange(p["ORP"], device=dev)[None, :] < counts[:, None]
    if not np.array_equal(denseT[mask].cpu().numpy(), raw):
        raise AssertionError(f"{name}: the indexed kernels decoded wrong")
    print(f"[kernels] {name}: k1_main and K4 bit-exact; stream decoded",
          flush=True)
    return rows


def check_lanedfa_indexed(torch, name, raw, hf, dev):
    """Phase 3 of the indexed lane scan on a stream's index, in lane_dfa's
    geometry (one lane per block): kernel against plain version, sym on
    every row.  Returns and raises as check_kernels."""
    from huffmandecoderongpus_tpu_torch.ops import lane_scan_indexed as lsi
    from huffmandecoderongpus_tpu_torch.ops import lanedfa_decode as ld

    st = ld.stage_lanedfa_indexed(hf, hf.index[0], device=dev, tiled=False)
    B, G = st["bits"].shape
    print(f"[kernels] {name}: indexed lane scan G={G} B={B}", flush=True)
    args = (st["bits"], st["tab"], st["lane_len"])
    rows = {}
    sym, valid = comparer(torch, name, rows)(
        "lane_scan_indexed", lambda: lsi.lane_scan_indexed(*args),
        lambda: lsi.lane_scan_indexed_ref(*args), args)
    if not np.array_equal(sym.t()[valid.t() > 0].cpu().numpy(), raw):
        raise AssertionError(f"{name}: the indexed lane scan decoded wrong")
    print(f"[kernels] {name}: lane_scan_indexed bit-exact; stream decoded",
          flush=True)
    return rows


def short_scan_moved(torch, out, tab, B, N, W) -> int:
    """Bytes the short candidate scan must move on these inputs: the bit and
    0-chain rows each lane's chains read (row 0 through the last row any of
    them reads), the table, and the five outputs (14 bytes a chain)."""
    merged, exited, mrow, _cnt, ex = out
    H, G = mrow.shape
    lim = N - torch.arange(G, device=mrow.device, dtype=torch.int64) * B
    end = lim.clamp(0, W)
    last = torch.where(merged, mrow.long(),
                       torch.where(exited, ex.long() + B - 1, end - 1))
    rows = (last.amax(0) + 1).clamp(min=0)
    return 2 * int(rows.sum()) + nbytes(tab) + 14 * H * G


def check_sync(torch, name, raw, hf, dev):
    """Phase 3 of the sync discovery on one stream, in lane_dfa_sync's
    geometry: the first round's short candidate scan against its plain
    version on the 0-chain's emissions, all five outputs, and the lane scan
    cut at that round's W rows (the fix scan's shape) from the true entry
    offsets.  Returns and raises as check_kernels."""
    from huffmandecoderongpus_tpu_torch.ops import (
        candidate_scan,
        lane_scan,
        lanedfa_sync,
        short_candidate_scan,
    )
    from huffmandecoderongpus_tpu_torch.ops import lanedfa_decode as ld

    st = ld.stage_lanedfa(hf, device=dev, tiled=False)
    bits, tab = st["bits"], st["tab"]
    kw = dict(B=st["B"], H=st["H"], N=st["N"])
    steps, G = bits.shape
    W = min(max(lanedfa_sync.W0, st["H"] + 1), steps)
    print(f"[kernels] {name}: sync geometry G={G} B={st['B']} H={st['H']}, "
          f"first round W={W}", flush=True)
    zero = torch.zeros(G, dtype=torch.int32, device=dev)
    valid0 = lane_scan.lane_scan(bits, tab, zero, **kw)[1]
    rows = {}
    compare = comparer(torch, name, rows)

    def short(scan):
        return lambda: scan(bits, tab, valid0, W=W, **kw)

    moved = short_scan_moved(torch, short(
        short_candidate_scan.short_candidate_scan)(), tab, st["B"], st["N"], W)
    merged, exited = compare(
        "short_candidate_scan",
        short(short_candidate_scan.short_candidate_scan),
        short(short_candidate_scan.short_candidate_scan_ref), (), moved)[:2]
    entry = ld.compose(*candidate_scan.candidate_scan(bits, tab, **kw))[0]
    compare("lane_scan",
            lambda: lane_scan.lane_scan(bits[:W], tab, entry, rows=W, **kw),
            lambda: lane_scan.lane_scan_ref(bits[:W], tab, entry, rows=W,
                                            **kw), (bits[:W], tab, entry))
    print(f"[kernels] {name}: short_candidate_scan and the lane scan cut at "
          f"W rows bit-exact; first round: {int(merged.sum())} chains merged"
          f", {int(exited.sum())} exited, of {merged.numel()}", flush=True)
    return rows


def dense_staging(torch, hf, dev):
    """The dense pipeline's inputs in the tiled geometry: the staged
    matrix, the entry offsets from candidate_scan + compose, and the
    output rows (the JAX test's bound, B // min code length + 2)."""
    from huffmandecoderongpus_tpu_torch.ops import candidate_scan, lanedfa
    from huffmandecoderongpus_tpu_torch.ops import lanedfa_decode as ld

    st = ld.stage_lanedfa(hf, device=dev)
    cnt, ex = candidate_scan.candidate_scan(st["bits"], st["tab"], B=st["B"],
                                            H=st["H"], N=st["N"])
    md = lanedfa.build_lane_dfa(hf.tree).min_depth
    out_rows = min(st["B"] + st["H"], st["B"] // max(md, 1) + 2)
    return st, ld.compose(cnt, ex)[0], out_rows


def trimmed(torch, dense, counts):
    """The dense rows below each lane's count, lane by lane, on the host."""
    keep = (torch.arange(dense.shape[0], device=dense.device)[:, None]
            < counts[None, :])
    return dense.t()[keep.t()].cpu().numpy()


def check_dense(torch, name, raw, hf, dev, with_compact):
    """Phase 3 of the dense lane decode on one stream (and, with
    ``with_compact``, of the compaction on the lane scan's emissions)
    against the plain versions, each trimmed by its counts to the input.
    The compaction's row also carries the time of torch.searchsorted +
    gather on the same inputs.  Returns and raises as check_kernels."""
    from huffmandecoderongpus_tpu_torch.ops import (
        compact,
        lane_decode_dense,
        lane_scan,
    )

    st, entry, out_rows = dense_staging(torch, hf, dev)
    bits, tab = st["bits"], st["tab"]
    kw = dict(B=st["B"], H=st["H"], N=st["N"])
    print(f"[kernels] {name}: dense decode G={bits.shape[1]} B={st['B']} "
          f"H={st['H']} out_rows={out_rows}", flush=True)
    rows = {}
    compare = comparer(torch, name, rows)
    dense, counts = compare(
        "lane_decode_dense",
        lambda: lane_decode_dense.lane_decode_dense(
            bits, tab, entry, out_rows=out_rows, **kw),
        lambda: lane_decode_dense.lane_decode_dense_ref(
            bits, tab, entry, out_rows=out_rows, **kw), (bits, tab, entry))
    if not np.array_equal(trimmed(torch, dense, counts), raw):
        raise AssertionError(f"{name}: the dense decode decoded wrong")
    print(f"[kernels] {name}: lane_decode_dense bit-exact; stream decoded",
          flush=True)
    if not with_compact:
        return rows
    sym, valid = lane_scan.lane_scan(bits, tab, entry, **kw)
    cum = torch.cumsum(valid, 0, dtype=torch.int32)
    (out,) = compare(
        "compact", lambda: compact.compact(cum, sym, out_rows=out_rows),
        lambda: compact.compact_ref(cum, sym, out_rows=out_rows), (cum, sym))
    if (not torch.equal(out, dense)
            or not np.array_equal(trimmed(torch, out, cum[-1]), raw)):
        raise AssertionError(f"{name}: the compaction decoded wrong")
    want = torch.arange(1, out_rows + 1, dtype=torch.int32,
                        device=dev).expand(bits.shape[1], out_rows)
    want = want.contiguous()

    def library():  # the JAX kernel's binary search as two library calls
        pos = torch.searchsorted(cum.t().contiguous(), want)
        return sym.t().gather(1, pos.clamp_(max=cum.shape[0] - 1))

    lib_ms = statistics.median(event_ms(library, 20))
    rows["compact"]["library_ms"] = lib_ms
    print(f"[kernels] {name}: compact bit-exact, equal to the dense decode; "
          f"torch.searchsorted + gather {lib_ms:.4f} ms", flush=True)
    return rows


def check_batch(torch, name, raws, hfs, dev):
    """Phase 3 on a batch: the batched K1 and K3 (per-stream tables)
    against their plain versions on the batch staging, K2 and K4 between
    them, and every member's bytes.  Returns and raises as
    check_kernels."""
    from huffmandecoderongpus_tpu_torch.ops import (
        batch,
        k1_scan2_c01,
        k2_compose,
        k3_fix2_c01,
        k4_compact,
    )
    from huffmandecoderongpus_tpu_torch.ops import widescan as ws

    st = batch.stage_batch_inputs(hfs, device=dev)
    p = st["plan"]
    H, md = st["H"], st["md"]
    print(f"[kernels] {name}: {len(hfs)} streams, G={p['G']} B={p['B']} "
          f"H={H} md={md} ORP={p['ORP']} lanes {st['g_live']} of "
          f"{st['g_pad']}", flush=True)
    wmat = ws.words_matrix(st["words"], -(-p["steps_p"] // 32))
    tabs, c01, bs = st["tabs"], st["c01"], st["bstream"]
    k1a = dict(B=p["B"], H=H, steps=p["steps"], steps_p=p["steps_p"],
               SEG=p["SEG"], md=md)
    rows = {}
    compare = comparer(torch, name, rows)
    sym, val, cntmap, exmap, mrowmap = compare(
        "k1_scan2_c01",
        lambda: k1_scan2_c01.k1_scan2_c01(wmat, tabs, st["lim"], c01, bs,
                                          **k1a),
        lambda: k1_scan2_c01.k1_scan2_c01_ref(wmat, tabs, st["lim"], c01, bs,
                                              **k1a),
        (wmat, tabs, st["lim"], c01, bs))
    k1_line(torch, name, "k1_scan2_c01", lambda: k1_scan2_c01.k1_scan2_c01(
        wmat, tabs, st["lim"], c01, bs, **k1a), st["lim"], k1a, rows)
    exmap[:, list(st["last_live"])] = 0
    entry, _tot = compare("k2_compose",
                          lambda: k2_compose.k2_compose(exmap, 0),
                          lambda: k2_compose.k2_compose_ref(exmap, 0),
                          (exmap,))
    k2_line(torch, name, lambda: k2_compose.k2_compose(exmap, 0), exmap, rows)
    cut, cut_slot = ws.fix_rows(entry, mrowmap, st["lim"], H, md)
    kw = dict(steps_p=p["steps_p"], SEG=p["SEG"], md=md)
    s_k, v_k = sym.clone(), val.clone()
    s_p, v_p = sym.clone(), val.clone()
    msym, mval = compare(
        "k3_fix2_c01",
        lambda: k3_fix2_c01.k3_fix2_c01(wmat, tabs, entry, cut, cut_slot, s_k,
                                        v_k, c01, bs, **kw),
        lambda: k3_fix2_c01.k3_fix2_c01_ref(wmat, tabs, entry, cut, cut_slot,
                                            s_p, v_p, c01, bs, **kw),
        (), moved=k3_moved(tabs, cut, cut_slot) + nbytes(c01, bs))
    (denseT,) = compare(
        "k4_compact", lambda: k4_compact.k4_compact(msym, mval, ORP=p["ORP"]),
        lambda: k4_compact.k4_compact_ref(msym, mval, ORP=p["ORP"]),
        (msym, mval))
    n = ws.select_h(cntmap, entry, H)
    mask = torch.arange(p["ORP"], device=dev)[None, :] < n[:, None]
    for k, raw in enumerate(raws):
        g0, gk = st["g0"][k], st["g_pad"][k]
        if not np.array_equal(denseT[g0:g0 + gk][mask[g0:g0 + gk]].cpu()
                              .numpy(), raw):
            raise AssertionError(f"{name}: member {k} decoded wrong")
    print(f"[kernels] {name}: k1_scan2_c01, K2, k3_fix2_c01 and K4 "
          "bit-exact; every member decoded", flush=True)
    return rows


def counted(torch, mods, fn):
    """fn()'s result and the kernels it launched, the counts of ``mods``
    set to 0 just before and read just after."""
    for m in mods.values():
        m.launches = 0
    out = fn()
    torch.cuda.synchronize()
    return out, {n: m.launches for n, m in mods.items() if m.launches}


def expect(what, ok, ran, path):
    """Raise unless ``ok`` and the launches ``ran`` are ``path``."""
    print(f"[slice] {what}: equal to the input: {ok}; launches {ran}",
          flush=True)
    if not ok:
        raise AssertionError(f"{what}: decoded bytes differ")
    if ran != path:
        raise AssertionError(f"{what}: launched {ran}, expected {path}")


def drive_indexed(torch, mods, hfs, idx, dev, card):
    """Phase 4 of the indexed route: decode_widescan_indexed on the indexed
    (a), (b) and (i); the encode command's (a) with --index 512 read back
    and decoded by lane_dfa; (c)'s index refused by the wide program and
    decoded by lane_dfa; then the indexed and the discovery programs'
    times.  Raises on any failure; returns the launches summed."""
    import tempfile

    from huffmandecoderongpus_tpu_torch.harness import cli
    from huffmandecoderongpus_tpu_torch.huffio import read_huff
    from huffmandecoderongpus_tpu_torch.models import get_decoder
    from huffmandecoderongpus_tpu_torch.ops import widescan as ws

    total = dict.fromkeys(mods, 0)

    def add(ran):
        for n, c in ran.items():
            total[n] += c

    for k in INDEXED:
        name, r, h = idx[k]
        out, ran = counted(torch, mods, lambda h=h: ws.decode_widescan_indexed(
            h, *h.index, device=DEVICE))
        expect(f"decode_widescan_indexed {name}", np.array_equal(out, r),
               ran, dict.fromkeys(INDEXED_PATH, 1))
        add(ran)
    name, r, h = idx["a"]
    with tempfile.TemporaryDirectory() as tmp:
        src = pathlib.Path(tmp) / "a.bin"
        r.tofile(src)
        cli.main(["encode", str(src), "--index", str(INDEXED["a"])])
        back = read_huff(str(src) + ".huff")
    if back.index is None or not np.array_equal(back.index[0], h.index[0]):
        raise AssertionError("the encode command's sidecar did not load or "
                             "differs from the host index")
    out, ran = counted(torch, mods, lambda: get_decoder(
        "lane_dfa", device=DEVICE)(back))
    expect(f"lane_dfa on {name} read back with its sidecar",
           np.array_equal(out, r), ran, {"lane_scan_indexed": 1})
    add(ran)
    name, r, h = idx[INDEXED_MD1[0]]
    try:
        ws.decode_widescan_indexed(h, *h.index, device=DEVICE)
        raise AssertionError(f"{name}: the wide program took an md=1 index")
    except ws.EnvelopeError as e:
        print(f"[slice] decode_widescan_indexed {name}: EnvelopeError ({e})",
              flush=True)
    out, ran = counted(torch, mods, lambda: get_decoder(
        "lane_dfa", device=DEVICE)(h))
    expect(f"lane_dfa {name}", np.array_equal(out, r), ran,
           {"lane_scan_indexed": 1})
    add(ran)

    for k in INDEXED:
        name, r, h = idx[k]
        st = ws.stage_widescan_indexed(h, *h.index, device=dev)
        sd = ws.stage_widescan_inputs(h, device=dev)
        fns = {"indexed": lambda st=st: ws.wide_decode_indexed_program(
                   st["raw"], st["sh"], st["tab"], st["lim"],
                   **ws.indexed_args(st)),
               "discovery": lambda sd=sd: ws.wide_decode_program(
                   sd["words"], sd["tab"], sd["lim"], **ws.program_args(sd))}
        med = {}
        for route, fn in fns.items():
            ts = event_ms(fn, WARMUP + TIMED_RUNS)[WARMUP:]
            med[route] = (statistics.median(ts), min(ts))
        walls = {"indexed": wall_ms(torch, lambda h=h: ws.decode_widescan_indexed(
                     h, *h.index, device=dev)),
                 "discovery": wall_ms(torch, lambda h=h: ws.decode_widescan(
                     h, device=dev, oneshot=False))}
        print(f"[slice] {name}: device program median over {TIMED_RUNS} runs "
              + "  ".join(f"{rt} {m:.4f} ms (min {mn:.4f})"
                          for rt, (m, mn) in med.items())
              + f"; G indexed {st['plan']['G']} (steps_p "
              f"{st['plan']['steps_p']}), discovery {sd['plan']['G']} (B "
              f"{sd['plan']['B']}); decode wall median over {WALL_RUNS} runs "
              + "  ".join(f"{rt} {m:.4f} ms (min {mn:.4f})"
                          for rt, (m, mn) in walls.items())
              + f"; card {card}", flush=True)
        split = device_breakdown(torch, fns["indexed"])
        print(f"[slice] {name}: indexed program device ms (profiler) "
              + "  ".join(f"{n} {v:.4f}" for n, v in split.items()),
              flush=True)
    return total


def drive_batch(torch, mods, hfs, small, trio, dev, card):
    """Phase 4 of the batch route: the five small streams in one program
    (auto-split keeps them together), (f), (g) and the book2-sized one with
    auto_split=False, (a) plus the five small ones with auto_split (a
    solo), a batch holding (h) refused; then the batch programs' times and
    each member's routed solo program and walls.  Raises on any failure;
    returns the launches summed."""
    from huffmandecoderongpus_tpu_torch.ops import batch, oneshot
    from huffmandecoderongpus_tpu_torch.ops import widescan as ws

    total = dict.fromkeys(mods, 0)

    def run(what, members, path, **kw):
        raws = [r for _n, r, _h in members]
        outs, ran = counted(torch, mods, lambda: batch.decode_widescan_batch(
            [h for _n, _r, h in members], device=DEVICE, **kw))
        ok = len(outs) == len(raws) and all(
            np.array_equal(o, r) for o, r in zip(outs, raws))
        expect(what, ok, ran, path)
        for n, c in ran.items():
            total[n] += c

    run(f"decode_widescan_batch {BATCH5}", small,
        dict.fromkeys(BATCH_PATH, 1))
    run(f"decode_widescan_batch {TRIO}, auto_split=False", trio,
        dict.fromkeys(BATCH_PATH, 1), auto_split=False)
    run(f"decode_widescan_batch (a) + {BATCH5}, auto_split", [hfs["a"]]
        + small, dict(k1_scan2=1, k3_fix2=1, k1_scan2_c01=1, k3_fix2_c01=1,
                      k2_compose=2, k4_compact=2))
    try:  # (h) is past BATCH_SOLO_BITS: auto-split would decode it alone
        batch.decode_widescan_batch([h for _n, _r, h in small]
                                    + [hfs["h"][2]], device=DEVICE,
                                    auto_split=False)
        raise AssertionError("a batch holding (h) was not refused")
    except ws.EnvelopeError as e:
        print(f"[slice] decode_widescan_batch {BATCH5} + (h): EnvelopeError "
              f"({e})", flush=True)

    for what, members in ((BATCH5, small), (TRIO, trio)):
        hl = [h for _n, _r, h in members]
        st = batch.stage_batch_inputs(hl, device=dev)

        def program(st=st):
            return batch.batch_decode_program(*batch.batch_inputs(st),
                                              **batch.batch_args(st))

        ts = event_ms(program, WARMUP + TIMED_RUNS)[WARMUP:]
        solo = []
        for h in hl:  # the program decode_widescan routes the member to
            s2 = ws.stage_widescan_inputs(h, device=dev)
            if h.bits < ws.ONESHOT_MAX_BITS and oneshot.oneshot_eligible(s2):
                fn = (lambda s2=s2: oneshot.oneshot_program(
                    s2["words"], s2["tab"], s2["lim"],
                    **oneshot.program_args(s2)))
            else:
                fn = (lambda s2=s2: ws.wide_decode_program(
                    s2["words"], s2["tab"], s2["lim"],
                    **ws.program_args(s2)))
            solo.append(statistics.median(
                event_ms(fn, WARMUP + TIMED_RUNS)[WARMUP:]))
        wall_b = wall_ms(torch, lambda hl=hl: batch.decode_widescan_batch(
            hl, device=dev, auto_split=False))
        wall_s = [wall_ms(torch, lambda h=h: ws.decode_widescan(h, device=dev))
                  for h in hl]
        print(f"[slice] {what}: batch program median {statistics.median(ts):.4f}"
              f" ms (min {min(ts):.4f}) over {TIMED_RUNS} runs, G="
              f"{st['plan']['G']} B={st['plan']['B']}; solo programs "
              + " + ".join(f"{t:.4f}" for t in solo)
              + f" = {sum(solo):.4f} ms; walls median batch "
              f"{wall_b[0]:.4f} ms, solo "
              + " + ".join(f"{w[0]:.4f}" for w in wall_s)
              + f" = {sum(w[0] for w in wall_s):.4f} ms; card {card}",
              flush=True)
        split = device_breakdown(torch, program)
        print(f"[slice] {what}: batch program device ms (profiler) "
              + "  ".join(f"{n} {v:.4f}" for n, v in split.items()),
              flush=True)
    return total


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    # the port under test is the one beside this script, never an installed
    # copy: its kernels are built from this checkout's csrc/
    csrc = pathlib.Path(__file__).resolve().parent / (
        "huffmandecoderongpus_tpu_torch/csrc")
    if not csrc.is_dir():
        print(f"chip_smoke: no {csrc} beside this script", file=sys.stderr)
        return 1
    from huffmandecoderongpus_tpu_torch.huffio import encode_bytes
    from huffmandecoderongpus_tpu_torch.models import get_decoder
    from huffmandecoderongpus_tpu_torch.ops import (
        _build,
        candidate_scan,
        compact,
        k1_main,
        k1_scan,
        k1_scan2,
        k1_scan2_c01,
        k2_compose,
        k3_fix,
        k3_fix2,
        k3_fix2_c01,
        k4_compact,
        lane_decode_dense,
        lane_scan,
        lane_scan_indexed,
        oneshot,
        short_candidate_scan,
    )
    from huffmandecoderongpus_tpu_torch.ops import widescan as ws

    mods = {"k1_scan2": k1_scan2, "k2_compose": k2_compose,
            "k3_fix2": k3_fix2, "k4_compact": k4_compact,
            "k1_scan": k1_scan, "k3_fix": k3_fix,
            "candidate_scan": candidate_scan, "lane_scan": lane_scan,
            "oneshot": oneshot, "k1_main": k1_main,
            "lane_scan_indexed": lane_scan_indexed,
            "k1_scan2_c01": k1_scan2_c01, "k3_fix2_c01": k3_fix2_c01,
            "short_candidate_scan": short_candidate_scan,
            "lane_decode_dense": lane_decode_dense, "compact": compact}
    dev = torch.device(DEVICE)

    # ---- 1. device ----------------------------------------------------------
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"[device] {card}")
    print(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
          f"devices {torch.cuda.device_count()}", flush=True)

    # ---- 2. build -----------------------------------------------------------
    t0 = time.perf_counter()
    _build.get_lib()
    print(f"[build] {_build.lib_path().name} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    log = (_build.BUILD_DIR / "build.log")
    if log.exists():
        for line in log.read_text().splitlines():
            if "registers" in line or "spill" in line or "stack" in line:
                print(f"[build] {line.strip()}")

    # ---- 3. kernels against their plain versions ---------------------------
    rng = np.random.default_rng(SEED)
    streams = draw_streams(rng)
    if sys.argv[1:] == [ENCODE_CARD_ARG]:
        print(json.dumps(encode_card_ms(torch, streams, dev)))
        return 0
    hfs = {k: (f"{k} {name}", r, encode_bytes(r))
           for k, (name, r) in streams.items()}
    small = []
    for j, n_sym in enumerate(BATCH_SYMBOLS):
        r = text_like(rng, PAPER1_BYTES, n_sym)
        small.append((f"paper1-sized text over {n_sym} symbols", r,
                      encode_bytes(r)))
    r = text_like(rng, BOOK2_BYTES)
    trio = [hfs["f"], hfs["g"], ("book2-sized text", r, encode_bytes(r))]
    idx = {k: (f"{k} {streams[k][0]}, index every {K} symbols",
               streams[k][1], encode_bytes(streams[k][1], block_symbols=K))
           for k, K in (*INDEXED.items(), INDEXED_MD1)}
    checked = {k: check_kernels(torch, *hfs[k], dev) for k in "abc"}
    checked["d"] = check_kernels(torch, *hfs["d"], dev, decodes=False)
    checked["d"].update(check_lanedfa(torch, *hfs["d"], dev))
    checked.update(check_scan_tiles(torch, hfs, dev))
    checked.update(check_k4_cases(torch, dev))
    for k in ONESHOT:
        checked[k] = check_oneshot(torch, *hfs[k], dev)
    checked.update(check_oneshot_cases(torch, dev))
    checked.update(check_k1_cases(torch, dev))
    checked.update(check_k1p_cases(torch, dev))
    checked.update(check_k1_main_cases(torch, dev))
    checked.update(check_k2_cases(torch, dev))
    card_ms = encode_card_ms_fresh()
    for k in ENCODE_CHECKED:
        checked.setdefault(k, {}).update(
            check_encoder(torch, *hfs[k], dev, card_ms.get(k, {})))
    checked.update(check_encoder_cases(torch, dev))
    for k in INDEXED:
        checked[IDX[k]] = check_indexed(torch, *idx[k], dev)
    for k in ("a", INDEXED_MD1[0]):
        checked.setdefault(IDX[k], {}).update(
            check_lanedfa_indexed(torch, *idx[k], dev))
    for what, members in ((BATCH5, small), (TRIO, trio)):
        checked[what] = check_batch(torch, what,
                                    [r for _n, r, _h in members],
                                    [h for _n, _r, h in members], dev)
    for k in SYNC:
        checked[SYNC[k]] = check_sync(torch, *hfs[k], dev)
        checked[k].update(check_dense(torch, *hfs[k], dev,
                                      with_compact=k == "d"))

    # ---- 4. the slice through the registry ----------------------------------
    def drive(decoder, k):
        """One decode of stream k, the launch counts set to 0 just before
        and read just after; raises unless the bytes equal the input and
        the kernels of its path each launched once.  Returns the counts."""
        name, r, h = hfs[k]
        paths = PATHS if decoder == "lane_wide" else ONESHOT_PATHS
        t0 = time.perf_counter()
        out, ran = counted(torch, mods, lambda: get_decoder(
            decoder, device=DEVICE)(h))
        wall = time.perf_counter() - t0
        ok = np.array_equal(out, r)
        print(f"[slice] {decoder} {name}: {r.size} bytes, {h.bits} bits, "
              f"first decode {wall:.3f} s wall, equal to the input: {ok}; "
              f"launches {ran}", flush=True)
        if not ok:
            raise AssertionError(f"{name}: decoded bytes differ")
        if ran != dict.fromkeys(paths[k], 1):
            raise AssertionError(f"{name}: launched {ran}, its path is "
                                 f"{paths[k]}")
        return ran

    launches = dict.fromkeys(mods, 0)
    for k in hfs:
        for n, c in drive("lane_wide", k).items():
            launches[n] += c
    print(f"[slice] launches on the decode paths: {launches}; (d) fell back "
          "to the lane-DFA chain after the wide program, (f)-(i) took the "
          "one-shot alone", flush=True)
    lane_wide = {n for path in PATHS.values() for n in path}
    if min(launches[n] for n in lane_wide) < 1:
        raise AssertionError(f"a kernel was not launched: {launches}")
    for k in ONESHOT_PATHS:
        drive("lane_oneshot", k)
    for n, c in drive_states128(torch, mods, dev).items():
        launches[n] += c

    for k, (name, r, h) in hfs.items():
        if k in "abc":
            s2 = ws.stage_widescan_inputs(h, device=dev)
            args = ws.program_args(s2)

            def program():
                return ws.wide_decode_program(s2["words"], s2["tab"],
                                              s2["lim"], **args)

            ts = event_ms(program, WARMUP + TIMED_RUNS)
            med = statistics.median(ts[WARMUP:])
            q = s2["plan"]
            print(f"[slice] {name}: device program median {med:.4f} ms over "
                  f"{TIMED_RUNS} runs (min {min(ts[WARMUP:]):.4f}), "
                  f"{r.size / med / 1e6:.3f} GB/s decoded; G={q['G']} "
                  f"B={q['B']} H={s2['H']} md={s2['md']} NS={s2['NS']}; "
                  f"card {card}", flush=True)
            split = device_breakdown(torch, program)
            print(f"[slice] {name}: device ms per program (profiler) "
                  + "  ".join(f"{n} {v:.4f}" for n, v in split.items()),
                  flush=True)
        if k in ONESHOT:
            time_oneshot(torch, ws, oneshot, name, r, h, dev, card)
            continue
        if k == "e":
            continue
        med, mn = wall_ms(torch, lambda: ws.decode_widescan(h, device=dev))
        print(f"[slice] {name}: decode wall median {med:.4f} ms over "
              f"{WALL_RUNS} runs (min {mn:.4f}), staging to host bytes; "
              f"card {card}", flush=True)
    # the indexed and batch routes, each decode counted on its own
    for route in (drive_indexed(torch, mods, hfs, idx, dev, card),
                  drive_batch(torch, mods, hfs, small, trio, dev, card),
                  drive_sync(torch, mods, hfs, dev, card)):
        for n, c in route.items():
            launches[n] += c
    if min(launches.values()) < 1:
        raise AssertionError(f"a kernel was not launched: {launches}")
    # the encoder's launches are counted apart from the decode paths' check
    launches.update(drive_encoder(torch, hfs, dev, card))

    # ---- 5. the probes: their kernels, the probe programs, prof ------------
    probe_rows = check_probe_kernels(torch, hfs, dev)
    launches.update(drive_probes(torch, hfs, dev, card))
    from huffmandecoderongpus_tpu_torch.probes import hw_dispatch
    print("[launch] " + hw_dispatch.split_line(hw_dispatch.host_split(dev),
                                               hw_dispatch.host_calls(dev))
          + f"; card {card}", flush=True)

    # ---- 6. result ----------------------------------------------------------
    # each kernel's times from the stream named in KERNELS (the lane-DFA
    # scans' own time on the card beside, device_ms); its error over every
    # stream and tiling shape it was checked on; its bound from the bytes
    # it must move (no single PyTorch call computes any of these functions
    # but the compaction, whose row carries searchsorted + gather); the probe
    # kernels' from the shape named in PROBE_KERNELS, their error over
    # every shape, their bound from bytes or operations, and beside their
    # time a launch their own time on the card (device_ms)
    rows = [dict(name=n, route="cuda", source=src, replaces=rep_, stream=k,
                 launches=launches[n],
                 max_abs_err=max(c[n]["err"] for c in checked.values()
                                 if n in c),
                 ms=checked[k][n]["ms"], plain_ms=checked[k][n]["plain_ms"],
                 bound_ms=checked[k][n]["bound_ms"],
                 bound_by=checked[k][n]["bound_by"],
                 library_ms=checked[k][n].get("library_ms"),
                 **({"device_ms": checked[k][n]["device_ms"]}
                    if "device_ms" in checked[k][n] else {}))
            for n, (src, rep_, k) in KERNELS.items()]
    for n, (src, rep_, shape) in PROBE_KERNELS.items():
        at = next(r for r in probe_rows[n] if r[0].startswith(shape))
        rows.append(dict(name=n, route="cuda", source=src, replaces=rep_,
                         stream=at[0], launches=launches[n],
                         max_abs_err=max(r[1] for r in probe_rows[n]),
                         ms=at[2], plain_ms=at[3], bound_ms=at[4],
                         bound_by=at[5], library_ms=at[6],
                         device_ms=at[7], library_device_ms=at[8]))
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def drive_sync(torch, mods, hfs, dev, card):
    """Phase 4 of the sync route and the dense pipelines: lane_dfa_sync on
    SYNC_DECODED (each round's short scan, the 0-chain and fix scans, the
    tail lane's candidate scan), the tiled sync decode of (a), the dense
    pipeline on (a) and (d) and the compaction pipeline on (d); then the
    device times of both discoveries and the walls.  Raises on any
    failure; returns the launches summed."""
    from huffmandecoderongpus_tpu_torch.models import get_decoder
    from huffmandecoderongpus_tpu_torch.ops import (
        candidate_scan,
        compact,
        lane_decode_dense,
        lane_scan,
        lanedfa_sync,
    )
    from huffmandecoderongpus_tpu_torch.ops import lanedfa_decode as ld

    total = dict.fromkeys(mods, 0)

    def add(ran):
        for n, c in ran.items():
            total[n] += c

    def sync(what, r, fn):
        r0, f0 = lanedfa_sync.rounds, lanedfa_sync.fix_scans
        out, ran = counted(torch, mods, fn)
        rounds = lanedfa_sync.rounds - r0
        fixes = lanedfa_sync.fix_scans - f0
        expect(f"{what} ({rounds} rounds, {fixes} fix scan)",
               np.array_equal(out, r), ran,
               dict(short_candidate_scan=rounds, lane_scan=1 + fixes,
                    candidate_scan=1))
        add(ran)

    for k in SYNC_DECODED:
        name, r, h = hfs[k]
        sync(f"lane_dfa_sync {name}", r, lambda h=h: get_decoder(
            "lane_dfa_sync", device=DEVICE)(h))
    name, r, h = hfs["a"]
    sync(f'decode_lanedfa_tiled(discovery="sync") {name}', r,
         lambda: ld.decode_lanedfa_tiled(h, device=DEVICE, discovery="sync"))

    for k in SYNC:
        name, r, h = hfs[k]
        st, entry, out_rows = dense_staging(torch, h, dev)
        kw = dict(B=st["B"], H=st["H"], N=st["N"])
        for m in mods.values():
            m.launches = 0
        # the dense pipeline: candidate scan, compose, dense decode, trim
        cnt, ex = candidate_scan.candidate_scan(st["bits"], st["tab"], **kw)
        entry = ld.compose(cnt, ex)[0]
        dense, counts = lane_decode_dense.lane_decode_dense(
            st["bits"], st["tab"], entry, out_rows=out_rows, **kw)
        out = trimmed(torch, dense, counts)
        ran = {n: m.launches for n, m in mods.items() if m.launches}
        expect(f"dense pipeline {name}", np.array_equal(out, r), ran,
               dict.fromkeys(DENSE_PATH, 1))
        add(ran)
        if k != "d":
            continue
        for m in mods.values():
            m.launches = 0
        cnt, ex = candidate_scan.candidate_scan(st["bits"], st["tab"], **kw)
        entry = ld.compose(cnt, ex)[0]
        sym, valid = lane_scan.lane_scan(st["bits"], st["tab"], entry, **kw)
        cum = torch.cumsum(valid, 0, dtype=torch.int32)
        out = trimmed(torch, compact.compact(cum, sym, out_rows=out_rows),
                      cum[-1])
        ran = {n: m.launches for n, m in mods.items() if m.launches}
        expect(f"compaction pipeline {name}", np.array_equal(out, r), ran,
               dict.fromkeys(COMPACT_PATH, 1))
        add(ran)

    for k in SYNC:
        name, r, h = hfs[k]
        st = ld.stage_lanedfa(h, device=dev, tiled=False)
        bits, tab = st["bits"], st["tab"]
        kw = dict(B=st["B"], H=st["H"], N=st["N"])
        zero = torch.zeros(bits.shape[1], dtype=torch.int32, device=dev)

        def sync_discovery(bits=bits, tab=tab, kw=kw, zero=zero):
            sym0, valid0 = lane_scan.lane_scan(bits, tab, zero, **kw)
            return lanedfa_sync.discover_and_splice(bits, tab, sym0, valid0,
                                                    **kw)

        def candidates(bits=bits, tab=tab, kw=kw):
            entry = ld.compose(*candidate_scan.candidate_scan(bits, tab,
                                                              **kw))[0]
            return lane_scan.lane_scan(bits, tab, entry, **kw)

        fns = {"sync": sync_discovery, "candidates": candidates,
               "candidate_scan alone": lambda bits=bits, tab=tab, kw=kw: (
                   candidate_scan.candidate_scan(bits, tab, **kw))}
        r0 = lanedfa_sync.rounds
        sync_discovery()
        rounds = lanedfa_sync.rounds - r0
        med = {}
        for route, fn in fns.items():
            ts = event_ms(fn, WARMUP + TIMED_RUNS)[WARMUP:]
            med[route] = (statistics.median(ts), min(ts))
        walls = {dec: wall_ms(torch, lambda dec=dec, h=h: get_decoder(
                     dec, device=dev)(h)) for dec in ("lane_dfa_sync",
                                                      "lane_dfa")}
        print(f"[slice] {name}: discovery device ms, median over "
              f"{TIMED_RUNS} runs (sync geometry G={bits.shape[1]} "
              f"B={st['B']}, {rounds} rounds): "
              + "  ".join(f"{rt} {m:.4f} (min {mn:.4f})"
                          for rt, (m, mn) in med.items())
              + f"; walls median over {WALL_RUNS} runs, the host's bit matrix"
              " most of each: "
              + "  ".join(f"{d} {m:.4f} ms (min {mn:.4f})"
                          for d, (m, mn) in walls.items())
              + f"; card {card}", flush=True)
        split = device_breakdown(torch, sync_discovery, ops_by_name=True)
        print(f"[slice] {name}: sync discovery device ms (profiler) "
              + "  ".join(f"{n} {v:.4f}" for n, v in sorted(
                  split.items(), key=lambda kv: -kv[1])),
              flush=True)
    return total


def drive_encoder(torch, hfs, dev, card):
    """Phase 4 of the encoder: encode_lanes on every stream (E1-E3 once
    each, no retry, byte-equal to encode_bytes), lane_wide on the
    device-encoded ENCODE_DECODED streams, the overflow and long-code
    streams (one retry each, on the card), encode_device on (a), then the
    times of (a)-(c).  Raises on any failure; returns the encoder's
    launches summed over the streams (a)-(i)."""
    from huffmandecoderongpus_tpu_torch.huffio import (
        build_tree,
        encode_bytes,
        tree_codes,
    )
    from huffmandecoderongpus_tpu_torch.models import get_decoder
    from huffmandecoderongpus_tpu_torch.ops import (
        e1_pack,
        e2_compact,
        e3_place,
        encode,
        encode_ops,
    )

    mods = {"e1_pack": e1_pack, "e2_compact": e2_compact,
            "e3_place": e3_place}

    def same(hf, want):
        return (hf.bits == want.bits and hf.tree.shape == want.tree.shape
                and np.array_equal(hf.tree, want.tree)
                and np.array_equal(hf.payload, want.payload))

    def drive(name, raw, want, tree=None, lanes=None,
              path=dict.fromkeys(ENCODE_PATH, 1), retries=0):
        for m in mods.values():
            m.launches = 0
        tries = encode.device_retries
        t0 = time.perf_counter()
        hf = encode.encode_lanes(raw, tree=tree, lanes=lanes, device=DEVICE)
        wall = time.perf_counter() - t0
        ran = {n: m.launches for n, m in mods.items() if m.launches}
        tries = encode.device_retries - tries
        ok = same(hf, want)
        print(f"[slice] encode_lanes {name}: {raw.size} bytes -> {hf.bits} "
              f"bits, first encode {wall:.3f} s wall, equal to encode_bytes: "
              f"{ok}; launches {ran}, device retries {tries}", flush=True)
        if not ok:
            raise AssertionError(f"{name}: device-encoded bytes differ")
        if ran != path or tries != retries:
            raise AssertionError(f"{name}: launched {ran} with {tries} "
                                 f"retries, expected {path} and {retries}")
        return ran, hf

    launches = dict.fromkeys(mods, 0)
    encoded = {}
    for k, (name, r, h) in hfs.items():
        ran, encoded[k] = drive(name, r, h)
        for n, c in ran.items():
            launches[n] += c
    print(f"[slice] launches on the encode path: {launches}", flush=True)
    for k in ENCODE_DECODED:
        name, r, _h = hfs[k]
        ok = np.array_equal(get_decoder("lane_wide", device=DEVICE)(
            encoded[k]), r)
        print(f"[slice] lane_wide on the device-encoded {name}: equal to the "
              f"input: {ok}", flush=True)
        if not ok:
            raise AssertionError(f"{name}: device encode -> decode differs")
    # off the first plan, still on the card: the overflow stream runs E2
    # and E3 again with a larger ORP, the long-code stream encode_device
    raw, tree = fib_stream(np.random.default_rng(SEED), build_tree,
                           FIB_SYMBOLS)
    drive("overflow stream (Fibonacci tree, 128 lanes)", raw,
          encode_bytes(raw, tree=tree), tree=tree, lanes=128,
          path=dict(e1_pack=1, e2_compact=2, e3_place=2), retries=1)
    raw, tree = fib_stream(np.random.default_rng(SEED), build_tree,
                           LONG_SYMBOLS)
    drive("long-code stream (Fibonacci tree, 29-bit codes)", raw,
          encode_bytes(raw, tree=tree), tree=tree, path={}, retries=1)
    name, r, h = hfs["a"]
    ok = same(encode_ops.encode_device(r, device=DEVICE), h)
    print(f"[slice] encode_device {name}: equal to encode_bytes: {ok}",
          flush=True)
    if not ok:
        raise AssertionError(f"{name}: encode_device differs")

    for k in "abc":
        name, r, _h = hfs[k]
        st = encode.stage_encode_inputs(r, device=dev)
        p = st["plan"]
        args = (st["data3"], st["lo"], st["hi"], st["nval"])

        def program(args=args, p=p):
            return encode.encode_program(*args, ORP=p["ORP"],
                                         NROWS=p["NROWS"])

        ts = event_ms(program, WARMUP + TIMED_RUNS)[WARMUP:]
        med = statistics.median(ts)
        print(f"[slice] {name}: encode program median {med:.4f} ms over "
              f"{TIMED_RUNS} runs (min {min(ts):.4f}), {r.size / med / 1e6:.3f}"
              f" GB/s encoded; G={p['G']} K={p['K']} ORP={p['ORP']} "
              f"NROWS={p['NROWS']}; card {card}", flush=True)
        split = device_breakdown(torch, program)
        print(f"[slice] {name}: encode device ms per program (profiler) "
              + "  ".join(f"{n} {v:.4f}" for n, v in split.items()),
              flush=True)
        walls = {
            "histogram and tree": wall_ms(torch, lambda r=r: tree_codes(
                build_tree(np.bincount(r, minlength=256)))),
            "staging": wall_ms(torch, lambda r=r: encode.stage_encode_inputs(
                r, device=dev)),
            "encode_lanes": wall_ms(torch, lambda r=r: encode.encode_lanes(
                r, device=dev)),
            "encode_device": wall_ms(torch, lambda r=r: (
                encode_ops.encode_device(r, device=dev))),
            "host encode_bytes": wall_ms(torch, lambda r=r: encode_bytes(r),
                                         runs=HOST_RUNS)}
        print(f"[slice] {name}: encode walls, median (min) ms: "
              + "  ".join(f"{n} {m:.4f} ({mn:.4f})"
                          for n, (m, mn) in walls.items())
              + f"; {WALL_RUNS} runs, host encode_bytes {HOST_RUNS}; "
              f"card {card}", flush=True)
    return launches


def check_probe_kernels(torch, hfs, dev):
    """Phase 5, the probe kernels: P1-P4 against their plain versions at
    every shape of the scripts' sites, bit-exact, each with its time a
    launch (``harness.timing.launch_ms``: 20 launches between two events,
    median of 5), the plain version's and, where one PyTorch call computes
    the same function, that call's; and its bound, from the bytes it must
    move or from the operations it does at the card's peak rate for them
    (``OPS_PER_SM_CLOCK``, the SM count, the maximum SM clock).  Returns
    {kernel: [(shape, err, ms, plain ms, bound ms, bound_by, library ms,
    device ms, library device ms)]} and raises on any difference.  The
    device ms is the kernel's own time on the card (``torch.profiler``):
    back to back, these small launches cost the host more than the card.
    Where a library call stands beside the kernel, the two are timed in
    turns (kernel, library, kernel, library, ...; one trial of 20 launches
    each, median of 5), and the library call's own time on the card is
    taken too."""
    from huffmandecoderongpus_tpu_torch.harness.timing import launch_ms
    from huffmandecoderongpus_tpu_torch.ops import (
        k4_stripped,
        probe_arith,
        probe_gather,
        probe_inc,
    )
    from huffmandecoderongpus_tpu_torch.probes import (
        hw_k4probe,
        probe_vpu,
        probe_vpu2,
    )
    from huffmandecoderongpus_tpu_torch.probes import probe_gather as pgp
    from huffmandecoderongpus_tpu_torch.probes._timing import (
        device_ms,
        sm_clock_mhz,
        us,
    )

    clock_hz = sm_clock_mhz(dev)[1] * 1e6
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    print(f"[probe kernels] bounds at {sms} SMs x {clock_hz / 1e6:.0f} MHz "
          f"(clocks.max.sm): {OPS_PER_SM_CLOCK}", flush=True)
    rows = {}

    def check(kname, shape, kernel, plain, inputs, ops=None, library=None):
        got = kernel()
        torch.cuda.synchronize()
        want = plain()
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        err = max_abs_err(torch, got, want)
        if library is None:
            ms, lib_ms, lib_own = launch_ms(kernel, device=dev), None, None
        else:
            turns = ([], [])
            for _ in range(5):
                for t, fn in zip(turns, (kernel, library)):
                    t.append(launch_ms(fn, device=dev, trials=1))
            ms, lib_ms = (statistics.median(t) for t in turns)
            lib_own = device_ms(library, dev)
        plain_ms = launch_ms(plain, device=dev, launches=1, trials=2,
                             warmup=1)
        own_ms = device_ms(kernel, dev)
        if ops is None:
            moved = nbytes(*inputs, *got)
            bound, by = moved / HBM_BYTES_PER_S * 1e3, "bytes"
            what = f"{moved} bytes"
        else:
            kind, n = ops
            bound = n / (sms * OPS_PER_SM_CLOCK[kind] * clock_hz) * 1e3
            by, what = "operations", f"{n} {kind} ops"
        rows.setdefault(kname, []).append(
            (shape, err, ms, plain_ms, bound, by, lib_ms, own_ms, lib_own))
        print(f"[probe kernels] {kname} {shape}: max_abs_err {err} "
              f"(tolerance 0)  kernel {ms:.5f} ms (on the card "
              f"{us(own_ms)})  plain {plain_ms:.4f} ms  "
              f"bound {bound:.6f} ms ({what})"
              + ("" if lib_ms is None else f"  library {lib_ms:.5f} ms (on "
                 f"the card {us(lib_own)}; in turns with the kernel)"),
              flush=True)
        if err:
            raise AssertionError(f"{kname} {shape} differs from its plain "
                                 "version")

    i32 = dict(dtype=torch.int32, device=dev)
    xp = torch.zeros((8, 128), **i32)
    check("probe_inc", "(8,128)", lambda: probe_inc.probe_inc(xp),
          lambda: probe_inc.probe_inc_ref(xp), (xp,), library=lambda: xp + 1)
    xg = torch.arange(4 * 32 * 128, **i32).reshape(4, 32, 128)
    check("probe_inc", "grid (4,32,128)", lambda: probe_inc.probe_grid(xg),
          lambda: probe_inc.probe_grid_ref(xg), (xg,))

    per_step = probe_arith.OPS_A_STEP
    x = probe_vpu2.script_input(dev)
    for P in probe_vpu2.CHAINS:
        S = probe_vpu2.STEPS
        check("probe_arith", f"xor3 P={P} S={S} (128,128)",
              lambda P=P, S=S: probe_arith.probe_arith(x, body="xor3", S=S,
                                                       P=P),
              lambda P=P, S=S: probe_arith.probe_arith_ref(x, body="xor3",
                                                           S=S, P=P),
              (x,), ops=("int32", per_step["xor3"] * P * S * x.numel()))
    for dt in (torch.int32, torch.int16):
        xa = torch.ones((128, 128), dtype=dt, device=dev)
        S = probe_vpu.STEPS
        check("probe_arith", f"addxor S={S} (128,128) {dt}",
              lambda xa=xa, S=S: probe_arith.probe_arith(xa, body="addxor",
                                                         S=S),
              lambda xa=xa, S=S: probe_arith.probe_arith_ref(
                  xa, body="addxor", S=S),
              (xa,), ops=("int32", per_step["addxor"] * S * xa.numel()))
    xm = torch.arange(32 * 128, **i32).reshape(32, 128)
    check("probe_arith", "mul3 S=64 (32,128)",
          lambda: probe_arith.probe_arith(xm, body="mul3", S=64),
          lambda: probe_arith.probe_arith_ref(xm, body="mul3", S=64),
          (xm,), ops=("int32", per_step["mul3"] * 64 * xm.numel()))

    for label, axis, tab_np, idx_np in pgp.cases():
        tab = torch.from_numpy(tab_np).to(dev)
        idx = torch.from_numpy(idx_np).to(dev)
        k64 = idx.long()
        check("probe_gather", label,
              lambda tab=tab, idx=idx, axis=axis: probe_gather.probe_gather(
                  tab, idx, axis=axis),
              lambda tab=tab, idx=idx, axis=axis: (
                  probe_gather.probe_gather_ref(tab, idx, axis=axis)),
              (tab, idx),
              library=lambda tab=tab, k64=k64, axis=axis: tab.gather(axis,
                                                                     k64))
    for dt in probe_vpu.I16_CASES:
        tab, idx = probe_vpu.i16_case(dt, dev)
        k64 = idx.to(torch.int32).long()
        check("probe_gather", f"axis1 (16,128,{dt})",
              lambda tab=tab, idx=idx: probe_gather.probe_gather(tab, idx,
                                                                 axis=1),
              lambda tab=tab, idx=idx: probe_gather.probe_gather_ref(
                  tab, idx, axis=1), (tab, idx),
              library=lambda tab=tab, k64=k64: tab.view(torch.int16).gather(
                  1, k64))
    for shape, shift, ax in probe_vpu.ROLLS:
        xr = probe_vpu.roll_case(shape, dev)
        check("probe_gather", f"roll {shape} s={shift} ax={ax}",
              lambda xr=xr, shift=shift, ax=ax: probe_gather.probe_roll(
                  xr, shift, axis=ax),
              lambda xr=xr, shift=shift, ax=ax: probe_gather.probe_roll_ref(
                  xr, shift, axis=ax),
              (xr,), library=lambda xr=xr, shift=shift, ax=ax: torch.roll(
                  xr, shift, ax))
    # the chains on the scripts' inputs (every chain a fixed point, a warp's
    # loads conflict-free), then on seeded ones whose rows differ, where a
    # wrong step count, row or broadcast shows
    xp = probe_vpu2.permuted(dev)
    for what, xc in (("", x), (" permuted", xp)):
        for P in probe_vpu2.CHAINS:
            S = probe_vpu2.STEPS
            check("probe_gather", f"chain{what} P={P} S={S} (128,128)",
                  lambda P=P, S=S, xc=xc: probe_gather.probe_gather_chain(
                      xc, xc, P=P, S=S),
                  lambda P=P, S=S, xc=xc: probe_gather.probe_gather_chain_ref(
                      xc, xc, P=P, S=S),
                  (xc,), ops=("shared loads", P * S * xc.numel()))
    for what, (tab, idx) in (("", probe_vpu.chain_case(dev)),
                             (" seeded", probe_vpu.chain_check_case(dev))):
        S = probe_vpu.STEPS
        check("probe_gather", f"chain broadcast{what} S={S} (128,128)",
              lambda tab=tab, idx=idx, S=S: probe_gather.probe_gather_chain(
                  tab, idx, P=1, S=S, broadcast=True),
              lambda tab=tab, idx=idx, S=S: (
                  probe_gather.probe_gather_chain_ref(tab, idx, P=1, S=S,
                                                      broadcast=True)),
              (tab, idx), ops=("shared loads", S * idx.numel()))

    sym, val, ORP = hw_k4probe.k3_output(hfs["a"][2], dev)
    for stage in k4_stripped.STAGES:
        check("k4_stripped", f"{stage} (a) {tuple(sym.shape)} ORP={ORP}",
              lambda stage=stage: k4_stripped.k4_stripped(sym, val, ORP=ORP,
                                                          stage=stage),
              lambda stage=stage: k4_stripped.k4_stripped_ref(
                  sym, val, ORP=ORP, stage=stage), (sym, val))
    return rows


def drive_probes(torch, hfs, dev, card):
    """Phase 5, the probe programs and the stage profiler: the six probes
    (``probes.run``, their kernels' launch counts set to 0 just before and
    read just after; each raises on a WRONG line), then ``prof`` on (a)
    ``widescan`` and (d) ``lanedfa`` through the command's function on
    their `.huff` files, each report's every key present and >= 0.
    Returns the probe kernels' launches."""
    import tempfile

    from huffmandecoderongpus_tpu_torch import probes
    from huffmandecoderongpus_tpu_torch.harness import cli
    from huffmandecoderongpus_tpu_torch.huffio import write_huff
    from huffmandecoderongpus_tpu_torch.ops import (
        k4_stripped,
        probe_arith,
        probe_gather,
        probe_inc,
    )

    mods = {"probe_inc": probe_inc, "probe_arith": probe_arith,
            "probe_gather": probe_gather, "k4_stripped": k4_stripped}
    streams = {k: hfs[k] for k in "af"}

    def run_all():
        for name, (_mod, script) in probes.PROBES.items():
            print(f"[probes] {name} ({script}); card {card}", flush=True)
            probes.run(name, DEVICE, streams=streams)

    _, ran = counted(torch, mods, run_all)
    print(f"[probes] launches of the probe kernels: {ran}", flush=True)
    if set(ran) != set(mods):
        raise AssertionError(f"a probe kernel was not launched: {ran}")

    keys = {"widescan": ["k1_scan_discovery", "k2_compose", "k3_fix_splice",
                         "k4_compact", "total"],
            "lanedfa": ["host_bit_matrix", "candidate_scan", "compose",
                        "main_scan", "host_compaction", "total"]}
    with tempfile.TemporaryDirectory() as tmp:
        for k, which in (("a", "widescan"), ("d", "lanedfa")):
            name, _r, h = hfs[k]
            path = str(pathlib.Path(tmp) / f"{k}.huff")
            write_huff(path, h)
            print(f"[prof] {name}; card {card}", flush=True)
            report = cli.prof(path, which, None, DEVICE)
            if list(report) != keys[which] or min(report.values()) < 0:
                raise AssertionError(f"prof {which} on {name}: {report}")
    return ran


def wall_ms(torch, fn, runs=WALL_RUNS):
    """(median, min) host-clock ms of ``fn`` ending in a synchronize, over
    ``runs`` runs."""
    ts = []
    for _ in range(runs):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ts.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(ts), min(ts)


def time_oneshot(torch, ws, oneshot, name, raw, hf, dev, card):
    """Phase 4 times of a one-shot stream: the one-shot program and the
    four-kernel program on the same staged inputs (CUDA events, median of
    TIMED_RUNS after WARMUP), the decode walls of both routes, and the
    one-shot kernel's split by phase (its timer stamps)."""
    st = ws.stage_widescan_inputs(hf, device=dev)
    args = (st["words"], st["tab"], st["lim"])
    kw1, kw4 = oneshot.program_args(st), ws.program_args(st)
    med = {}
    for route, fn in (
            ("one-shot", lambda: oneshot.oneshot_program(*args, **kw1)),
            ("four-kernel", lambda: ws.wide_decode_program(*args, **kw4))):
        ts = event_ms(fn, WARMUP + TIMED_RUNS)[WARMUP:]
        med[route] = (statistics.median(ts), min(ts))
    wall = {route: wall_ms(torch, lambda o=o: ws.decode_widescan(
                hf, device=dev, oneshot=o))
            for route, o in (("one-shot", None), ("four-kernel", False))}
    splits = [oneshot.phase_ms(*args, **kw1) for _ in range(5)]
    phases = {ph: statistics.median(sp[ph] for sp in splits)
              for ph in oneshot.PHASES}
    q = st["plan"]
    print(f"[slice] {name}: device program median over {TIMED_RUNS} runs "
          + "  ".join(f"{r} {m:.4f} ms (min {mn:.4f})"
                      for r, (m, mn) in med.items())
          + "; decode wall median over " + f"{WALL_RUNS} runs "
          + "  ".join(f"{r} {m:.4f} ms (min {mn:.4f})"
                      for r, (m, mn) in wall.items())
          + f"; {raw.size} bytes, G={q['G']} B={q['B']} H={st['H']} "
          f"md={st['md']} NS={st['NS']}; card {card}", flush=True)
    print(f"[slice] {name}: one-shot device ms by phase (timer stamps, "
          "median of 5) " + "  ".join(f"{ph} {v:.4f}"
                                      for ph, v in phases.items())
          + f"; sum {sum(phases.values()):.4f}", flush=True)
    # K1's chain floor: the longest lane's main chain, a dependent lookup a
    # 2-bit chunk (CHAIN_CYCLES_A_ROW) at the maximum SM clock
    from huffmandecoderongpus_tpu_torch.probes._timing import sm_clock_mhz

    clock = sm_clock_mhz(DEVICE)[1] * 1e6
    chunks = min(int(st["lim"].max()), q["steps_p"]) // 2
    floor_ms = chunks * CHAIN_CYCLES_A_ROW / clock * 1e3
    card_ms = device_breakdown(torch, lambda: oneshot.oneshot_program(
        *args, **kw1), per_launch=True).get("oneshot")
    plan = oneshot.oneshot_plan(q["G"], st["H"], st["md"], q["SEG"],
                                q["steps_p"], q["ORP"], st["NS"])
    own = "not measured" if card_ms is None else f"{card_ms:.4f} ms"
    print(f"[oneshot] {name}: card {own} (profiler), events "
          f"{med['one-shot'][0]:.4f} ms; by phase "
          + "  ".join(f"{ph} {v:.4f}" for ph, v in phases.items())
          + f"; K1 chain floor {floor_ms:.4f} ms ({chunks} chunks x "
          f"{CHAIN_CYCLES_A_ROW} cycles at {clock / 1e6:.0f} MHz), K1 "
          f"{phases['K1'] / floor_ms:.1f} times it; four-kernel program "
          f"{med['four-kernel'][0]:.4f} ms (events); T={plan['T']} blocks "
          f"{plan['blocks']}; card {card}", flush=True)


#: profiler sessions a breakdown may take: now and then a session records
#: no device activity, or only some of the runs' kernels, the rest
#: arriving in the next session (on the card's host, seen in some
#: processes and not others); such a session is taken again
PROFILER_TRIES = 3


def device_breakdown(torch, fn, runs=5, ops_by_name=False, per_launch=False,
                     counts=False, symbols=None):
    """Device time per call of ``fn`` (ms) by kernel, from torch.profiler:
    the port's kernels by name (``symbols``, default DEVICE_SYMBOLS: a
    key and the device names that count under it), everything else (the
    torch ops around them) together, or with ``ops_by_name`` each under its
    own kernel name.  Each session follows a one-call session that is
    thrown away (it takes any records a session before left late).  A
    session that saw no device time, or a kernel a number of times that is
    not a multiple of the runs, is taken again, up to PROFILER_TRIES
    sessions; if none was whole, returns {} and says so (the callers then
    print "not measured": no other clock stands in for the card's).  With
    ``per_launch`` each value is instead the mean time of one launch of
    that kernel over the launches a session recorded, which a lost or late
    record does not bias: the time a call of a ``fn`` that launches one
    kernel once.  With ``counts`` it returns (times, launches): each key's
    kernel launches a call, from a whole session only (({}, {}) if none
    was whole)."""
    from torch.profiler import ProfilerActivity, profile

    symbols = symbols or DEVICE_SYMBOLS
    fn()
    torch.cuda.synchronize()
    for _ in range(PROFILER_TRIES):
        with profile(activities=[ProfilerActivity.CUDA]):
            fn()
            torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(runs):
                fn()
            torch.cuda.synchronize()
        out, count, whole = {}, {}, True
        for e in prof.key_averages():
            if e.device_type != torch.autograd.DeviceType.CUDA:
                continue
            whole = whole and e.count % runs == 0
            key = next((k for k, syms in symbols.items()
                        if any(sym in e.key for sym in syms)),
                       e.key[:60] if ops_by_name else "torch ops")
            out[key] = out.get(key, 0.0) + e.self_device_time_total / 1e3
            count[key] = count.get(key, 0) + e.count
        if out and (whole or (per_launch and not counts)):
            times = {k: v / (count[k] if per_launch else runs)
                     for k, v in out.items()}
            if not counts:
                return times
            return times, {k: n // runs for k, n in count.items()}
    print(f"[profiler] no whole record in {PROFILER_TRIES} sessions: not "
          "measured", flush=True)
    return ({}, {}) if counts else {}


if __name__ == "__main__":
    sys.exit(main())
