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

  1. device   the card's name and power limit (nvidia-smi), and the host
              CPU (lscpu, /proc/cpuinfo)
  2. build    the kernels from csrc/ with nvcc, and the build time
  3. kernels  each kernel against its plain torch version on the same CUDA
              inputs, at the shapes its decode path gives it: K1-K4 on (a),
              (b) and (d) (whose lanes overflow their rows, so (d) is not
              trimmed), k1_scan/K2/k3_fix/K4 on (c), with K1's plan, its
              own time on the card (profiler) and its chain floor (the
              longest lane's chunks x CHAIN_CYCLES_A_ROW) on (a), (b), (d)
              and K1''s (its bits to row B + H, a lookup a bit) on (c)
              ([k1] lines), K3''s card time beside its longest cut's
              floor on (c) ([k3]), K3's (k3_fix2) on (a), (b) and (d) and
              the batch K3's (k3_fix2_c01) on both batches, each from the
              fresh --card-ms process beside its events time, its longest
              cut, its chain floor (the longest cut's 2-bit chunks x
              CHAIN_CYCLES_A_ROW) and the lanes it fixes ([k3] lines), both
              K3 kernels also at their edges (probes.streams.K3_CASES: md
              2-8, NS 1, 2 and 8, odd entries and entries on a word's last
              bit, cuts on a cell boundary, mid-cell and past the last
              segment, lanes with cut 0, G = 200, two trees in adjacent
              blocks), K2's card time and kernel launches a call
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
              staging of (a)-(c) and (e)-(i) (E3 with the lane offsets and
              the phase shift folded in), with an [e1], an [e2] and an
              [e3] line each (the plan, the card time (profiler, taken in
              a fresh process of this script run with --card-ms, which
              prints it as JSON and exits) and the bytes bound),
              E1-E3 also at their edges (probes.streams.
              E_CASES: all 256 symbols, 26-bit codes, a one-symbol tree,
              lanes with no symbol, row blocks starting in pad rows and
              inside a granule, the overflow stream; E2 and E3 also at an
              ORP that drops ranks, E_SMALL_ORP, so E3 clamps lanes), E3
              also at its own (E3_CASES: three and more lanes in a
              granule, runs of empty lanes, a lane clamped at ORP, no
              bits, many tiles, an odd lane count); K1's main scan
              (k1_main) and K4 on the indexed (a), (b) and (i) (a [k1]
              line each: card ms, plan, chain floor), k1_main also at its
              edges (probes.streams.K1_MAIN_CASES: every block ending on
              the last bit of steps_p beside pad lanes, one lane, md 3, 5
              and 7, NS 2 and 8) and K2 at the edges of its tiles
              (K2_CASES: one lane, part tiles, HP 128 from start 127,
              entries past HP, 65 tiles, merged maps), the
              indexed lane scan on the indexed (a) and (c) with a [scan]
              line each (its card time from the --card-ms process, in
              cycles a row at the maximum SM clock, its plan, and the
              chain floor: the longest lane's B rows one bit, and B / 2
              two bits, a lookup) and at its edges (probes.streams.
              INDEXED_SCAN_CASES: G = 1, 3, 31, 33, an index's lanes
              untiled and tiled with zero-length pad lanes, B under one
              tile, an md = 1 tree, a table of 16 chunks, views at +1 and
              +4 bytes), the short candidate scan at its edges
              (SHORT_SCAN_CASES: W = H + 1, 128 and every row, the stream
              end mid-lane, a tree 140 tall, chains that never resolve,
              merges and exits on one row, bool emissions at +1 byte);
              the batched
              K1/K3 (k1_scan2_c01, k3_fix2_c01), K2 and K4 on the five small
              streams and on (f), (g) and the book2-sized one (a [k1]
              line each); the
              self-synchronizing
              discovery's short candidate scan on the first round of (a)
              and (d) in lane_dfa_sync's geometry (all five outputs; a
              [scan] line each: card time from the --card-ms process,
              cycles a row over W rows, plan, chain floor W rows), and
              the lane scan cut at that round's W rows (its fix scan) from
              the true entry offsets; the dense lane decode on (a) and (d)
              in the tiled geometry from the entry offsets of
              candidate_scan + compose, with a [scan] line each (card
              time from the --card-ms process, cycles a row over B + H
              rows, plan, chain floor B + H rows) and a [dense] line (the
              bytes lanes a window ahead of their block wrote out
              themselves, the kernel's own count), and at its edges
              (probes.streams.DENSE_CASES: G 1, 3, 20, 33 and 100,
              out_rows under the counts, lanes ending early, a lane
              forced a window ahead, a view at +1), and the compaction on
              (d) from cumsum(valid) and sym of the lane scan, each
              trimmed by its counts to the input; bit-exact (tolerance
              0), with both times from CUDA events (and for the
              compaction the time of torch.searchsorted + gather, the
              same function in library calls), and a [compact] line: its
              card time from the --card-ms process against its bytes
              bound, its plan, the blocks whose rank union is wider than
              two chunks and their share of the blocks' cycles (the
              kernel's own count), beside the library calls' time; the
              compaction also at its edges (probes.streams.COMPACT_CASES:
              G 1, 33 and 4,095, steps under and off a chunk, out_rows 0,
              under the counts and over steps, a silent and a full
              column, ranks more than two chunks apart, an offset view);
              the speculative pipeline on (a), (b) and (i): S1 (step0,
              sym), S2's tile launch (kept levels 2..m) and each pair
              launch (a kept level from the one below), the one-level
              yardstick at every level (int16 and int32 levels, the int16
              -> int32 one among them; its even levels equal to the kept
              ones) and S3 (result, found_size), each against its plain
              version on the same CUDA inputs, tolerance 0, with
              CUDA-event times and bytes bounds (the pairs and the levels
              summed over a decode), and at its edges (the tiny inputs:
              sizes 1, 2, 3, 7; a top level the first int32 one and the
              last int16 one; a stream cut 3 bits short, found_size -1
              from both; probes.streams.SPEC_CASES on their own tiles:
              bits off and on a tile, a halo past the end, trees 14, 15,
              17, 20 and 22 tall (S1's table whole in shared memory, or
              in two levels), S3's block of outputs one under, at and one
              over, streams cut short with a taken -1 in a block's prefix
              or only below it, found_size -1 from both; S1 also on
              tables less some codes, probes.streams.NO_CODE_CASES); the
              one-thread S4 on (e) and (f) and at those edges (the trees
              17-22 tall read its table from device memory) against its
              plain walk (out and n) beside its chain floor
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
              and the walls of lane_dfa_sync and lane_dfa.
              The speculative route, each decode counted on its own:
              get_decoder("spec_xla") on (a)-(i) launches S1 once, S2's
              tile launch once and a pair launch a kept level above its m
              (s2_plan: 7 on (a)) and S3 once and nothing else, and
              get_decoder("onethread_device") on (a), (e), (f), (g), (i)
              launches S4 once, each equal to its input (the one-level
              spec_double, the yardstick, is on no decode path: its
              launches are 0 and it is not held to a launch); a [spec]
              line for (a)-(c) (each launch's card time from the
              --card-ms process beside its bytes bound, S2's launches a
              decode and their sum against the function's bound beside
              the one-level spec_double's sum over the levels, the
              pipeline's program by CUDA events and the spec_xla wall
              beside lane_wide's program and wall) and an [onethread] line for
              (a), (f) and (g) (card time against the chain floor, a
              dependent lookup a symbol, in cycles a symbol).
              The suites: a corpus directory of the reference's five
              suite corpora (hello, paper1, news, book2, kjv.txt) as
              seeded text at their real sizes (SUITE_CORPORA), encoded by
              the host encoder beside their raw files, under
              HUFF_FILES_DIR; the host C++ runtime built with g++; every
              serial decoder on every corpus through evalandshow (a
              checked run and the minimum of SUITE_REPEATS more); then,
              the launch counts set to 0 just before and read just after,
              the suites bigtable, quickgraph1, quickgraph2, opt, batch
              and testall through the CLI's run_suite on the card and the
              verify command, each suite's rows and wall printed ([suite]
              lines): every row byte-equal to its raw file (a mismatch
              raises), every kernel of SUITE_PATH launched; then the DFA
              table builds on kjv.txt's tree at jumpbits 1-14 (host ms)
              and each device row's speedup over simple a corpus.
              The multi-device layer ("sharded"), on virtual shards of
              the one card (a device named D times in make_mesh), each
              decode counted on its own: spec_sharded, lane_sharded and
              lane_sharded_wide through the registry (a shard a visible
              card) on (a); decode_sharded, decode_lane_sharded and
              decode_lane_sharded_wide on (a) and (b) at 1, 2 and 4
              shards, each shard launching its path once (the block
              decode no kernel, the lane-DFA body candidate_scan and
              lane_scan, the wide body K1, K2 twice, K3 and K4);
              decode_lane_sharded_indexed on the indexed (a) at 2 and 4
              shards (k1_main and K4 a shard); (c) (md 1) through
              decode_lane_sharded_wide's fallback to the lane-DFA body;
              each shard's K1-K4 at 2 shards on (a) against their plain
              versions, tolerance 0; a two-process gloo job sharing the
              card (two shards a process) and a one-process NCCL group
              (two shards) through decode_sharded_multihost, both
              processes of this script run with --multihost-worker, each
              printing its bytes' SHA-256, equal to the input's; then
              each decode's program (CUDA events) and wall beside
              lane_wide's program on the same stream, and the scaling
              sweep's table on (a) (lane and wide paths) at 1, 2 and 4
              shards ([sharded] lines)
  5. probes   the four probe kernels (probe_inc, probe_arith, probe_gather,
              k4_stripped) against their plain versions at every shape of
              the scripts/ sites they replace (the chained gathers also on
              seeded inputs whose rows differ; P4 also at
              probes.streams.P4_CASES: cells_p 100, 256 and 412, G 64, ORP
              128 and 132, nib all 0xFF, negative sym, offset views),
              bit-exact, a [p4] line a stage on (a)'s K3 output (card
              time from the --card-ms process against the bytes bound,
              beside k4_compact's card time on the same cells in that
              process, and the plan), with kernel,
              plain and library times and their bounds (bytes, or integer
              ops and shared-memory loads at the card's peak rates and its
              maximum SM clock); then the six probe programs
              (probes.run: dispatch, k1fixed on (f) and (a), k4 on (a),
              gather, vpu, vpu2), the probe kernels' launch counts set to
              0 just before and read just after, each kernel launched and
              no line WRONG; then the prof command's breakdown of (a)
              widescan, (d) lanedfa and (a) speculative, every stage
              present and >= 0; then
              the host's split of a probe_inc launch (probes.hw_dispatch:
              checks, output, library, stream, pointers, ctypes call,
              launch, check, each timed over 1,000 calls), on the wrappers'
              path and on one that makes a Python object at each step, and
              the host's time a whole call of probe_inc, probe_gather and
              probe_roll beside x + 1, torch.gather and torch.roll.
              P1 and P3 are timed in turns with their PyTorch call (x + 1,
              torch.gather, torch.roll), both also on the card (profiler)
  6. result   one JSON line for the twenty-nine kernels (times, launches,
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

#: the suite phase's corpus directory: the reference's five MAINRUN_NAMES
#: as seeded text (text_like, drawn from SUITE_SEED) at the real corpora's
#: sizes (kjv.txt's from its `.huff` header, as KJV_BYTES), each encoded
#: by the port's host encoder with its raw file beside it
SUITE_SEED = 22
SUITE_CORPORA = {"hello": 12, "paper1": PAPER1_BYTES, "news": 377_109,
                 "book2": 610_856, "kjv.txt": KJV_BYTES}
#: the suites run through run_suite on the card, and their --repeats
SUITES = ("bigtable", "quickgraph1", "quickgraph2", "opt", "batch",
          "testall")
SUITE_REPEATS = 1

_CSRC = "huffmandecoderongpus_tpu_torch/csrc/"
_PWS = "huffmandecoderongpus_tpu/ops/pallas_widescan.py:"
_PLD = "huffmandecoderongpus_tpu/ops/pallas_lanedfa.py:"
_PEN = "huffmandecoderongpus_tpu/ops/pallas_encode.py:"
_SPEC = "huffmandecoderongpus_tpu/ops/speculative.py:"
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
    # the speculative pipeline's XLA stages, and the one-thread while_loop
    "spec_all_bits": (_CSRC + "spec_all_bits.cu", _SPEC + "105", "a"),
    "spec_double": (_CSRC + "spec_double.cu", _SPEC + "122", "a"),
    "spec_tile": (_CSRC + "spec_tile.cu", _SPEC + "122", "a"),
    "spec_pair": (_CSRC + "spec_pair.cu", _SPEC + "122", "a"),
    "spec_query": (_CSRC + "spec_query.cu", _SPEC + "142", "a"),
    "onethread": (_CSRC + "onethread.cu",
                  "huffmandecoderongpus_tpu/models/onethread.py:23", "f"),
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
#: the speculative pipeline's kernels (S2: the tile launch once and a pair
#: launch a kept level above its m); the kernels checked and timed against
#: their plain versions that no decode path launches (the one-level
#: spec_double, S2's yardstick); the streams spec_xla decodes in phase 4,
#: those whose stages phase 3 checks and those with a [spec] line; and the
#: streams onethread_device decodes, those whose S4 phase 3 checks against
#: its plain walk and those with an [onethread] line
SPEC_PATH = ("spec_all_bits", "spec_tile", "spec_pair", "spec_query")
YARDSTICKS = ("spec_double",)
#: the kernels the suites' device rows launch on these corpora: lane_wide
#: (the one-shot on paper1 and news, K1-K4 on book2 and kjv.txt, the
#: lane-DFA chain on hello), lane_dfa_pallas (the two scans), spec_xla
#: (S1-S3) and the batch suite's program
SUITE_PATH = ("oneshot", "k1_scan2", "k2_compose", "k3_fix2", "k4_compact",
              "candidate_scan", "lane_scan", "k1_scan2_c01", "k3_fix2_c01",
              *SPEC_PATH)
SPEC_DECODED = "abcdefghi"
SPEC_CHECKED = "abi"
SPEC_TIMED = "abc"
ONETHREAD_DECODED = "aefgi"
ONETHREAD_CHECKED = "ef"
ONETHREAD_TIMED = "afg"

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
                  "lane_scan_indexed": ("lane_scan_indexed_kernel",),
                  "k1_scan2_c01": ("k1_scan2_c01_kernel",),
                  "k3_fix2_c01": ("k3_fix2_c01_kernel",),
                  # before candidate_scan: its name holds candidate_scan's
                  "short_candidate_scan": ("short_candidate_scan_kernel",),
                  "candidate_scan": ("candidate_scan_kernel",),
                  "lane_scan": ("lane_scan_kernel",),
                  "lane_decode_dense": ("lane_decode_dense_kernel",),
                  "compact": ("lanedfa_compact_kernel",),
                  "spec_all_bits": ("spec_all_bits_kernel",),
                  "spec_double": ("spec_double_kernel",),
                  "spec_tile": ("spec_tile_kernel",),
                  "spec_pair": ("spec_pair_kernel",),
                  "spec_query": ("spec_query_kernel",),
                  "onethread": ("onethread_kernel",)}


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


def check_kernels(torch, name, raw, hf, dev, decodes=True, k3_card=None):
    """Phase 3 on one stream of the wide program: K1-K4 (the 1-bit K1/K3
    for md = 1) against their plain versions on the inputs the slice gives
    them, a [k3] line (K3's card time ``k3_card``, from ``card_ms_fresh``,
    for md >= 2), then K4's own time on the card (profiler) against its
    bytes bound (a [k4] line).  Returns {kernel: (max_abs_err, kernel ms,
    plain ms)}
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
    if st["chunk2"]:
        k3_line(name, "k3_fix2", k3_card, cut, p["steps_p"], rows)
    else:
        k3_line(name, "k3_fix", device_breakdown(torch, lambda: fix[1](
            wmat, st["tab"], entry, cut, cut_slot, s_k, v_k, **kw),
            per_launch=True).get("k3_fix"), cut, p["steps_p"], rows, 1,
            "profiler")
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


def k3_line(name, kname, card_ms, cut, steps_p, rows, step_bits=2,
            source="profiler, a fresh process"):
    """A [k3] line for one K3 stream (k3_fix2, k3_fix2_c01, or k3_fix with
    ``step_bits`` 1): the kernel's card time ``card_ms`` (from ``source``,
    or None) and events time beside the chain floor, the longest cut (at
    most steps_p) in lookups of ``step_bits`` bits x CHAIN_CYCLES_A_ROW at
    the maximum SM clock, and the lanes it fixes.  The card time goes into
    rows[kname] as device_ms."""
    from huffmandecoderongpus_tpu_torch.probes._timing import sm_clock_mhz

    clock = sm_clock_mhz(DEVICE)[1] * 1e6
    longest = int(cut.clamp(0, steps_p).max()) if cut.numel() else 0
    steps = -(-longest // step_bits)
    floor_ms = steps * CHAIN_CYCLES_A_ROW / clock * 1e3
    r = rows[kname]
    r["device_ms"] = card_ms
    card = ("not measured" if card_ms is None else
            f"{card_ms:.4f} ms ({source}), {card_ms / floor_ms:.1f} times "
            "the floor" if floor_ms else f"{card_ms:.4f} ms ({source})")
    print(f"[k3] {name}: {kname} card {card}; events {r['ms']:.4f} ms; "
          f"longest cut {longest} bits, chain floor {floor_ms:.4f} ms "
          f"({steps} lookups x {CHAIN_CYCLES_A_ROW} cycles at "
          f"{clock / 1e6:.0f} MHz); lanes fixed {int((cut > 0).sum())} of "
          f"{cut.numel()}", flush=True)


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
        k3_line(what, "k3_fix", device_breakdown(
            torch, fix, per_launch=True).get("k3_fix"), cut, kw["steps_p"],
            rows, 1, "profiler")
    return out


def check_k3_cases(torch, dev):
    """Phase 3, K3 for md >= 2 (k3_fix2 and the batch's k3_fix2_c01) at its
    edge cases (``probes.streams.K3_CASES``: md 2-8, NS 1, 2 and 8, odd
    entries and entries on a word's last bit, cuts on a cell boundary,
    mid-cell and past the last segment, lanes with cut 0, G = 200, two trees
    in adjacent blocks) against the plain versions.  Returns {case: rows},
    as check_kernels."""
    from huffmandecoderongpus_tpu_torch.ops import k3_fix2, k3_fix2_c01
    from huffmandecoderongpus_tpu_torch.probes import streams as ps

    out = {}
    for case in ps.K3_CASES:
        kernel, inputs, kw, _hfs = ps.k3_case(case, dev)
        mod = k3_fix2 if kernel == "k3_fix2" else k3_fix2_c01
        what = f"k3 {case}"
        rows = out[what] = {}
        head, (sym, val), tail = inputs[:5], inputs[5:7], inputs[7:]
        # K3 splices in place and is idempotent on its own output
        s_k, v_k = sym.clone(), val.clone()
        s_p, v_p = sym.clone(), val.clone()
        comparer(torch, what, rows)(
            kernel,
            lambda: getattr(mod, kernel)(*head, s_k, v_k, *tail, **kw),
            lambda: getattr(mod, kernel + "_ref")(*head, s_p, v_p, *tail,
                                                  **kw),
            (), moved=k3_moved(inputs[1], inputs[3], inputs[4])
            + nbytes(*tail))
    return out


def k3_launch(torch, raws, dev, cuts="real"):
    """(kernel name, fn, cut, steps_p) of K3 (md >= 2) on the cuts that the
    kernels K1 and K2 and ``fix_rows`` give: k3_fix2 on the staging of one
    stream (``raws`` a list of one byte array), k3_fix2_c01 on the batch
    staging of several.  fn() launches it once, in place on a copy of K1's
    cells (K3 is idempotent on its own output, so repeated launches do the
    same work).  ``cuts`` "alone" keeps only the lane of the longest cut
    (every other lane's cut 0), "all" gives every lane that lane's entry
    and cuts: its chain alone, and beside every lane of its warp."""
    from huffmandecoderongpus_tpu_torch.huffio import encode_bytes
    from huffmandecoderongpus_tpu_torch.ops import (
        batch,
        k1_scan2,
        k1_scan2_c01,
        k2_compose,
        k3_fix2,
        k3_fix2_c01,
    )
    from huffmandecoderongpus_tpu_torch.ops import widescan as ws

    hfs = [encode_bytes(r) for r in raws]
    if len(hfs) == 1:
        st = ws.stage_widescan_inputs(hfs[0], device=dev)
        tab, extra = st["tab"], ()
        fix = dict(C0=st["C0"], C1=st["C1"], NS=st["NS"])
    else:
        st = batch.stage_batch_inputs(hfs, device=dev)
        tab, extra, fix = st["tabs"], (st["c01"], st["bstream"]), {}
    p = st["plan"]
    wmat = ws.words_matrix(st["words"], -(-p["steps_p"] // 32))
    kw = dict(steps_p=p["steps_p"], SEG=p["SEG"], md=st["md"])
    k1a = dict(B=p["B"], H=st["H"], steps=p["steps"], **kw)
    if extra:
        sym, val, _cnt, exmap, mrowmap = k1_scan2_c01.k1_scan2_c01(
            wmat, tab, st["lim"], *extra, **k1a)
        exmap[:, list(st["last_live"])] = 0
    else:
        sym, val, _cnt, exmap, mrowmap = k1_scan2.k1_scan2(
            wmat, tab, st["lim"], **fix, **k1a)
    entry, _tot = k2_compose.k2_compose(exmap, 0)
    cut, cut_slot = ws.fix_rows(entry, mrowmap, st["lim"], st["H"], st["md"])
    if cuts != "real":
        top = int(torch.argmax(cut))
        keep = torch.arange(cut.numel(), device=cut.device) == top
        if cuts == "alone":
            cut, cut_slot = cut * keep, cut_slot * keep
        else:
            entry, cut, cut_slot = (torch.full_like(t, int(t[top]))
                                    for t in (entry, cut, cut_slot))
    name = "k3_fix2_c01" if extra else "k3_fix2"
    kernel = getattr(k3_fix2_c01 if extra else k3_fix2, name)

    def fn():
        return kernel(wmat, tab, entry, cut, cut_slot, sym, val, *extra,
                      **fix, **kw)

    return name, fn, cut, p["steps_p"]


def k3_card_ms(torch, streams, batches, dev):
    """{key: ms}: K3's card time a launch (as encode_card_ms) on the cuts of
    (a), (b) and (d) (k3_fix2) and of both batches (k3_fix2_c01; keys
    BATCH5 and TRIO, ``batches`` their byte arrays)."""
    out = {}
    for key, raws in ([(k, [streams[k][1]]) for k in "abd"]
                      + list(batches.items())):
        name, fn, _cut, _sp = k3_launch(torch, raws, dev)
        out[key] = device_breakdown(torch, fn, per_launch=True).get(name)
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
    ms}, from ``card_ms_fresh``).  Returns and raises as
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
    (out,) = compare_e3(torch, compare, e3_place, denseT, cnt, bits, NROWS)
    e_line(name, "e3_place", card_ms.get("e3_place"),
           e3_place.e3_plan(p["G"]), rows)
    payload = encode.payload_bytes(out, p["total_bits"]).cpu().numpy()
    if p["total_bits"] != hf.bits or not np.array_equal(payload, hf.payload):
        raise AssertionError(f"{name}: the encode kernels' payload differs "
                             "from the host encoder's")
    print(f"[kernels] {name}: E1-E3 bit-exact; payload equal to the host "
          "encoder's", flush=True)
    return rows


def e3_moved(torch, cnt, ORP, NROWS) -> int:
    """Bytes the fused E3 must move: each lane's counted granules of E2's
    rows (at most ORP) read once, cnt and bits, and the payload written
    once."""
    return (4 * int(torch.clamp(cnt, max=ORP).sum()) + 8 * cnt.numel()
            + 4 * 128 * NROWS)


def compare_e3(torch, compare, e3_place, denseT, cnt, bits, NROWS):
    """The fused E3 (offsets, shift and placement) against its plain
    version through ``compare``, with its bytes bound (e3_moved)."""
    return compare(
        "e3_place", lambda: e3_place.e3_place(denseT, cnt, bits, NROWS=NROWS),
        lambda: e3_place.e3_place_ref(denseT, cnt, bits, NROWS=NROWS), (),
        e3_moved(torch, cnt, denseT.shape[1], NROWS))


def e_line(name, kname, card_ms, plan, rows):
    """An [e1], [e2] or [e3] line for one encoder stream: the kernel's
    plan, its card time ``card_ms`` (or None) against its bytes bound, and
    its events time.  The card time goes into rows[kname] as device_ms."""
    r = rows[kname]
    r["device_ms"] = card_ms
    card = ("not measured" if card_ms is None else
            f"{card_ms:.4f} ms (profiler, a fresh process), "
            f"{card_ms / r['bound_ms']:.1f} times the bound")
    tag = {"e1_pack": "e1", "e2_compact": "e2", "e3_place": "e3"}[kname]
    print(f"[{tag}] {name}: {kname} card {card}; events {r['ms']:.4f} ms; "
          f"bytes bound {r['bound_ms']:.6f} ms; plan {plan}", flush=True)


#: the option that runs this script as card_ms_fresh's child
CARD_ARG = "--card-ms"


def encode_card_ms(torch, streams, dev):
    """{stream: {"e1_pack": ms, "e2_compact": ms, "e3_place": ms}}: E1's,
    E2's and E3's card time a launch (profiler, device_breakdown's
    per_launch mean; None where it recorded none) on the encoder's staging
    of ENCODE_CHECKED."""
    from huffmandecoderongpus_tpu_torch.ops import (
        e1_pack,
        e2_compact,
        e3_place,
        encode,
    )

    out = {}
    for k in ENCODE_CHECKED:
        st = encode.stage_encode_inputs(streams[k][1], device=dev)
        args = (st["data3"], st["lo"], st["hi"], st["nval"])
        gran, gval, cnt, bits = e1_pack.e1_pack(*args)
        ORP, NROWS = st["plan"]["ORP"], st["plan"]["NROWS"]
        denseT = e2_compact.e2_compact(gran, gval, ORP=ORP)
        out[k] = {
            "e1_pack": device_breakdown(
                torch, lambda: e1_pack.e1_pack(*args),
                per_launch=True).get("e1_pack"),
            "e2_compact": device_breakdown(
                torch, lambda: e2_compact.e2_compact(gran, gval, ORP=ORP),
                per_launch=True).get("e2_compact"),
            "e3_place": device_breakdown(
                torch, lambda: e3_place.e3_place(denseT, cnt, bits,
                                                 NROWS=NROWS),
                per_launch=True).get("e3_place")}
    return out


def scan_card_ms(torch, streams, dev):
    """{key: ms}: the card time a launch (as encode_card_ms) of
    lane_scan_indexed on the indexed (a) and (c) in lane_dfa's geometry
    (keys IDX["a"], IDX["c"]), of short_candidate_scan's first round on
    (a) and (d) in lane_dfa_sync's (keys SYNC["a"], SYNC["d"]) and of the
    dense decode on (a) and (d) in the dense pipeline's (keys "dense a",
    "dense d")."""
    from huffmandecoderongpus_tpu_torch.huffio import encode_bytes
    from huffmandecoderongpus_tpu_torch.ops import lane_decode_dense as ldd
    from huffmandecoderongpus_tpu_torch.ops import lane_scan, lanedfa_sync
    from huffmandecoderongpus_tpu_torch.ops import lane_scan_indexed as lsi
    from huffmandecoderongpus_tpu_torch.ops import lanedfa_decode as ld
    from huffmandecoderongpus_tpu_torch.ops import short_candidate_scan as scs

    out = {}
    for k, K in (("a", INDEXED["a"]), INDEXED_MD1):
        hf = encode_bytes(streams[k][1], block_symbols=K)
        st = ld.stage_lanedfa_indexed(hf, hf.index[0], device=dev,
                                      tiled=False)
        args = (st["bits"], st["tab"], st["lane_len"])
        out[IDX[k]] = device_breakdown(
            torch, lambda: lsi.lane_scan_indexed(*args),
            per_launch=True).get("lane_scan_indexed")
    for k in SYNC:
        st = ld.stage_lanedfa(encode_bytes(streams[k][1]), device=dev,
                              tiled=False)
        kw = dict(B=st["B"], H=st["H"], N=st["N"])
        bits, tab = st["bits"], st["tab"]
        zero = torch.zeros(bits.shape[1], dtype=torch.int32, device=dev)
        valid0 = lane_scan.lane_scan(bits, tab, zero, **kw)[1]
        W = min(max(lanedfa_sync.W0, st["H"] + 1), bits.shape[0])
        out[SYNC[k]] = device_breakdown(
            torch, lambda: scs.short_candidate_scan(bits, tab, valid0, W=W,
                                                    **kw),
            per_launch=True).get("short_candidate_scan")
        sd, entry, out_rows = dense_staging(torch, encode_bytes(
            streams[k][1]), dev)
        out[f"dense {k}"] = device_breakdown(
            torch, lambda: ldd.lane_decode_dense(
                sd["bits"], sd["tab"], entry, out_rows=out_rows, B=sd["B"],
                H=sd["H"], N=sd["N"]),
            per_launch=True).get("lane_decode_dense")
    return out


def probe_card_ms(torch, streams, dev):
    """{key: ms}: the card time a launch (as encode_card_ms) of the
    compaction on (d) in the dense pipeline's geometry ("compact d"), of
    P4's two stages and k4_compact on (a)'s K3 output ("k4_stripped
    transpose", "k4_stripped prefix", "k4_compact p4"), and the card time
    a call (``probes._timing.device_ms``, every kernel of 20 calls) of P2
    at its reported shape (xor3, P 8, S 4,000, "probe_arith"), of P1's
    library call x + 1 ("x + 1") and P3's torch.gather at its reported
    shape ("torch.gather")."""
    from huffmandecoderongpus_tpu_torch.huffio import encode_bytes
    from huffmandecoderongpus_tpu_torch.ops import (
        compact,
        k4_compact,
        k4_stripped,
        lane_scan,
        probe_arith,
    )
    from huffmandecoderongpus_tpu_torch.probes import (
        hw_k4probe,
        probe_vpu2,
    )
    from huffmandecoderongpus_tpu_torch.probes import probe_gather as pgp
    from huffmandecoderongpus_tpu_torch.probes._timing import device_ms

    out = {}
    sd, entry, out_rows = dense_staging(torch, encode_bytes(
        streams["d"][1]), dev)
    sym, valid = lane_scan.lane_scan(sd["bits"], sd["tab"], entry, B=sd["B"],
                                     H=sd["H"], N=sd["N"])
    cum = torch.cumsum(valid, 0, dtype=torch.int32)
    out["compact d"] = device_breakdown(
        torch, lambda: compact.compact(cum, sym, out_rows=out_rows),
        per_launch=True).get("compact")
    ksym, kval, ORP = hw_k4probe.k3_output(encode_bytes(streams["a"][1]),
                                           dev)
    for stage in k4_stripped.STAGES:
        out[f"k4_stripped {stage}"] = device_breakdown(
            torch, lambda stage=stage: k4_stripped.k4_stripped(
                ksym, kval, ORP=ORP, stage=stage), per_launch=True,
            symbols={"k4_stripped": ("k4_stripped_kernel",)}).get(
                "k4_stripped")
    out["k4_compact p4"] = device_breakdown(
        torch, lambda: k4_compact.k4_compact(ksym, kval, ORP=ORP),
        per_launch=True).get("k4_compact")
    x = probe_vpu2.script_input(dev)
    out["probe_arith"] = device_ms(lambda: probe_arith.probe_arith(
        x, body="xor3", S=probe_vpu2.STEPS, P=8), dev)
    xp = torch.zeros((8, 128), dtype=torch.int32, device=dev)
    out["x + 1"] = device_ms(lambda: xp + 1, dev)
    label, axis, tab_np, idx_np = next(
        c for c in pgp.cases()
        if c[0].startswith(PROBE_KERNELS["probe_gather"][2]))
    tab = torch.from_numpy(tab_np).to(dev)
    k64 = torch.from_numpy(idx_np).to(dev).long()
    out["torch.gather"] = device_ms(lambda: tab.gather(axis, k64), dev)
    out["torch.gather shape"] = label
    return out


def compact_stats(torch, compact, cum, sym, out_rows):
    """The compaction's plan and bytes bound on these inputs, with the
    kernel's own count (``compact.STATS``, one launch) of the blocks whose
    rank union is wider than two chunks, the rows those unions span and
    their share of the blocks' summed cycles."""
    stats = torch.zeros(len(compact.STATS), dtype=torch.int64,
                        device=cum.device)
    out = compact.compact(cum, sym, out_rows=out_rows, stats=stats)
    st = dict(zip(compact.STATS, stats.tolist()))
    plan = compact.compact_plan(*cum.shape, out_rows, cum.data_ptr(),
                                sym.data_ptr(), out.data_ptr())
    return dict(plan=plan, bound_ms=nbytes(cum, sym, out) / HBM_BYTES_PER_S
                * 1e3, wide_blocks=st["wide_blocks"], blocks=plan["blocks"],
                wide_rows=st["wide_rows"],
                wide_cycle_share=st["wide_cycles"] / max(st["cycles"], 1))


def card_ms_fresh():
    """{"encode": encode_card_ms, "scan": scan_card_ms, "k3": k3_card_ms,
    "probe": probe_card_ms, "spec": spec_card_ms} from a fresh process of
    this script (its last line): this long process's profiler records
    nothing in most profiles after its first phases (PERF.md section 7), a
    new one's in each.
    Empty dicts if the child fails."""
    r = subprocess.run([sys.executable, str(pathlib.Path(__file__).resolve()),
                        CARD_ARG], capture_output=True, text=True,
                       timeout=600)
    lines = r.stdout.strip().splitlines()
    if r.returncode or not lines:
        print(f"[card] the card-time process failed (rc {r.returncode}): "
              f"{r.stderr.strip()[-500:]}", flush=True)
        return {"encode": {}, "scan": {}, "k3": {}, "probe": {}, "spec": {}}
    return json.loads(lines[-1])


def check_encoder_cases(torch, dev):
    """Phase 3, E1-E3 at their edge cases (``probes.streams.E_CASES``)
    against their plain versions: E1 on the case's staging, E2 on E1's rows
    and E3 on E2's at the plan's ORP and at E_SMALL_ORP, which drops ranks
    (E3's lanes clamped at ORP); then E3 at its own (``E3_CASES``: three
    and more lanes in a granule, runs of empty lanes, a lane clamped at
    ORP, no bits), whole payloads where no lane is clamped.  Returns
    {case: rows}, as check_kernels."""
    from huffmandecoderongpus_tpu_torch.ops import (
        _build,
        e1_pack,
        e2_compact,
        e3_place,
    )
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
        gran, gval, cnt, bits = comparer(torch, what, rows)(
            "e1_pack", lambda: e1_pack.e1_pack(*args),
            lambda: e1_pack.e1_pack_ref(*args), args)
        for ORP in (p["ORP"], ps.E_SMALL_ORP):
            at = f"{what} ORP={ORP}"
            compare = comparer(torch, at, out.setdefault(at, {}))
            (denseT,) = compare(
                "e2_compact",
                lambda: e2_compact.e2_compact(gran, gval, ORP=ORP),
                lambda: e2_compact.e2_compact_ref(gran, gval, ORP=ORP),
                (gran, gval))
            compare_e3(torch, compare, e3_place, denseT, cnt, bits, p["NROWS"])
    for case in ps.E3_CASES:
        denseT, cnt, bits, NROWS, gran = ps.e3_case(case, dev)
        what = f"E3 {case} G={denseT.shape[0]}"
        (got,) = compare_e3(torch, comparer(torch, what,
                                            out.setdefault(what, {})),
                            e3_place, denseT, cnt, bits, NROWS)
        flat = got.reshape(-1).cpu().numpy()
        if case != "clamped" and (not np.array_equal(flat[:gran.size], gran)
                                  or flat[gran.size:].any()):
            raise AssertionError(f"{what}: E3 did not assemble the stream")
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


def scan_line(name, kname, card_ms, rows_walked, floors, plan, rows):
    """A [scan] line for one run of a redesigned lane-DFA scan: its card
    time ``card_ms`` (profiler, from a fresh process; None if it recorded
    none) in cycles a row over ``rows_walked`` rows at the maximum SM clock,
    its chain floors ({what: rows of dependent lookups}) at
    CHAIN_CYCLES_A_ROW a row, its plan, and its events time.  The card time
    goes into rows[kname] as device_ms."""
    from huffmandecoderongpus_tpu_torch.probes._timing import sm_clock_mhz

    clock = sm_clock_mhz(DEVICE)[1] * 1e6  # nvidia-smi clocks.max.sm, Hz
    r = rows[kname]
    r["device_ms"] = card_ms
    card = ("not measured" if card_ms is None else
            f"{card_ms:.4f} ms (profiler, a fresh process), "
            f"{card_ms * 1e-3 * clock / rows_walked:.1f} cycles a row")
    floor = "; ".join(
        f"{what} {n} x {CHAIN_CYCLES_A_ROW} cycles = "
        f"{n * CHAIN_CYCLES_A_ROW / clock * 1e3:.4f} ms"
        for what, n in floors.items())
    print(f"[scan] {name}: {kname} card {card}; events {r['ms']:.4f} ms; "
          f"{rows_walked} rows at {clock / 1e6:.0f} MHz (clocks.max.sm); "
          f"chain floor {floor}; plan {plan}", flush=True)


def check_lanedfa_indexed(torch, name, raw, hf, dev, card_ms=None):
    """Phase 3 of the indexed lane scan on a stream's index, in lane_dfa's
    geometry (one lane per block): kernel against plain version, sym on
    every row, and a [scan] line (its card time ``card_ms`` from
    scan_card_ms; the chain floor: the longest lane's B rows one bit, and
    B / 2 two bits, a lookup).  Returns and raises as check_kernels."""
    from huffmandecoderongpus_tpu_torch.ops import lane_scan_indexed as lsi
    from huffmandecoderongpus_tpu_torch.ops import lanedfa_decode as ld
    from huffmandecoderongpus_tpu_torch.ops.lanedfa import indexed_plan

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
    scan_line(name, "lane_scan_indexed", card_ms, B,
              {"1 bit a lookup": B, "2 bits a lookup": -(-B // 2)},
              indexed_plan(G, st["bits"].data_ptr() | sym.data_ptr()
                           | valid.data_ptr(), st["tab"].numel()), rows)
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


def check_sync(torch, name, raw, hf, dev, card_ms=None):
    """Phase 3 of the sync discovery on one stream, in lane_dfa_sync's
    geometry: the first round's short candidate scan against its plain
    version on the 0-chain's emissions, all five outputs, with a [scan]
    line (its card time ``card_ms`` from scan_card_ms; the chain floor:
    the round's W rows), and the lane scan cut at that round's W rows (the
    fix scan's shape) from the true entry offsets.  Returns and raises as
    check_kernels."""
    from huffmandecoderongpus_tpu_torch.ops import (
        candidate_scan,
        lane_scan,
        lanedfa_sync,
        short_candidate_scan,
    )
    from huffmandecoderongpus_tpu_torch.ops import lanedfa_decode as ld
    from huffmandecoderongpus_tpu_torch.ops.lanedfa import short_plan

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
    scan_line(name, "short_candidate_scan", card_ms, W, {"W rows": W},
              short_plan(G, st["H"], bits.data_ptr() | valid0.data_ptr()),
              rows)
    entry = ld.compose(*candidate_scan.candidate_scan(bits, tab, **kw))[0]
    compare("lane_scan",
            lambda: lane_scan.lane_scan(bits[:W], tab, entry, rows=W, **kw),
            lambda: lane_scan.lane_scan_ref(bits[:W], tab, entry, rows=W,
                                            **kw), (bits[:W], tab, entry))
    print(f"[kernels] {name}: short_candidate_scan and the lane scan cut at "
          f"W rows bit-exact; first round: {int(merged.sum())} chains merged"
          f", {int(exited.sum())} exited, of {merged.numel()}", flush=True)
    return rows


def check_scan_cases(torch, dev):
    """Phase 3, the redesigned lane-DFA scans at their edge cases:
    lane_scan_indexed at probes.streams.INDEXED_SCAN_CASES and
    short_candidate_scan at SHORT_SCAN_CASES, each against its plain
    version (all outputs).  Returns {case: rows}, as check_kernels."""
    from huffmandecoderongpus_tpu_torch.ops import lane_scan_indexed as lsi
    from huffmandecoderongpus_tpu_torch.ops import short_candidate_scan as scs
    from huffmandecoderongpus_tpu_torch.ops.lanedfa import (
        indexed_plan,
        short_plan,
    )
    from huffmandecoderongpus_tpu_torch.probes import streams as ps

    out = {}
    for case in ps.INDEXED_SCAN_CASES:
        args = ps.indexed_scan_case(case, dev)
        B, G = args[0].shape
        what = f"indexed scan {case} G={G} B={B}"
        print(f"[kernels] {what}: plan "
              f"{indexed_plan(G, args[0].data_ptr(), args[1].numel())}",
              flush=True)
        comparer(torch, what, out.setdefault(what, {}))(
            "lane_scan_indexed", lambda: lsi.lane_scan_indexed(*args),
            lambda: lsi.lane_scan_indexed_ref(*args), args)
    for case in ps.SHORT_SCAN_CASES:
        bits, tab, valid0, kw = ps.short_scan_case(case, dev)
        G = bits.shape[1]
        what = f"short scan {case} G={G} " + " ".join(
            f"{k}={v}" for k, v in kw.items())
        print(f"[kernels] {what}: plan "
              f"{short_plan(G, kw['H'], bits.data_ptr() | valid0.data_ptr())}",
              flush=True)
        comparer(torch, what, out.setdefault(what, {}))(
            "short_candidate_scan",
            lambda: scs.short_candidate_scan(bits, tab, valid0, **kw),
            lambda: scs.short_candidate_scan_ref(bits, tab, valid0, **kw),
            (bits[:kw["W"]], tab, valid0[:kw["W"]]))
    return out


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


def dense_counted(torch, ldd, bits, tab, entry, kw):
    """(kernel, ahead): a call of the dense decode for ``comparer`` whose
    first launch counts, in ``ahead`` (1,) int32, the symbols its lanes
    wrote out themselves (a lane that a tile could carry past the window,
    more than WINDOW - rows ranks ahead of its block's flushed rows); the
    timed launches after it count nothing."""
    ahead = torch.zeros(1, dtype=torch.int32, device=bits.device)
    first = [ahead]

    def kernel():
        return ldd.lane_decode_dense(bits, tab, entry, ahead=(
            first.pop() if first else None), **kw)

    return kernel, ahead


def dense_ahead(name, ahead, plan):
    """Print the bytes the dense decode's lanes wrote out themselves, the
    kernel's count; returns it."""
    from huffmandecoderongpus_tpu_torch.ops import lane_decode_dense as ldd

    total = int(ahead)
    print(f"[dense] {name}: {total} symbols written out by lanes "
          f"themselves (more than {ldd.WINDOW - plan['rows']} ranks ahead "
          "of their block's flushed rows; the kernel's count)", flush=True)
    return total


def check_dense(torch, name, raw, hf, dev, with_compact, card_ms=None,
                compact_card=None):
    """Phase 3 of the dense lane decode on one stream (and, with
    ``with_compact``, of the compaction on the lane scan's emissions)
    against the plain versions, each trimmed by its counts to the input,
    with the bytes its lanes wrote out themselves (the kernel's count,
    dense_ahead) and a
    [scan] line (its card time ``card_ms`` from scan_card_ms; the chain
    floor: B + H rows).  The compaction's row also carries the time of
    torch.searchsorted + gather on the same inputs, and its [compact]
    line its card time ``compact_card`` (from probe_card_ms) against its
    bytes bound, with compact_stats.  Returns and raises as
    check_kernels."""
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
    kernel, ahead = dense_counted(torch, lane_decode_dense, bits, tab, entry,
                                  dict(kw, out_rows=out_rows))
    dense, counts = compare(
        "lane_decode_dense", kernel,
        lambda: lane_decode_dense.lane_decode_dense_ref(
            bits, tab, entry, out_rows=out_rows, **kw), (bits, tab, entry))
    if not np.array_equal(trimmed(torch, dense, counts), raw):
        raise AssertionError(f"{name}: the dense decode decoded wrong")
    print(f"[kernels] {name}: lane_decode_dense bit-exact; stream decoded",
          flush=True)
    plan = lane_decode_dense.dense_plan(bits.shape[1], bits.data_ptr(),
                                        dense.data_ptr())
    rows["lane_decode_dense"]["ahead_stores"] = dense_ahead(name, ahead, plan)
    steps = st["B"] + st["H"]
    scan_line(name, "lane_decode_dense", card_ms, steps, {"B+H rows": steps},
              plan, rows)
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
    st = compact_stats(torch, compact, cum, sym, out_rows)
    if compact_card is not None:
        rows["compact"]["device_ms"] = compact_card
    own = ("not measured" if compact_card is None else
           f"{compact_card:.5f} ms, {compact_card / st['bound_ms']:.2f} "
           "times the bound")
    print(f"[compact] {name}: card {own} (a fresh process); bytes bound "
          f"{st['bound_ms']:.6f} ms; plan {st['plan']}; {st['wide_blocks']} "
          f"of {st['blocks']} blocks with a rank union wider than "
          f"{2 * compact.R} rows ({st['wide_rows']} rows in all), "
          f"{st['wide_cycle_share']:.3f} of the blocks' cycles (the "
          f"kernel's count); torch.searchsorted + gather {lib_ms:.4f} ms "
          "(events)", flush=True)
    return rows


def check_compact_cases(torch, dev):
    """Phase 3, the compaction at its edge cases
    (``probes.streams.COMPACT_CASES``) against its plain version, with
    the kernel's count of wide-union blocks (some in "wide" only).
    Returns {case: rows}, as check_kernels."""
    from huffmandecoderongpus_tpu_torch.ops import compact
    from huffmandecoderongpus_tpu_torch.probes import streams as ps

    out = {}
    for case in ps.COMPACT_CASES:
        cum, sym, out_rows = ps.compact_case(case, dev)
        what = f"compact {case} {tuple(cum.shape)} out_rows={out_rows}"
        comparer(torch, what, out.setdefault(what, {}))(
            "compact", lambda: compact.compact(cum, sym, out_rows=out_rows),
            lambda: compact.compact_ref(cum, sym, out_rows=out_rows),
            (cum, sym))
        st = compact_stats(torch, compact, cum, sym, out_rows)
        print(f"[compact] {what}: plan {st['plan']}; {st['wide_blocks']} "
              "wide-union blocks", flush=True)
        if (st["wide_blocks"] > 0) != (case == "wide"):
            raise AssertionError(f"{what}: {st['wide_blocks']} wide-union "
                                 "blocks")
    return out


def check_dense_cases(torch, dev):
    """Phase 3, the dense decode at its edge cases
    (``probes.streams.DENSE_CASES``) against its plain version, with its
    lanes' own write-outs (dense_ahead: in "ahead" only).
    Returns {case: rows}, as check_kernels."""
    from huffmandecoderongpus_tpu_torch.ops import lane_decode_dense as ldd
    from huffmandecoderongpus_tpu_torch.probes import streams as ps

    out = {}
    for case in ps.DENSE_CASES:
        bits, tab, start, kw = ps.dense_case(case, dev)
        what = f"dense {case} G={bits.shape[1]}"
        kernel, ahead = dense_counted(torch, ldd, bits, tab, start, kw)
        dense, _counts = comparer(torch, what, out.setdefault(what, {}))(
            "lane_decode_dense", kernel,
            lambda: ldd.lane_decode_dense_ref(bits, tab, start, **kw),
            (bits, tab, start))
        total = dense_ahead(what, ahead, ldd.dense_plan(
            bits.shape[1], bits.data_ptr(), dense.data_ptr()))
        if (total > 0) != (case == "ahead"):
            raise AssertionError(f"{what}: {total} bytes written out by "
                                 "lanes")
    return out


def spec_query_moved(size, levels, height) -> int:
    """Bytes S3 must move: the result and the symbol at each output's
    position (a byte each), and each kept entry the walks read, once a
    distinct (level, position): at level k the outputs (2m + 1) 2^k start
    new positions, odd levels reading two entries of the level below."""
    from huffmandecoderongpus_tpu_torch.ops.spec_double import level_dtype

    moved = 2 * size
    for k in range(levels):
        starts = ((size - (1 << k) - 1) >> (k + 1)) + 1 if size > 1 << k else 0
        elem = level_dtype(k - k % 2, height).itemsize
        moved += starts * elem * (1 + k % 2)
    return moved


def spec_double_moved(bits, levels, height) -> int:
    """Bytes the one-level ``spec_double`` moves over one decode's levels,
    a launch a level: each level read once and written once, each in its
    own type (the per-level bound, beside the function's own)."""
    from huffmandecoderongpus_tpu_torch.ops.spec_double import level_dtype

    return sum(bits * (level_dtype(k - 1, height).itemsize
                       + level_dtype(k, height).itemsize)
               for k in range(1, max(levels, 1)))


def spec_s2_moved(bits, levels, height) -> int:
    """Bytes S2 must move, its function's own: step0 read once and each
    kept level (2, 4, ... below ``levels``) written once."""
    from huffmandecoderongpus_tpu_torch.ops.spec_double import level_dtype

    top = (levels - 1) // 2 * 2 if levels >= 3 else 0
    return bits * (2 * bool(top) + sum(level_dtype(k, height).itemsize
                                       for k in range(2, top + 1, 2)))


def spec_stages(torch, hf, dev, compare=None, tile=None):
    """S1, S2 and S3 on one stream's staged CUDA inputs, each launch
    against its plain version on the same inputs (tolerance 0; raises on
    any difference): S2's tile launch (plan ``s2_plan``, on ``tile`` where
    given) against ``spec_tile_ref``, each pair launch (in the plan's
    block order) against ``spec_pair_ref``, and the one-level
    ``spec_double`` (the yardstick, on no decode path) at every level
    against ``spec_double_ref``, its even levels against the kept ones.  With ``compare``
    (``comparer``'s) S1 and S3 are timed and recorded by it, and each S2
    launch is timed (CUDA events, median of 20; plain, median of 2).
    Returns (plan, result, found, S2: {"plan", "tile": (err, ms, plain ms,
    bound ms) or None, "pairs": [(k, dtype, err, ms, plain ms, bound ms)],
    "levels": the same for each one-level launch})."""
    from huffmandecoderongpus_tpu_torch.ops import _build
    from huffmandecoderongpus_tpu_torch.ops import spec_all_bits as s1
    from huffmandecoderongpus_tpu_torch.ops import spec_double as s2
    from huffmandecoderongpus_tpu_torch.ops import spec_pair, spec_tile
    from huffmandecoderongpus_tpu_torch.ops import spec_query as s3
    from huffmandecoderongpus_tpu_torch.ops import speculative as spec

    def check(what, kernel, plain, inputs, moved=None):
        if compare is not None:
            return compare(what, kernel, plain, inputs, moved)
        got, want = kernel(), plain()
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        if max_abs_err(torch, got, want):
            raise AssertionError(f"{what} differs from its plain version")
        return got

    def launch(what, kernel, plain, moved):
        """(outputs, (err, kernel ms, plain ms, bound ms))"""
        got = kernel()
        torch.cuda.synchronize()
        got_t = tuple(got) if isinstance(got, list) else (got,)
        want = plain()
        want = tuple(want) if isinstance(want, list) else (want,)
        err = max_abs_err(torch, got_t, want)
        if err:
            raise AssertionError(f"{what} differs from its plain version")
        times = ((statistics.median(event_ms(kernel, 20)),
                  statistics.median(event_ms(plain, 2)))
                 if compare is not None else (None, None))
        return got, (err, *times, moved / HBM_BYTES_PER_S * 1e3)

    plan, (w, s, ln) = spec.decode_device_arrays(hf, device=dev)
    kw = dict(bits=plan.bits, height=plan.height)
    step0, sym = check("spec_all_bits",
                       lambda: s1.spec_all_bits(w, s, ln, **kw),
                       lambda: s1.spec_all_bits_ref(w, s, ln, **kw),
                       (w, s, ln))
    p = spec_tile.s2_plan(plan.bits, plan.height, plan.levels,
                          sms=_build.sm_count(dev), tile=tile,
                          size=plan.size)
    out = dict(plan=p, tile=None, pairs=[], levels=[])
    kept = [step0]
    if p["m"]:
        got, out["tile"] = launch(
            "spec_tile",
            lambda: spec_tile.spec_tile(step0, m=p["m"], tile=p["tile"],
                                        **kw),
            lambda: spec_tile.spec_tile_ref(step0, bits=plan.bits,
                                            m=p["m"]),
            plan.bits * (2 + p["m"]))
        kept += got
    for k, seg in zip(p["pairs"], p["segs"]):
        dt = s2.level_dtype(k, plan.height)
        lv = kept[-1]
        got, row = launch(
            f"spec_pair level {k}",
            lambda lv=lv, dt=dt, seg=seg: spec_pair.spec_pair(
                lv, bits=plan.bits, dtype=dt, seg=seg),
            lambda lv=lv, dt=dt: spec_pair.spec_pair_ref(lv, bits=plan.bits,
                                                         dtype=dt),
            nbytes(lv) + plan.bits * dt.itemsize)
        out["pairs"].append((k, str(dt).split(".")[1], *row))
        kept.append(got)
    lv = step0
    for k in range(1, max(plan.levels, 1)):
        dt = s2.level_dtype(k, plan.height)
        got, row = launch(
            f"spec_double level {k}",
            lambda lv=lv, dt=dt: s2.spec_double(lv, bits=plan.bits,
                                                dtype=dt),
            lambda lv=lv, dt=dt: s2.spec_double_ref(lv, bits=plan.bits,
                                                    dtype=dt),
            nbytes(lv) + plan.bits * dt.itemsize)
        out["levels"].append((k, str(dt).split(".")[1], *row))
        if k % 2 == 0 and not torch.equal(got, kept[k // 2]):
            raise AssertionError(f"spec_double level {k} differs from the "
                                 "kept level the tile and pairs made")
        lv = got
    q = dict(bits=plan.bits, size=plan.size, levels=plan.levels)
    result, found = check(
        "spec_query", lambda: s3.spec_query(kept, sym, **q),
        lambda: s3.spec_query_ref(kept, sym, **q), (),
        spec_query_moved(plan.size, plan.levels, plan.height))
    return plan, result, int(found), out


def _s2_rows(s2):
    """The result line's rows of S2's kernels from ``spec_stages``' S2: the
    tile launch, the pair launches summed (one decode's), and the one-level
    ``spec_double`` summed over one decode's levels (the yardstick)."""
    rows = {}
    if s2["tile"] is not None:
        err, ms, plain, bound = s2["tile"]
        rows["spec_tile"] = dict(err=err, ms=ms, plain_ms=plain,
                                 bound_ms=bound, bound_by="bytes")
    for key, runs in (("spec_pair", s2["pairs"]),
                      ("spec_double", s2["levels"])):
        if runs:
            rows[key] = dict(err=max(r[2] for r in runs),
                             ms=sum(r[3] for r in runs),
                             plain_ms=sum(r[4] for r in runs),
                             bound_ms=sum(r[5] for r in runs),
                             bound_by="bytes")
    return rows


def check_spec(torch, name, raw, hf, dev, card=None):
    """Phase 3 on one stream of the speculative pipeline: S1, S2's tile
    and pair launches and the one-level yardstick at every level (its
    int16 and int32 levels alike), and S3 against their plain versions on
    the same CUDA inputs, bit-exact, with their times and bytes bounds;
    the result must be the input and found_size its size.  Returns rows
    for the result line, S2's pairs and levels summed over one decode,
    each with its card time from ``card`` (``spec_card_ms``'s row for the
    stream) where it has one."""
    rows = {}
    plan, result, found, s2 = spec_stages(torch, hf, dev,
                                          comparer(torch, name, rows))
    rows.update(_s2_rows(s2))
    p, levels = s2["plan"], s2["levels"]
    if "spec_tile" in rows:
        t, pr = rows["spec_tile"], rows.get("spec_pair")
        new = t["ms"] + (pr["ms"] if pr else 0.0)
        print(f"[kernels] {name}: S2 bit-exact, tile launch m={p['m']} "
              f"tile {p['tile']} halo {p['halo']} ({p['blocks']} blocks, "
              f"{p['shared']} bytes shared) {t['ms']:.4f} ms (plain "
              f"{t['plain_ms']:.4f}, bound {t['bound_ms']:.6f}); "
              f"{len(s2['pairs'])} pair launches (levels "
              f"{[r[0] for r in s2['pairs']]}) "
              + ("" if pr is None else
                 f"{pr['ms']:.4f} ms summed (plain {pr['plain_ms']:.4f}, "
                 f"bound {pr['bound_ms']:.6f}); ")
              + f"S2 {new:.4f} ms in {p['launches']} launches against the "
              f"one-level spec_double's {rows['spec_double']['ms']:.4f} ms "
              f"in {len(levels)}", flush=True)
    if levels:
        kinds = [lv[1] for lv in levels]
        print(f"[kernels] {name}: spec_double (one level, the yardstick) "
              f"max_abs_err 0 (tolerance 0) over {len(levels)} levels "
              f"({kinds.count('int16')} written int16, "
              f"{kinds.count('int32')} int32; first int32 level "
              f"{next((lv[0] for lv in levels if lv[1] == 'int32'), '-')}), "
              f"median a level {statistics.median(lv[3] for lv in levels):.4f}"
              " ms", flush=True)
    for n, ms in (card or {}).items():
        ms = sum(ms) if isinstance(ms, list) and None not in ms else ms
        if n in rows and isinstance(ms, float):
            rows[n]["device_ms"] = ms
    ok = found == raw.size and np.array_equal(result.cpu().numpy(), raw)
    print(f"[kernels] {name}: speculative stages bit-exact, {plan.levels} "
          f"levels, height {plan.height}; found_size {found}, result equal "
          f"to the input: {ok}", flush=True)
    if not ok:
        raise AssertionError(f"{name}: the speculative stages decoded wrong")
    return rows


#: the speculative pipeline's edge cases: the tiny inputs (sizes 1, 2, 3
#: and 7: 0-3 levels), text whose top level (12) is the first int32 level
#: (2^11 x height <= 32767 < 2^12 x height at heights 9-15), a 12-symbol
#: stream whose top level (12) is the last int16 level at height 4, and
#: text cut 3 bits short (found_size -1); then probes.streams.SPEC_CASES
#: on their own tiles (bits off and on a tile, a halo past the end, trees
#: 14-22 tall, S3's block edges, two more cut streams)
SPEC_TINY = (b"a", b"ab", b"aab", b"x" * 7)
SPEC_EDGE_BYTES = 6000


def spec_edge_streams(rng):
    """{what: (raw or None, HuffFile, tile or None)}"""
    from huffmandecoderongpus_tpu_torch.huffio import HuffFile, encode_bytes
    from huffmandecoderongpus_tpu_torch.probes import streams as ps

    out = {f"tiny {t!r}": (np.frombuffer(t, dtype=np.uint8),
                           encode_bytes(t), None) for t in SPEC_TINY}
    raw = text_like(rng, SPEC_EDGE_BYTES)
    out["text, top level the first int32"] = (raw, encode_bytes(raw), None)
    raw = uniform12(rng, SPEC_EDGE_BYTES)
    out["12 symbols, top level the last int16"] = (raw, encode_bytes(raw),
                                                   None)
    hf = encode_bytes(text_like(rng, SPEC_EDGE_BYTES))
    out["text cut 3 bits short"] = (None, HuffFile(
        tree=hf.tree, bits=hf.bits - 3,
        uncompressed_size=hf.uncompressed_size,
        payload=hf.payload[:(hf.bits + 4) // 8]), None)
    for case in ps.SPEC_CASES:
        out[case] = ps.spec_case(case)
    return out


def check_spec_cases(torch, dev):
    """Phase 3, the speculative stages at their edges (spec_edge_streams,
    drawn from seed SEED + 19) against their plain versions: every launch
    bit-exact (S2 on the case's tile), each decode equal to its input, the
    cut stream's found_size -1 from the kernels and the plain versions
    alike; and S4 against its plain walk on each (the trees 17 and 22 tall
    read its table from device memory).  Returns {kernel: {"err": 0}}."""
    from huffmandecoderongpus_tpu_torch.ops import onethread, spec_double
    from huffmandecoderongpus_tpu_torch.ops import speculative as spec

    for what, (raw, hf, tile) in spec_edge_streams(
            np.random.default_rng(SEED + 19)).items():
        plan, result, found, s2 = spec_stages(torch, hf, dev, tile=tile)
        p = s2["plan"]
        kinds = [spec_double.level_dtype(2 * j, plan.height)
                 for j in range(plan.levels // 2 + 1)]
        ok = (found == -1 if raw is None else
              found == raw.size and np.array_equal(result.cpu().numpy(),
                                                   raw))
        _p, (w, s, ln) = spec.decode_device_arrays(hf, device=dev)
        kw = dict(bits=plan.bits, size=plan.size, height=plan.height)
        out, n = onethread.onethread(w, s, ln, **kw)
        rout, rn = onethread.onethread_ref(w, s, ln, **kw)
        walk = torch.equal(out, rout) and int(n) == int(rn)
        print(f"[kernels] speculative edge, {what}: size {plan.size}, "
              f"{plan.bits} bits, {plan.levels} levels, height "
              f"{plan.height}, top kept level "
              f"{str(kinds[-1]).split('.')[1]}; S2 m={p['m']} tile "
              f"{p['tile']} halo {p['halo']} in {p['blocks']} blocks "
              f"(bits {'a' if p['tile'] and plan.bits % p['tile'] == 0 else 'no'}"
              f" multiple of the tile), pairs {list(p['pairs'])}, "
              f"{len(s2['levels'])} one-level launches; found_size {found}; "
              f"bit-exact, as expected: {ok}; onethread bit-exact against "
              f"its plain walk ({'shared' if plan.height <= 16 else 'device'}"
              f"-memory table): {walk}", flush=True)
        if not ok or not walk:
            raise AssertionError(f"speculative edge {what}: found {found}, "
                                 f"walk {walk}")
    check_spec_no_code(torch, dev)
    return {n: {"err": 0} for n in (*SPEC_PATH, "spec_double", "onethread")}


def check_spec_no_code(torch, dev):
    """Phase 3, S1 on tables less some codes (probes.streams.NO_CODE_CASES:
    windows that match no code, length and symbol 0, in a table whole in
    shared memory and in two-level ones) against its plain version, on the
    whole stream and 5 bits short."""
    from huffmandecoderongpus_tpu_torch.ops import spec_all_bits as s1
    from huffmandecoderongpus_tpu_torch.ops import speculative as spec
    from huffmandecoderongpus_tpu_torch.probes import streams as ps

    for case, lengths in ps.NO_CODE_CASES:
        _raw, hf, _tile = ps.spec_case(case)
        height, sym, ln = ps.table_without_codes(hf.tree, lengths)
        plan, (w, _s, _ln) = spec.decode_device_arrays(hf, device=dev)
        s, ln = torch.from_numpy(sym).to(dev), torch.from_numpy(ln).to(dev)
        for bits in (plan.bits, plan.bits - 5):
            kw = dict(bits=bits, height=height)
            got = s1.spec_all_bits(w, s, ln, **kw)
            want = s1.spec_all_bits_ref(w, s, ln, **kw)
            ok = all(torch.equal(g, x) for g, x in zip(got, want))
            print(f"[kernels] speculative edge, {case} less the codes of "
                  f"lengths {lengths}: S1 at height {height} "
                  f"({'two-level' if height > s1.SHARED_HEIGHT else 'whole'}"
                  f" table), {bits} bits, "
                  f"{int((got[0] == 0).sum())} offsets of no code, "
                  f"bit-exact: {ok}", flush=True)
            if not ok:
                raise AssertionError(f"spec_all_bits on {case} less codes "
                                     f"{lengths} differs from its plain "
                                     f"version")


def check_onethread(torch, name, raw, hf, dev, card=None):
    """Phase 3, S4 against its plain walk on one stream's staged CUDA
    inputs: out and n bit-exact, n the size and out the input; its time
    beside the chain floor (a dependent lookup a symbol at
    CHAIN_CYCLES_A_ROW cycles, the maximum SM clock), and its card time
    ``card`` (``spec_card_ms``) where there is one."""
    from huffmandecoderongpus_tpu_torch.ops import onethread
    from huffmandecoderongpus_tpu_torch.ops import speculative as spec
    from huffmandecoderongpus_tpu_torch.probes._timing import sm_clock_mhz

    plan, (w, s, ln) = spec.decode_device_arrays(hf, device=dev)
    kw = dict(bits=plan.bits, size=plan.size, height=plan.height)
    rows = {}
    out, n = comparer(torch, name, rows)(
        "onethread", lambda: onethread.onethread(w, s, ln, **kw),
        lambda: onethread.onethread_ref(w, s, ln, **kw), (w, s, ln))
    clock = sm_clock_mhz(DEVICE)[1] * 1e6
    row = rows["onethread"]
    row.update(bound_ms=plan.size * CHAIN_CYCLES_A_ROW / clock * 1e3,
               bound_by="operations",
               **({} if card is None else {"device_ms": card}))
    ok = int(n) == raw.size and np.array_equal(out.cpu().numpy(), raw)
    print(f"[kernels] {name}: onethread decoded the input: {ok}; chain "
          f"floor {row['bound_ms']:.4f} ms ({plan.size} symbols x "
          f"{CHAIN_CYCLES_A_ROW} cycles at {clock / 1e6:.0f} MHz), kernel "
          f"{row['ms'] / row['bound_ms']:.2f} times it", flush=True)
    if not ok:
        raise AssertionError(f"{name}: onethread decoded wrong")
    return rows


def spec_card_ms(torch, streams, dev):
    """{stream: {"spec_all_bits": ms, "spec_tile": ms, "spec_pair": [ms a
    pair launch], "spec_double": [ms a level], "spec_query": ms}} on
    SPEC_TIMED, and {"onethread k": ms} on ONETHREAD_TIMED: the card time
    a launch (as encode_card_ms) of each launch on the stream's staging,
    S2's as ``double_levels`` makes them (the one-level spec_double's
    beside, a launch a level)."""
    from huffmandecoderongpus_tpu_torch.huffio import encode_bytes
    from huffmandecoderongpus_tpu_torch.ops import _build, onethread
    from huffmandecoderongpus_tpu_torch.ops import spec_all_bits as s1
    from huffmandecoderongpus_tpu_torch.ops import spec_double as s2
    from huffmandecoderongpus_tpu_torch.ops import spec_pair, spec_tile
    from huffmandecoderongpus_tpu_torch.ops import spec_query as s3
    from huffmandecoderongpus_tpu_torch.ops import speculative as spec

    def card(fn, key, runs=5):
        return device_breakdown(torch, fn, runs=runs,
                                per_launch=True).get(key)

    out = {}
    for k in SPEC_TIMED:
        plan, (w, s, ln) = spec.decode_device_arrays(
            encode_bytes(streams[k][1]), device=dev)
        kw = dict(bits=plan.bits, height=plan.height)
        row = {"spec_all_bits": card(
            lambda: s1.spec_all_bits(w, s, ln, **kw), "spec_all_bits")}
        step0, sym = s1.spec_all_bits(w, s, ln, **kw)
        p = spec_tile.s2_plan(plan.bits, plan.height, plan.levels,
                              sms=_build.sm_count(dev), size=plan.size)
        kept = [step0]
        if p["m"]:
            row["spec_tile"] = card(lambda: spec_tile.spec_tile(
                step0, m=p["m"], tile=p["tile"], **kw), "spec_tile")
            kept += spec_tile.spec_tile(step0, m=p["m"], tile=p["tile"],
                                        **kw)
        row["spec_pair"] = []
        for j, seg in zip(p["pairs"], p["segs"]):
            dt = s2.level_dtype(j, plan.height)
            row["spec_pair"].append(card(
                lambda lv=kept[-1], dt=dt, seg=seg: spec_pair.spec_pair(
                    lv, bits=plan.bits, dtype=dt, seg=seg), "spec_pair"))
            kept.append(spec_pair.spec_pair(kept[-1], bits=plan.bits,
                                            dtype=dt, seg=seg))
        lv, row["spec_double"] = step0, []
        for j in range(1, max(plan.levels, 1)):
            dt = s2.level_dtype(j, plan.height)
            row["spec_double"].append(card(
                lambda lv=lv, dt=dt: s2.spec_double(lv, bits=plan.bits,
                                                    dtype=dt),
                "spec_double"))
            lv = s2.spec_double(lv, bits=plan.bits, dtype=dt)
        del lv
        row["spec_query"] = card(lambda: s3.spec_query(
            kept, sym, bits=plan.bits, size=plan.size, levels=plan.levels),
            "spec_query")
        out[k] = row
        del kept, step0, sym
    for k in ONETHREAD_TIMED:
        plan, (w, s, ln) = spec.decode_device_arrays(
            encode_bytes(streams[k][1]), device=dev)
        out[f"onethread {k}"] = card(lambda: onethread.onethread(
            w, s, ln, bits=plan.bits, size=plan.size, height=plan.height),
            "onethread", runs=2)
    return out


def drive_spec(torch, mods, hfs, dev, card, card_ms):
    """Phase 4 of the speculative pipeline and the one-thread decode:
    get_decoder("spec_xla", device="cuda") on SPEC_DECODED, each decode
    counted on its own (S1 once, S2's tile launch once and a pair launch
    a kept level above its m, as ``s2_plan`` says, S3 once, nothing else:
    the wrappers count launches only, so a plain version would show as a
    missing count) and equal to its input; get_decoder("onethread_device")
    on ONETHREAD_DECODED (S4 once); then a [spec] line for SPEC_TIMED
    (each launch's card time from the fresh --card-ms process beside its
    bytes bound: S2's launches a decode and their card time summed
    against the function's bound, step0 read and each kept level written
    once, the one-level spec_double's sum over the levels beside against
    its per-level bound; the pipeline's program time by CUDA events and
    the spec_xla wall, beside lane_wide's program and wall on the same
    stream) and an [onethread] line for
    ONETHREAD_TIMED (card time against the chain floor, in cycles a
    symbol).  Returns the launches."""
    from huffmandecoderongpus_tpu_torch.models import get_decoder
    from huffmandecoderongpus_tpu_torch.ops import _build, spec_tile
    from huffmandecoderongpus_tpu_torch.ops import spec_all_bits as s1
    from huffmandecoderongpus_tpu_torch.ops import spec_query as s3
    from huffmandecoderongpus_tpu_torch.ops import speculative as spec
    from huffmandecoderongpus_tpu_torch.ops import widescan as ws
    from huffmandecoderongpus_tpu_torch.ops.onethread import onethread
    from huffmandecoderongpus_tpu_torch.probes._timing import sm_clock_mhz

    launches = {}

    def add(ran):
        for n, c in ran.items():
            launches[n] = launches.get(n, 0) + c

    def drive(decoder, k, path):
        name, r, h = hfs[k]
        t0 = time.perf_counter()
        out, ran = counted(torch, mods, lambda: get_decoder(
            decoder, device=DEVICE)(h))
        expect(f"{decoder} {name}, {h.bits} bits, first decode "
               f"{time.perf_counter() - t0:.3f} s wall",
               np.array_equal(out, r), ran,
               {n: c for n, c in path.items() if c})
        add(ran)

    def s2_path(h):
        plan = spec.make_plan(h.bits, h.uncompressed_size,
                              spec.build_decode_lut(h.tree).height)
        p = spec_tile.s2_plan(plan.bits, plan.height, plan.levels,
                              sms=_build.sm_count(dev), size=plan.size)
        return plan, p, {"spec_all_bits": 1, "spec_tile": int(p["m"] > 0),
                         "spec_pair": len(p["pairs"]), "spec_query": 1}

    for k in SPEC_DECODED:
        drive("spec_xla", k, s2_path(hfs[k][2])[2])
    for k in ONETHREAD_DECODED:
        drive("onethread_device", k, {"onethread": 1})

    for k in SPEC_TIMED:
        name, r, h = hfs[k]
        plan, p, _path = s2_path(h)
        _plan, (w, s, ln) = spec.decode_device_arrays(h, device=dev)
        kw = dict(bits=plan.bits, size=plan.size, height=plan.height,
                  levels=plan.levels)
        ts = event_ms(lambda: spec.speculative_decode(w, s, ln, **kw),
                      WARMUP + TIMED_RUNS)[WARMUP:]
        wall, _mn = wall_ms(torch, lambda: get_decoder(
            "spec_xla", device=DEVICE)(h))
        st = ws.stage_widescan_inputs(h, device=dev)
        args = ws.program_args(st)
        lw = statistics.median(event_ms(
            lambda: ws.wide_decode_program(st["words"], st["tab"],
                                           st["lim"], **args),
            WARMUP + TIMED_RUNS)[WARMUP:])
        lw_wall, _mn = wall_ms(torch, lambda: ws.decode_widescan(
            h, device=dev))
        c = card_ms.get(k, {})
        s1b = nbytes(w, s, ln) + plan.bits * 3
        s2b = spec_s2_moved(plan.bits, plan.levels, plan.height)
        s1lb = spec_double_moved(plan.bits, plan.levels, plan.height)
        s3b = spec_query_moved(plan.size, plan.levels, plan.height)
        parts = ([c.get("spec_tile")] if p["m"] else []) + list(
            c.get("spec_pair") or [])
        s2 = (None if len(parts) != p["launches"] or None in parts
              else sum(parts))
        lvl = c.get("spec_double") or []
        s2l = None if not lvl or None in lvl else sum(lvl)

        def ms(v, bound_bytes):
            bound = bound_bytes / HBM_BYTES_PER_S * 1e3
            return ("not measured" if v is None else
                    f"{v:.4f} ms ({v / bound:.1f} x its bound "
                    f"{bound:.4f})")

        table = ("two-level table" if plan.height > s1.SHARED_HEIGHT
                 else "table whole in shared memory")
        print(f"[spec] {name}: card (profiler, a fresh process) S1 "
              f"{ms(c.get('spec_all_bits'), s1b)} ({table}, "
              f"{s1.RUN} offsets a thread); S2 {p['launches']} "
              f"launches a decode (tile m={p['m']}: "
              + ("not measured" if c.get("spec_tile") is None else
                 f"{c['spec_tile']:.4f} ms")
              + f"; pairs {list(p['pairs'])}: "
              + ", ".join("not measured" if v is None else f"{v:.4f}"
                          for v in c.get("spec_pair") or [])
              + f") {ms(s2, s2b)}; the one-level spec_double "
              f"{max(plan.levels - 1, 0)} launches {ms(s2l, s1lb)}, S2 "
              + ("not measured" if None in (s2, s2l) else
                 f"{s2 / s2l:.3f} of it")
              + f"; S3 {ms(c.get('spec_query'), s3b)} "
              f"({-(-plan.size >> s3.BLOCK_LEVELS)} blocks of "
              f"{1 << s3.BLOCK_LEVELS} outputs); program (events) "
              f"median {statistics.median(ts):.4f} ms (min {min(ts):.4f}); "
              f"spec_xla wall median {wall:.4f} ms; lane_wide program "
              f"{lw:.4f} ms, wall {lw_wall:.4f} ms; {plan.bits} bits, "
              f"height {plan.height}, {plan.levels} levels; card {card}",
              flush=True)
    clock = sm_clock_mhz(DEVICE)[1] * 1e6
    for k in ONETHREAD_TIMED:
        name, r, h = hfs[k]
        plan, (w, s, ln) = spec.decode_device_arrays(h, device=dev)
        ev = event_ms(lambda: onethread(w, s, ln, bits=plan.bits,
                                        size=plan.size, height=plan.height),
                      1)[0]
        floor = plan.size * CHAIN_CYCLES_A_ROW / clock * 1e3
        c = card_ms.get(f"onethread {k}")
        own = ("not measured" if c is None else
               f"{c:.3f} ms, {c / floor:.2f} times the floor, "
               f"{c / 1e3 * clock / plan.size:.1f} cycles a symbol")
        print(f"[onethread] {name}: card {own} (profiler, a fresh "
              f"process); events {ev:.3f} ms; chain floor {floor:.3f} ms "
              f"({plan.size} symbols x {CHAIN_CYCLES_A_ROW} cycles at "
              f"{clock / 1e6:.0f} MHz); card {card}", flush=True)
    return launches


def check_batch(torch, name, raws, hfs, dev, k3_card=None):
    """Phase 3 on a batch: the batched K1 and K3 (per-stream tables)
    against their plain versions on the batch staging, K2 and K4 between
    them, and every member's bytes; a [k3] line with K3's card time
    ``k3_card`` (from ``card_ms_fresh``).  Returns and raises as
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
    k3_line(name, "k3_fix2_c01", k3_card, cut, p["steps_p"], rows)
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


def launch_counts() -> dict:
    """{kernel: launches so far}, from the port's ``launch.<kernel>``
    counters."""
    from huffmandecoderongpus_tpu_torch.utils import trace

    return {name[len("launch."):]: n for name, n in trace.counts().items()
            if name.startswith("launch.")}


def launched_since(before: dict, mods) -> dict:
    """{kernel: launches} of the kernels ``mods`` since ``before`` (a
    ``launch_counts()``), those that launched."""
    now = launch_counts()
    return {n: now.get(n, 0) - before.get(n, 0) for n in mods
            if now.get(n, 0) != before.get(n, 0)}


def encode_retries() -> int:
    """Encodes finished off their first plan so far (``encode.retry``)."""
    from huffmandecoderongpus_tpu_torch.utils import trace

    return trace.counts().get("encode.retry", 0)


def counted(torch, mods, fn):
    """fn()'s result and the launches of the kernels ``mods`` it made."""
    before = launch_counts()
    out = fn()
    torch.cuda.synchronize()
    return out, launched_since(before, mods)


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


#: the sharded phase: the streams each sharded decoder decodes, the virtual
#: shards of the card it runs on, and the kernels a shard launches a decode
#: (K2 twice: the shard's composite map, then its entries; the block
#: decode is torch ops, no kernel of its own)
SHARDED_STREAMS = "ab"
SHARDS = (1, 2, 4)
SHARDED_PATHS = {
    "spec_sharded": {},
    "lane_sharded": {"candidate_scan": 1, "lane_scan": 1},
    "lane_sharded_wide": {"k1_scan2": 1, "k2_compose": 2, "k3_fix2": 1,
                          "k4_compact": 1},
}
#: the index-sharded decode's shards, and its kernels a shard
INDEXED_SHARDS = (2, 4)
#: walls and CUDA-event program runs a sharded decode is timed over
SHARDED_WALLS, SHARDED_RUNS = 3, 5
#: the multi-process jobs: the worker mode's flag, the stream (news-sized
#: text from its own seed), the shards a process and the workers' limit
MH_ARG = "--multihost-worker"
MH_SEED, MH_SHARDS, MH_TIMEOUT = 23, 2, 300


def mh_stream():
    """The multi-process jobs' stream, drawn the same in every process."""
    return text_like(np.random.default_rng(MH_SEED), NEWS_BYTES)


def mh_worker(args) -> int:
    """``chip_smoke.py --multihost-worker INIT NUM PID SHARDS``: join the
    job, decode mh_stream() with decode_sharded_multihost over SHARDS
    virtual shards of cuda:0 a process, print one JSON line (pid, backend,
    sha256 of the bytes, equal to the input)."""
    import hashlib

    import torch.distributed as dist

    from huffmandecoderongpus_tpu_torch.huffio import encode_bytes
    from huffmandecoderongpus_tpu_torch.parallel.mesh import distributed_init
    from huffmandecoderongpus_tpu_torch.parallel.multihost import (
        decode_sharded_multihost,
        global_mesh,
    )

    init, num, pid, shards = args
    distributed_init(init, int(num), int(pid))
    mesh = global_mesh(devices=["cuda:0"] * int(shards))
    raw = mh_stream()
    out = decode_sharded_multihost(encode_bytes(raw), mesh=mesh)
    print(json.dumps({"pid": int(pid), "backend": dist.get_backend(),
                      "shards": mesh.size,
                      "sha256": hashlib.sha256(out.tobytes()).hexdigest(),
                      "equal": bool(np.array_equal(out, raw))}), flush=True)
    dist.destroy_process_group()
    return 0


def start_mh_jobs():
    """Start the two-process job (gloo: the processes share the card, two
    shards each) and the one-process group (NCCL: its process has the
    card); returns (the backend each should pick, the process)."""
    import socket

    jobs = []
    for backend, num in (("gloo", 2), ("nccl", 1)):
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        for pid in range(num):
            jobs.append((backend, subprocess.Popen(
                [sys.executable, str(pathlib.Path(__file__).resolve()),
                 MH_ARG, f"tcp://127.0.0.1:{port}", str(num), str(pid),
                 str(MH_SHARDS)],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    return jobs


def finish_mh_jobs(jobs):
    """Wait for the jobs (each process at most MH_TIMEOUT s); raise unless
    every process exited 0 with the input's SHA-256."""
    import hashlib

    want = hashlib.sha256(mh_stream().tobytes()).hexdigest()
    try:
        for backend, p in jobs:
            out, err = p.communicate(timeout=MH_TIMEOUT)
            lines = out.strip().splitlines()
            if p.returncode or not lines:
                raise AssertionError(f"{backend} worker failed (rc "
                                     f"{p.returncode}): {err[-2000:]}")
            res = json.loads(lines[-1])
            print(f"[sharded] decode_sharded_multihost, {backend} process "
                  f"{res['pid']} of a {res['shards']}-shard mesh on "
                  f"{NEWS_BYTES} bytes: sha256 {res['sha256']}, equal to the "
                  f"input: {res['equal']}", flush=True)
            if res["backend"] != backend:
                raise AssertionError(f"a worker picked {res['backend']}, "
                                     f"expected {backend}")
            if res["sha256"] != want or not res["equal"]:
                raise AssertionError(f"{backend} worker decoded wrong bytes")
    finally:
        for _b, p in jobs:
            p.kill()
            p.wait()


def check_wide_shards(torch, trace, st):
    """Each shard's K1-K4 of a traced ``lane_sharded_wide_runner`` run
    against their plain versions on the same CUDA inputs, tolerance 0;
    returns {kernel: {"err": ...}} over the shards."""
    from huffmandecoderongpus_tpu_torch.ops import k1_scan2, k2_compose
    from huffmandecoderongpus_tpu_torch.ops import k3_fix2, k4_compact

    p = st["plan"]
    k3 = dict(steps_p=p["steps_p"], SEG=p["SEG"], md=st["md"], C0=st["C0"],
              C1=st["C1"], NS=st["NS"])
    k1 = dict(k3, B=p["B"], H=st["H"], steps=p["steps"])
    errs = dict.fromkeys(("k1_scan2", "k2_compose", "k3_fix2", "k4_compact"),
                         0)
    for sh in trace["shards"]:
        wm, tab, lim = sh["inputs"]
        exmap = sh["k1"][3]
        rs, rv = k3_fix2.k3_fix2_ref(wm, tab, sh["entry"], *sh["cut"],
                                     sh["k1"][0].clone(), sh["k1"][1].clone(),
                                     **k3)
        for kname, got, want in (
                ("k1_scan2", sh["k1"], k1_scan2.k1_scan2_ref(wm, tab, lim,
                                                             **k1)),
                ("k2_compose", (sh["tot"], sh["entry"]),
                 (k2_compose.k2_compose_ref(exmap, 0)[1],
                  k2_compose.k2_compose_ref(exmap, sh["start"])[0])),
                ("k3_fix2", sh["k3"], (rs, rv)),
                ("k4_compact", (sh["k4"],),
                 (k4_compact.k4_compact_ref(rs, rv, ORP=p["ORP"]),))):
            errs[kname] = max(errs[kname], max_abs_err(torch, got, want))
    print("[sharded] lane_sharded_wide (a) at 2 shards: each shard's K1-K4 "
          f"against their plain versions on the card, max_abs_err {errs} "
          "(tolerance 0)", flush=True)
    if any(errs.values()):
        raise AssertionError(f"a shard's kernel differs: {errs}")
    return {k: {"err": e} for k, e in errs.items()}


def drive_sharded(torch, mods, hfs, idx, dev, card, checked):
    """Phase 4 of the multi-device layer, on virtual shards of the one card:
    spec_sharded, lane_sharded and lane_sharded_wide through the registry
    (one shard a visible card), then decode_sharded, decode_lane_sharded
    and decode_lane_sharded_wide on (a) and (b) at SHARDS virtual shards,
    the index-sharded decode on the indexed (a) at INDEXED_SHARDS, (c)
    (md 1) through lane_sharded_wide's fallback, each decode counted on its
    own (every shard launches its path once); each shard's K1-K4 at 2
    shards on (a) against their plain versions (into ``checked``); the
    multi-process jobs; then each decode's program (CUDA events) and wall
    beside lane_wide's program on the stream, and the scaling sweep on (a)
    at SHARDS.  Raises on any failure; returns the launches summed."""
    from huffmandecoderongpus_tpu_torch.harness.scaling import (
        format_sweep,
        scaling_sweep,
    )
    from huffmandecoderongpus_tpu_torch.models import get_decoder
    from huffmandecoderongpus_tpu_torch.ops import widescan as ws
    from huffmandecoderongpus_tpu_torch.parallel import (
        block_decode,
        decode_lane_sharded,
        decode_lane_sharded_indexed,
        decode_lane_sharded_wide,
        decode_sharded,
        lane_sharded,
        make_mesh,
    )

    jobs = start_mh_jobs()
    total = dict.fromkeys(mods, 0)

    def add(ran):
        for n, c in ran.items():
            total[n] += c

    def path(name, D):
        return {n: c * D for n, c in SHARDED_PATHS[name].items()}

    cards = torch.cuda.device_count()
    name, r, h = hfs["a"]
    for dec in SHARDED_PATHS:
        out, ran = counted(torch, mods, lambda dec=dec: get_decoder(
            dec, device=DEVICE)(h))
        expect(f"{dec} (registry, {cards} card) {name}",
               np.array_equal(out, r), ran, path(dec, cards))
        add(ran)
    fns = {"spec_sharded": decode_sharded, "lane_sharded": decode_lane_sharded,
           "lane_sharded_wide": decode_lane_sharded_wide}
    for k in SHARDED_STREAMS:
        name, r, h = hfs[k]
        for D in SHARDS:
            mesh = make_mesh(devices=[dev] * D)
            for dec, fn in fns.items():
                out, ran = counted(torch, mods, lambda fn=fn: fn(h, mesh=mesh))
                expect(f"{dec} {name} at {D} virtual shards",
                       np.array_equal(out, r), ran, path(dec, D))
                add(ran)
    name, r, h = idx["a"]
    for D in INDEXED_SHARDS:
        mesh = make_mesh(devices=[dev] * D)
        out, ran = counted(torch, mods, lambda: decode_lane_sharded_indexed(
            h, *h.index, mesh=mesh))
        expect(f"decode_lane_sharded_indexed {name} at {D} virtual shards",
               np.array_equal(out, r), ran,
               {"k1_main": D, "k4_compact": D})
        add(ran)
    name, r, h = hfs["c"]
    mesh = make_mesh(devices=[dev] * 2)
    out, ran = counted(torch, mods, lambda: decode_lane_sharded_wide(
        h, mesh=mesh))
    expect(f"decode_lane_sharded_wide {name} at 2 virtual shards (md 1: "
           "the lane-DFA sharded fallback)", np.array_equal(out, r), ran,
           path("lane_sharded", 2))
    add(ran)
    # each shard's kernels against their plain versions (not counted)
    name, r, h = hfs["a"]
    run, materialize = lane_sharded.lane_sharded_wide_runner(
        h, mesh=make_mesh(devices=[dev] * 2))
    trace = {}
    if not np.array_equal(materialize(run(trace))[0], r):
        raise AssertionError("traced lane_sharded_wide run decoded wrong")
    checked["a, 2 shards"] = check_wide_shards(
        torch, trace, lane_sharded.wide_sharded_staging(h, 2, device=dev))
    del trace
    finish_mh_jobs(jobs)

    # times: each decode's program by CUDA events and its wall, beside the
    # unsharded lane_wide program on the same stream
    for k in SHARDED_STREAMS:
        name, r, h = hfs[k]
        st = ws.stage_widescan_inputs(h, device=dev)
        args = ws.program_args(st)
        ts = event_ms(lambda: ws.wide_decode_program(
            st["words"], st["tab"], st["lim"], **args), 1 + SHARDED_RUNS)[1:]
        wide = statistics.median(ts)
        del st
        words, lut_sym, lut_len, height = block_decode.stage_block(h)
        staged = [torch.from_numpy(a).to(dev)
                  for a in (words, lut_sym, lut_len)]
        for D in SHARDS:
            mesh = make_mesh(devices=[dev] * D)
            programs = {
                "spec_sharded": lambda: block_decode.decode_sharded_arrays(
                    *staged, bits=h.bits, size=h.uncompressed_size,
                    height=height, mesh=mesh),
                "lane_sharded": lane_sharded.lane_sharded_runner(
                    h, mesh=mesh)[0],
                "lane_sharded_wide": lane_sharded.lane_sharded_wide_runner(
                    h, mesh=mesh)[0]}
            for dec, fn in fns.items():
                ts = event_ms(programs[dec], 1 + SHARDED_RUNS)[1:]
                wall, wmin = wall_ms(torch, lambda fn=fn: fn(h, mesh=mesh),
                                     runs=SHARDED_WALLS)
                print(f"[sharded] {dec} {name} at {D} virtual shards: "
                      f"program median {statistics.median(ts):.4f} ms (min "
                      f"{min(ts):.4f}) over {SHARDED_RUNS} runs, wall median "
                      f"{wall:.4f} ms (min {wmin:.4f}) over {SHARDED_WALLS}; "
                      f"lane_wide's program {wide:.4f} ms; card {card}",
                      flush=True)
            del programs
        del staged
        torch.cuda.empty_cache()
    name, r, h = hfs["a"]
    for sweep_path in ("lane", "wide"):
        points = scaling_sweep(h, r, sizes=list(SHARDS), repeats=SHARDED_WALLS,
                               path=sweep_path, devices=[dev] * max(SHARDS))
        print(f"[sharded] scaling sweep on {name} ({sweep_path} path, "
              f"virtual shards of one card: the cost of sharding, not "
              f"scaling; card {card}):", flush=True)
        for line in format_sweep(points).splitlines():
            print(f"[sharded]   {line}", flush=True)
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


#: the registry's host decoders (models/serial.py, models/dfa.py)
SERIAL = ("justreaddata", "simple", "simple_rp", "bigtable_v1",
          "bigtable_simple", "bigtable_multisym", "jumptable", "lin")


def host_cpu() -> str:
    """The host CPU as lscpu gives it (model name, vendor, family and
    model, CPUs), with /proc/cpuinfo's model name beside it, since a
    host may report its model name as unknown to lscpu."""
    try:
        out = subprocess.run(["lscpu"], capture_output=True,
                             text=True).stdout
    except OSError:
        out = ""
    fields = dict(line.split(":", 1) for line in out.splitlines()
                  if ":" in line)
    parts = [f"lscpu {k} {fields[k].strip()}" for k in (
        "Model name", "Vendor ID", "CPU family", "Model", "CPU(s)")
        if k in fields]
    info = pathlib.Path("/proc/cpuinfo")
    names = [line.split(":", 1)[1].strip()
             for line in (info.read_text().splitlines() if info.exists()
                          else []) if line.startswith("model name")]
    if names:
        parts.append(f"/proc/cpuinfo model name {names[0]}")
    return ", ".join(parts) or "not reported"


def run_printed(what, fn):
    """fn() with its standard output taken and printed after it, each line
    marked [suite], then its wall; returns what fn returned."""
    import contextlib
    import io

    buf = io.StringIO()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(buf):
            value = fn()
    finally:
        for line in buf.getvalue().splitlines():
            print(f"[suite] {line}")
    wall = time.perf_counter() - t0
    print(f"[suite] {what}: {wall:.1f} s wall, "
          f"{len(buf.getvalue().splitlines())} lines", flush=True)
    return value


def drive_suites(torch, mods, cpu):
    """Phase 4's suites.  A corpus directory of the five MAINRUN_NAMES
    (SUITE_CORPORA, under HUFF_FILES_DIR); every serial decoder on every
    corpus (evalandshow: a checked run, then the minimum of SUITE_REPEATS
    more); then, the launch counts read just before and just
    after, the SUITES through run_suite on the card and the verify command,
    each suite's rows and wall printed; every kernel of SUITE_PATH must
    have launched.  Then the DFA table builds on kjv.txt's tree at jumpbits
    1-14 (host ms) and each device row's speedup over simple a corpus
    (bigtable's rows).  A row that decodes wrong raises DecodeMismatch;
    returns the suites' launches."""
    import os
    import tempfile

    from huffmandecoderongpus_tpu_torch import data, native
    from huffmandecoderongpus_tpu_torch.harness import cli, evalandshow
    from huffmandecoderongpus_tpu_torch.huffio import encode_bytes, write_huff
    from huffmandecoderongpus_tpu_torch.models import dfa, get_decoder

    t0 = time.perf_counter()
    native.get_lib()
    print(f"[suite] host library {native.lib_path().name} built and loaded "
          f"in {time.perf_counter() - t0:.1f} s; host CPU {cpu}", flush=True)
    saved = {k: os.environ.get(k) for k in ("HUFF_FILES_DIR",
                                            "HUFF_CACHE_DIR")}
    rng = np.random.default_rng(SUITE_SEED)
    with tempfile.TemporaryDirectory() as tmp:
        files = pathlib.Path(tmp) / "files"
        files.mkdir()
        t0 = time.perf_counter()
        for name, n in SUITE_CORPORA.items():
            raw = text_like(rng, n)
            raw.tofile(files / name)
            write_huff(files / f"{name}.huff", encode_bytes(raw))
        print(f"[suite] corpora {SUITE_CORPORA} (bytes) written in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        os.environ["HUFF_FILES_DIR"] = str(files)
        os.environ["HUFF_CACHE_DIR"] = str(pathlib.Path(tmp) / "cache")
        try:
            if data.available_corpora() != data.MAINRUN_NAMES:
                raise AssertionError(f"corpora {data.available_corpora()}")
            tds = [data.load_test_data(n) for n in data.MAINRUN_NAMES]
            run_printed("every serial decoder on every corpus", lambda: [
                evalandshow(get_decoder(d, device=DEVICE), td,
                            repeats=SUITE_REPEATS)
                for d in SERIAL for td in tds])
            before = launch_counts()
            results = {suite: run_printed(suite, lambda suite=suite:
                                        cli.run_suite(suite, SUITE_REPEATS,
                                                      device=DEVICE))
                     for suite in SUITES}
            run_printed("verify command", lambda: cli.main(
                ["verify", str(files / "kjv.txt.huff"),
                 str(files / "kjv.txt"), "--device", DEVICE]))
            torch.cuda.synchronize()
            ran = launched_since(before, mods)
            print(f"[suite] launches in the suites and verify: {ran}",
                  flush=True)
            missing = [n for n in SUITE_PATH if not ran.get(n)]
            if missing:
                raise AssertionError(f"the suites launched no {missing}")
            tree = tds[-1].cd.tree
            builds = {}
            for k in range(1, 15):
                for what, build in (("jump", dfa.build_jump_dfa),
                                    ("lin", dfa.build_lin_dfa)):
                    t0 = time.perf_counter()
                    build(tree, k)
                    builds[f"{what} {k}"] = (time.perf_counter() - t0) * 1e3
            print("[suite] DFA table builds on kjv.txt's tree (host ms): "
                  + "  ".join(f"{k} {v:.2f}" for k, v in builds.items())
                  + f"; host CPU {cpu}", flush=True)
            rows = results["bigtable"]
            simple = {r.dataset: r.min_seconds for r in rows
                      if r.decoder == "simple"}
            for c in data.MAINRUN_NAMES:
                print(f"[suite] {c}: speedup over simple (bigtable rows) "
                      + "  ".join(f"{r.decoder} "
                                  f"{simple[c] / r.min_seconds:.3f}x"
                                  for r in rows
                                  if r.dataset == c and r.decoder != "simple")
                      + f"; host CPU {cpu}", flush=True)
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
    return ran


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
    if sys.argv[1:2] == [MH_ARG]:
        return mh_worker(sys.argv[2:])
    from huffmandecoderongpus_tpu_torch.huffio import encode_bytes
    from huffmandecoderongpus_tpu_torch.models import get_decoder
    from huffmandecoderongpus_tpu_torch.ops import _build, oneshot
    from huffmandecoderongpus_tpu_torch.ops import widescan as ws

    mods = ("k1_scan2", "k2_compose", "k3_fix2", "k4_compact", "k1_scan",
            "k3_fix", "candidate_scan", "lane_scan", "oneshot", "k1_main",
            "lane_scan_indexed", "k1_scan2_c01", "k3_fix2_c01",
            "short_candidate_scan", "lane_decode_dense", "compact",
            "spec_all_bits", "spec_double", "spec_tile", "spec_pair",
            "spec_query", "onethread")
    dev = torch.device(DEVICE)
    t_start = time.perf_counter()

    def phase_done(what):
        print(f"[phase] {what} done at {time.perf_counter() - t_start:.1f} s",
              flush=True)

    # ---- 1. device ----------------------------------------------------------
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"[device] {card}")
    print(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
          f"devices {torch.cuda.device_count()}", flush=True)
    cpu = host_cpu()
    print(f"[device] host CPU {cpu}", flush=True)

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
    small_raw = [text_like(rng, PAPER1_BYTES, n) for n in BATCH_SYMBOLS]
    book2 = text_like(rng, BOOK2_BYTES)
    if sys.argv[1:] == [CARD_ARG]:
        batches = {BATCH5: small_raw,
                   TRIO: [streams["f"][1], streams["g"][1], book2]}
        print(json.dumps({"encode": encode_card_ms(torch, streams, dev),
                          "scan": scan_card_ms(torch, streams, dev),
                          "k3": k3_card_ms(torch, streams, batches, dev),
                          "probe": probe_card_ms(torch, streams, dev),
                          "spec": spec_card_ms(torch, streams, dev)}))
        return 0
    card_ms = card_ms_fresh()
    hfs = {k: (f"{k} {name}", r, encode_bytes(r))
           for k, (name, r) in streams.items()}
    small = [(f"paper1-sized text over {n_sym} symbols", r, encode_bytes(r))
             for n_sym, r in zip(BATCH_SYMBOLS, small_raw)]
    trio = [hfs["f"], hfs["g"],
            ("book2-sized text", book2, encode_bytes(book2))]
    idx = {k: (f"{k} {streams[k][0]}, index every {K} symbols",
               streams[k][1], encode_bytes(streams[k][1], block_symbols=K))
           for k, K in (*INDEXED.items(), INDEXED_MD1)}
    checked = {k: check_kernels(torch, *hfs[k], dev,
                                k3_card=card_ms["k3"].get(k))
               for k in "abc"}
    checked["d"] = check_kernels(torch, *hfs["d"], dev, decodes=False,
                                 k3_card=card_ms["k3"].get("d"))
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
    checked.update(check_k3_cases(torch, dev))
    for k in ENCODE_CHECKED:
        checked.setdefault(k, {}).update(
            check_encoder(torch, *hfs[k], dev, card_ms["encode"].get(k, {})))
    checked.update(check_encoder_cases(torch, dev))
    for k in INDEXED:
        checked[IDX[k]] = check_indexed(torch, *idx[k], dev)
    for k in ("a", INDEXED_MD1[0]):
        checked.setdefault(IDX[k], {}).update(
            check_lanedfa_indexed(torch, *idx[k], dev,
                                  card_ms["scan"].get(IDX[k])))
    checked.update(check_scan_cases(torch, dev))
    for what, members in ((BATCH5, small), (TRIO, trio)):
        checked[what] = check_batch(torch, what,
                                    [r for _n, r, _h in members],
                                    [h for _n, _r, h in members], dev,
                                    card_ms["k3"].get(what))
    for k in SYNC:
        checked[SYNC[k]] = check_sync(torch, *hfs[k], dev,
                                      card_ms["scan"].get(SYNC[k]))
        checked[k].update(check_dense(torch, *hfs[k], dev,
                                      with_compact=k == "d",
                                      card_ms=card_ms["scan"].get(
                                          f"dense {k}"),
                                      compact_card=card_ms["probe"].get(
                                          "compact d")))
    checked.update(check_dense_cases(torch, dev))
    checked.update(check_compact_cases(torch, dev))
    for k in SPEC_CHECKED:
        checked[k].update(check_spec(torch, *hfs[k], dev,
                                     card_ms["spec"].get(k)))
    checked["spec edges"] = check_spec_cases(torch, dev)
    for k in ONETHREAD_CHECKED:
        checked.setdefault(k, {}).update(check_onethread(
            torch, *hfs[k], dev, card_ms["spec"].get(f"onethread {k}")))

    phase_done("3 kernels")

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
                  drive_sync(torch, mods, hfs, dev, card),
                  drive_spec(torch, mods, hfs, dev, card, card_ms["spec"]),
                  drive_suites(torch, mods, cpu)):
        for n, c in route.items():
            launches[n] += c
    if min(c for n, c in launches.items() if n not in YARDSTICKS) < 1:
        raise AssertionError(f"a kernel was not launched: {launches}")
    phase_done("4 decode routes and suites")
    for n, c in drive_sharded(torch, mods, hfs, idx, dev, card,
                              checked).items():
        launches[n] += c
    phase_done("4 sharded")
    # the encoder's launches are counted apart from the decode paths' check
    launches.update(drive_encoder(torch, hfs, dev, card))
    phase_done("4 encoder")

    # ---- 5. the probes: their kernels, the probe programs, prof ------------
    probe_rows = check_probe_kernels(torch, hfs, dev, card_ms["probe"])
    launches.update(drive_probes(torch, hfs, dev, card))
    from huffmandecoderongpus_tpu_torch.probes import hw_dispatch
    print("[launch] " + hw_dispatch.split_line(hw_dispatch.host_split(dev),
                                               hw_dispatch.host_calls(dev))
          + f"; card {card}", flush=True)

    phase_done("5 probes")

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
        before = launch_counts()
        # the dense pipeline: candidate scan, compose, dense decode, trim
        cnt, ex = candidate_scan.candidate_scan(st["bits"], st["tab"], **kw)
        entry = ld.compose(cnt, ex)[0]
        dense, counts = lane_decode_dense.lane_decode_dense(
            st["bits"], st["tab"], entry, out_rows=out_rows, **kw)
        out = trimmed(torch, dense, counts)
        ran = launched_since(before, mods)
        expect(f"dense pipeline {name}", np.array_equal(out, r), ran,
               dict.fromkeys(DENSE_PATH, 1))
        add(ran)
        if k != "d":
            continue
        before = launch_counts()
        cnt, ex = candidate_scan.candidate_scan(st["bits"], st["tab"], **kw)
        entry = ld.compose(cnt, ex)[0]
        sym, valid = lane_scan.lane_scan(st["bits"], st["tab"], entry, **kw)
        cum = torch.cumsum(valid, 0, dtype=torch.int32)
        out = trimmed(torch, compact.compact(cum, sym, out_rows=out_rows),
                      cum[-1])
        ran = launched_since(before, mods)
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
    from huffmandecoderongpus_tpu_torch.ops import encode, encode_ops

    mods = ("e1_pack", "e2_compact", "e3_place")

    def same(hf, want):
        return (hf.bits == want.bits and hf.tree.shape == want.tree.shape
                and np.array_equal(hf.tree, want.tree)
                and np.array_equal(hf.payload, want.payload))

    def drive(name, raw, want, tree=None, lanes=None,
              path=dict.fromkeys(ENCODE_PATH, 1), retries=0):
        before = launch_counts()
        tries = encode_retries()
        t0 = time.perf_counter()
        hf = encode.encode_lanes(raw, tree=tree, lanes=lanes, device=DEVICE)
        wall = time.perf_counter() - t0
        ran = launched_since(before, mods)
        tries = encode_retries() - tries
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


def check_probe_kernels(torch, hfs, dev, cards):
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
    taken too.  P4 also runs at ``probes.streams.P4_CASES``, and a [p4]
    line a stage on (a) gives its card time from ``cards``
    (probe_card_ms) beside k4_compact's there, as the [p2] line P2's and
    the library calls' card times there."""
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
    from huffmandecoderongpus_tpu_torch.probes import streams as ps
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
    bound = (nbytes(sym, val) + sym.shape[1] * ORP) / HBM_BYTES_PER_S * 1e3
    plan = k4_stripped.p4_plan(sym.shape[1], sym.data_ptr(), val.data_ptr(),
                               0, ORP)
    k4 = cards.get("k4_compact p4")
    for stage in k4_stripped.STAGES:
        ms = cards.get(f"k4_stripped {stage}")
        own = ("not measured" if ms is None else
               f"{ms:.5f} ms, {ms / bound:.2f} times the bound")
        print(f"[p4] (a) {stage}: card {own} (a fresh process); bytes bound "
              f"{bound:.6f} ms; k4_compact on the same cells "
              f"{us(k4)} on the card (the same process); plan {plan}",
              flush=True)
    for case in ps.P4_CASES:
        csym, cnib, cORP = ps.p4_case(case, dev)
        for stage in k4_stripped.STAGES:
            check("k4_stripped", f"case {case} {stage} {tuple(csym.shape)} "
                  f"ORP={cORP}",
                  lambda stage=stage, csym=csym, cnib=cnib, cORP=cORP:
                  k4_stripped.k4_stripped(csym, cnib, ORP=cORP, stage=stage),
                  lambda stage=stage, csym=csym, cnib=cnib, cORP=cORP:
                  k4_stripped.k4_stripped_ref(csym, cnib, ORP=cORP,
                                              stage=stage), (csym, cnib))
    p2 = cards.get("probe_arith")
    print(f"[p2] xor3 P=8 S={probe_vpu2.STEPS}: card {us(p2)} a call (a "
          f"fresh process); x + 1 {us(cards.get('x + 1'))}, torch.gather "
          f"{cards.get('torch.gather shape')} "
          f"{us(cards.get('torch.gather'))} on the card (the same process)",
          flush=True)
    return rows


def drive_probes(torch, hfs, dev, card):
    """Phase 5, the probe programs and the stage profiler: the six probes
    (``probes.run``, their kernels' launch counts set to 0 just before and
    read just after; each raises on a WRONG line), then ``prof`` on (a)
    ``widescan`` and (d) ``lanedfa`` through the command's function on
    their `.huff` files, and (a) ``speculative``, each report's every key
    present and >= 0.
    Returns the probe kernels' launches."""
    import tempfile

    from huffmandecoderongpus_tpu_torch import probes
    from huffmandecoderongpus_tpu_torch.harness import cli
    from huffmandecoderongpus_tpu_torch.huffio import write_huff

    mods = ("probe_inc", "probe_arith", "probe_gather", "k4_stripped")
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
                        "main_scan", "host_compaction", "total"],
            "speculative": ["decodeAllBits", "makebigtable", "index_query",
                            "total"]}
    with tempfile.TemporaryDirectory() as tmp:
        for k, which in (("a", "widescan"), ("d", "lanedfa"),
                         ("a", "speculative")):
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
