"""The lane-DFA scans of one tree of the PyTorch port on a GPU, for timing
two trees in turns within one machine.

    python3 huffmandecoderongpus_tpu_torch/harness/scan_turns.py [TREE] [--tag NAME] [--sections scans,prof,sync,indexed,short,dense,cards]

Run it as a file, not with ``-m``: it imports the port from TREE (a
checkout of this repository; default the one that holds this file), so
that a parent tree unpacked beside this one (``git archive``), which may
not have this file, is timed by the same code: run parent, change, change,
parent.  Needs one CUDA card and nvcc; imports nothing of JAX.  Takes its
streams from ``draw_streams`` of this checkout's ``chip_smoke.py`` (same
seed, same order; the trio batch from the draws after it, as there) and
prints, beside the card's name, power limit and maximum SM clock:

  scans      on (d) in the tiled geometry (``chip_smoke.py``'s rows 8 and
             9): candidate_scan, and lane_scan from the entry offsets of
             candidate_scan + compose, each by CUDA events (median of 20
             single launches) and on the card (torch.profiler, mean of 5),
             with cycles a bit row at the maximum SM clock
  prof       ``profile_lanedfa`` (the ``prof ... lanedfa`` command's
             stages) on (d) and on (e)
  sync       on (d) in the sync geometry: the sync discovery (the 0-chain
             lane_scan, the short candidate scans, the tail column's
             candidate_scan, the fix scan and splice) by CUDA events
             (median of 25 after 3) and split by kernel (profiler)
  indexed    lane_scan_indexed in lane_dfa's geometry (a lane an index
             block) on the indexed (a) at 512 symbols a block, (b) at
             1024, (i) at 512 and (c) at 4096 (chip_smoke.py's INDEXED and
             INDEXED_MD1): by events (median of 20 single launches) and on
             the card (profiler, mean a launch), cycles a row over the B
             rows, the chain floor (B rows, and B / 2 two-bit steps, x 40
             cycles at the maximum SM clock), the bytes bound (the bits
             read, sym and valid written, at 3.35 TB/s) and, where the tree
             has ``indexed_plan``, its plan
  short      short_candidate_scan on every round lane_dfa_sync runs on (a),
             (d) and (e) (W from 128, doubling while a chain is unresolved,
             as ``discover_and_splice``): by events and on the card, beside
             the chain floor (W rows x 40 cycles) and, where the tree has
             ``short_plan``, its plan
  dense      on (d) and (a) in the dense pipeline's geometry
             (``chip_smoke.py``'s rows 9 and 11: the entry offsets of
             candidate_scan + compose, out_rows B // min code length + 2;
             (d)'s blank run puts lanes a window ahead): lane_decode_dense and
             lane_scan on the same inputs, in the same process, each by
             events (median of 20 single launches) and on the card
             (profiler, mean a launch), in cycles a row over the B + H rows
             at the maximum SM clock, beside the chain floor (B + H rows x
             40 cycles), the dense decode's bytes bound and, where the tree
             has ``dense_plan``, its plan and its lanes' own write-outs (a
             lane a window of ranks ahead; the kernel's count)
  cards      the card time a launch (profiler, mean a launch) of every
             kernel in the wide program on (a), the batch program on the
             trio (f), (g) and the book2-sized stream, the encode program
             on (a), and the dense and the compaction pipelines on (d)
             (candidate_scan, compose, then lane_decode_dense; lane_scan,
             cumsum, compact); where the tree has ``compact_plan``
             (row-chunk tiles of 128 columns by 64 rows, the ranks staged
             in shared memory and written a row a store, the zero fill
             spread over the chunks), compact's plan, its bytes bound
             and the kernel's own count of blocks whose rank union is
             wider than two chunks (``compact.STATS``)

The last line is one JSON object of every number.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import pathlib
import statistics
import subprocess
import sys

import numpy as np

HERE = pathlib.Path(__file__).resolve().parents[2]
SCAN_RUNS = 20
SYNC_RUNS, WARMUP = 25, 3


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("tree", nargs="?", default=str(HERE))
    ap.add_argument("--tag", default="tree")
    ap.add_argument("--sections",
                    default="scans,prof,sync,indexed,short,dense,cards")
    args = ap.parse_args()
    sections = args.sections.split(",")
    tree = pathlib.Path(args.tree).resolve()
    sys.path[0] = str(tree)  # not this file's folder
    # the streams from this checkout's chip_smoke.py; its imports of the
    # port resolve to TREE's, which is first on the path
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  HERE / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    import torch

    if not torch.cuda.is_available():
        print("scan_turns: no CUDA device", file=sys.stderr)
        return 1
    from huffmandecoderongpus_tpu_torch.huffio import encode_bytes
    from huffmandecoderongpus_tpu_torch.ops import _build

    if not pathlib.Path(_build.__file__).resolve().is_relative_to(tree):
        raise RuntimeError(f"the port was not imported from {tree}")
    q = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    name, power, mhz = (s.strip() for s in q.split(","))
    card = f"{name}, {power} W"
    clock = float(mhz) * 1e6
    _build.get_lib()

    streams = cs.draw_streams(np.random.default_rng(cs.SEED))
    hf_d, hf_e = (encode_bytes(streams[k][1]) for k in "de")
    dev = torch.device("cuda")
    out = {"tag": args.tag, "tree": str(tree), "card": card,
           "clocks_max_sm_mhz": float(mhz)}

    if "scans" in sections:
        scans_section(torch, cs, out, hf_d, dev, card, clock, args.tag)
    if "prof" in sections:
        prof_section(out, hf_d, hf_e, dev, card, args.tag)
    if "sync" in sections:
        sync_section(torch, cs, out, hf_d, dev, card, args.tag)
    if "indexed" in sections:
        indexed_section(torch, cs, out, streams, dev, card, clock, args.tag)
    if "short" in sections:
        short_section(torch, cs, out, streams, dev, card, clock, args.tag)
    if "dense" in sections:
        for k, hf in (("d", hf_d), ("a", encode_bytes(streams["a"][1]))):
            dense_section(torch, cs, out, k, hf, dev, card, clock, args.tag)
    if "cards" in sections:
        cards_section(torch, cs, out, streams, dev, card, args.tag)
    print(json.dumps(out))
    return 0


def scans_section(torch, cs, out, hf_d, dev, card, clock, tag):
    """The scans section: candidate_scan and lane_scan on (d)."""
    from huffmandecoderongpus_tpu_torch.harness.timing import event_ms
    from huffmandecoderongpus_tpu_torch.ops import candidate_scan, lane_scan
    from huffmandecoderongpus_tpu_torch.ops import lanedfa_decode as ld

    st = ld.stage_lanedfa(hf_d, device=dev)
    bits, tab = st["bits"], st["tab"]
    kw = dict(B=st["B"], H=st["H"], N=st["N"])
    entry = ld.compose(*candidate_scan.candidate_scan(bits, tab, **kw))[0]
    fns = {"candidate_scan": lambda: candidate_scan.candidate_scan(
               bits, tab, **kw),
           "lane_scan": lambda: lane_scan.lane_scan(bits, tab, entry, **kw)}
    rows = bits.shape[0]
    out["d"] = dict(G=bits.shape[1], B=st["B"], H=st["H"], rows=rows)
    for kname, fn in fns.items():
        ev = statistics.median(event_ms(fn, SCAN_RUNS, warmup=2))
        card_ms = cs.device_breakdown(torch, fn, per_launch=True).get(kname)
        cyc = None if card_ms is None else card_ms * 1e-3 * clock / rows
        out[kname] = dict(events_ms=ev, card_ms=card_ms, cycles_a_row=cyc)
        own = ("not measured" if card_ms is None else
               f"{card_ms:.4f} ms, {cyc:.1f} cycles a row")
        print(f"[scans] {tag} (d) {kname}: events {ev:.4f} ms, card "
              f"{own} over {rows} rows (G={bits.shape[1]} B={st['B']} "
              f"H={st['H']}); card {card}", flush=True)


def prof_section(out, hf_d, hf_e, dev, card, tag):
    """The prof section: profile_lanedfa on (d) and (e)."""
    from huffmandecoderongpus_tpu_torch.harness.profiling import (
        profile_lanedfa,
    )

    for k, hf in (("d", hf_d), ("e", hf_e)):
        rep = profile_lanedfa(hf, device=dev)
        out[f"prof_{k}_ms"] = {s: v * 1e3 for s, v in rep.items()}
        print(f"[prof] {tag} ({k}) lanedfa ms "
              + "  ".join(f"{s} {v * 1e3:.4f}" for s, v in rep.items())
              + f"; card {card}", flush=True)


def sync_section(torch, cs, out, hf_d, dev, card, tag):
    """The sync section: sync discovery on (d), events and split."""
    from huffmandecoderongpus_tpu_torch.harness.timing import event_ms
    from huffmandecoderongpus_tpu_torch.ops import lane_scan, lanedfa_sync
    from huffmandecoderongpus_tpu_torch.ops import lanedfa_decode as ld

    st = ld.stage_lanedfa(hf_d, device=dev, tiled=False)
    bits, tab = st["bits"], st["tab"]
    kw = dict(B=st["B"], H=st["H"], N=st["N"])
    zero = torch.zeros(bits.shape[1], dtype=torch.int32, device=dev)

    def sync_discovery():
        sym0, valid0 = lane_scan.lane_scan(bits, tab, zero, **kw)
        return lanedfa_sync.discover_and_splice(bits, tab, sym0, valid0, **kw)

    ts = event_ms(sync_discovery, WARMUP + SYNC_RUNS)[WARMUP:]
    split = cs.device_breakdown(torch, sync_discovery, ops_by_name=True)
    out["sync_d"] = dict(G=bits.shape[1], B=st["B"],
                         events_ms=statistics.median(ts), min_ms=min(ts),
                         card_ms=split)
    print(f"[sync] {tag} (d) G={bits.shape[1]} B={st['B']}: events "
          f"median {statistics.median(ts):.4f} ms (min {min(ts):.4f}); card "
          + "  ".join(f"{n} {v:.4f}" for n, v in sorted(
              split.items(), key=lambda kv: -kv[1]))
          + f"; card {card}", flush=True)


def _timed(torch, cs, fn, kname):
    """(events ms, card ms or None) of one launch of ``fn``: the median of
    SCAN_RUNS single launches by events, the profiler's mean a launch."""
    from huffmandecoderongpus_tpu_torch.harness.timing import event_ms

    ev = statistics.median(event_ms(fn, SCAN_RUNS, warmup=2))
    return ev, cs.device_breakdown(torch, fn, per_launch=True).get(kname)


def indexed_section(torch, cs, out, streams, dev, card, clock, tag):
    """The indexed section: lane_scan_indexed on the indexed streams."""
    from huffmandecoderongpus_tpu_torch.huffio import encode_bytes
    from huffmandecoderongpus_tpu_torch.ops import lanedfa
    from huffmandecoderongpus_tpu_torch.ops import lane_scan_indexed as lsi
    from huffmandecoderongpus_tpu_torch.ops import lanedfa_decode as ld

    plan = getattr(lanedfa, "indexed_plan", None)
    for k, K in (*cs.INDEXED.items(), cs.INDEXED_MD1):
        hf = encode_bytes(streams[k][1], block_symbols=K)
        st = ld.stage_lanedfa_indexed(hf, hf.index[0], device=dev,
                                      tiled=False)
        args = (st["bits"], st["tab"], st["lane_len"])
        B, G = st["bits"].shape
        ev, card_ms = _timed(torch, cs, lambda args=args:
                             lsi.lane_scan_indexed(*args),
                             "lane_scan_indexed")
        moved = 3 * B * G + cs.nbytes(st["tab"], st["lane_len"])
        bound = moved / cs.HBM_BYTES_PER_S * 1e3
        floor1 = B * cs.CHAIN_CYCLES_A_ROW / clock * 1e3
        cyc = None if card_ms is None else card_ms * 1e-3 * clock / B
        p = plan and plan(G, st["bits"].data_ptr(), st["tab"].numel())
        out[f"indexed_{k}@{K}"] = dict(
            G=G, B=B, events_ms=ev, card_ms=card_ms, cycles_a_row=cyc,
            bound_ms=bound, floor_1bit_ms=floor1, floor_2bit_ms=floor1 / 2,
            plan=p)
        own = ("not measured" if card_ms is None else
               f"{card_ms:.4f} ms, {cyc:.1f} cycles a row")
        print(f"[indexed] {tag} ({k}) at {K}: lane_scan_indexed events "
              f"{ev:.4f} ms, card {own}; G={G} B={B}; chain floor "
              f"{floor1:.4f} ms (1 bit a lookup), {floor1 / 2:.4f} (2 bits);"
              f" bytes bound {bound:.6f} ms; plan {p}; card {card}",
              flush=True)


def short_section(torch, cs, out, streams, dev, card, clock, tag):
    """The short section: every round's short_candidate_scan on (a), (d)
    and (e) in lane_dfa_sync's geometry."""
    from huffmandecoderongpus_tpu_torch.huffio import encode_bytes
    from huffmandecoderongpus_tpu_torch.ops import (
        lane_scan,
        lanedfa,
        lanedfa_sync,
        short_candidate_scan,
    )
    from huffmandecoderongpus_tpu_torch.ops import lanedfa_decode as ld

    plan = getattr(lanedfa, "short_plan", None)
    for k in "ade":
        hf = encode_bytes(streams[k][1])
        st = ld.stage_lanedfa(hf, device=dev, tiled=False)
        bits, tab = st["bits"], st["tab"]
        B, H, N = st["B"], st["H"], st["N"]
        steps, G = bits.shape
        zero = torch.zeros(G, dtype=torch.int32, device=dev)
        valid0 = lane_scan.lane_scan(bits, tab, zero, B=B, H=H, N=N)[1]
        # the rounds discover_and_splice runs
        dead = ((torch.arange(G, device=dev) * B)[None, :]
                + torch.arange(H, device=dev)[:, None]) >= N
        tail = min(max((N - 1) // B, 0), G - 1)
        W = min(max(lanedfa_sync.W0, H + 1), steps)
        rounds = []
        while True:
            def fn(W=W):
                return short_candidate_scan.short_candidate_scan(
                    bits, tab, valid0, B=B, H=H, N=N, W=W)

            res = fn()
            ev, card_ms = _timed(torch, cs, fn, "short_candidate_scan")
            floor = W * cs.CHAIN_CYCLES_A_ROW / clock * 1e3
            moved = cs.short_scan_moved(torch, res, tab, B, N, W)
            p = plan and plan(G, H, bits.data_ptr() | valid0.data_ptr())
            rounds.append(dict(W=W, events_ms=ev, card_ms=card_ms,
                               floor_ms=floor,
                               bound_ms=moved / cs.HBM_BYTES_PER_S * 1e3,
                               plan=p))
            own = "not measured" if card_ms is None else f"{card_ms:.4f} ms"
            print(f"[short] {tag} ({k}) round {len(rounds)} W={W}: "
                  f"short_candidate_scan events {ev:.4f} ms, card {own}; "
                  f"chain floor {floor:.4f} ms; G={G} B={B} H={H}; plan "
                  f"{p}; card {card}", flush=True)
            merged, exited = res[0], res[1]
            unresolved = ~(merged | exited | dead)
            unresolved[:, tail] = False
            if W >= steps or not bool(unresolved.any()):
                break
            W = min(W * 2, steps)
        out[f"short_{k}"] = dict(G=G, B=B, H=H, rounds=rounds)


def dense_section(torch, cs, out, k, hf, dev, card, clock, tag):
    """The dense section on stream ``k``: lane_decode_dense beside
    lane_scan."""
    from huffmandecoderongpus_tpu_torch.ops import lane_decode_dense as ldd
    from huffmandecoderongpus_tpu_torch.ops import lane_scan

    sd, entry, out_rows = cs.dense_staging(torch, hf, dev)
    bits, tab = sd["bits"], sd["tab"]
    kw = dict(B=sd["B"], H=sd["H"], N=sd["N"])
    rows, G = bits.shape
    planned = hasattr(ldd, "dense_plan")
    fns = {"lane_decode_dense": lambda: ldd.lane_decode_dense(
               bits, tab, entry, out_rows=out_rows, **kw),
           "lane_scan": lambda: lane_scan.lane_scan(bits, tab, entry, **kw)}
    dense = fns["lane_decode_dense"]()[0]
    moved = cs.nbytes(bits, tab, entry, dense) + 4 * G
    floor = rows * cs.CHAIN_CYCLES_A_ROW / clock * 1e3
    row = dict(G=G, B=sd["B"], H=sd["H"], rows=rows, out_rows=out_rows,
               floor_ms=floor, bound_ms=moved / cs.HBM_BYTES_PER_S * 1e3)
    if planned:
        ahead = torch.zeros(1, dtype=torch.int32, device=dev)
        ldd.lane_decode_dense(bits, tab, entry, out_rows=out_rows,
                              ahead=ahead, **kw)
        row.update(plan=ldd.dense_plan(G, bits.data_ptr(), dense.data_ptr()),
                   lane_writes=int(ahead))
    for kname, fn in fns.items():
        ev, card_ms = _timed(torch, cs, fn, kname)
        cyc = None if card_ms is None else card_ms * 1e-3 * clock / rows
        row[kname] = dict(events_ms=ev, card_ms=card_ms, cycles_a_row=cyc)
        own = ("not measured" if card_ms is None else
               f"{card_ms:.4f} ms, {cyc:.1f} cycles a row, "
               f"{card_ms / floor:.1f} times the chain floor")
        print(f"[dense] {tag} ({k}) {kname}: events {ev:.4f} ms, card {own} "
              f"over {rows} rows (G={G} B={sd['B']} H={sd['H']} "
              f"out_rows={out_rows}); chain floor {floor:.4f} ms; card "
              f"{card}", flush=True)
    print(f"[dense] {tag} ({k}): bytes bound {row['bound_ms']:.6f} ms; plan "
          f"{row.get('plan')}; lane write-outs {row.get('lane_writes')}",
          flush=True)
    out[f"dense_{k}"] = row


def cards_section(torch, cs, out, streams, dev, card, tag):
    """The cards section: each kernel's card time a launch in the wide,
    batch, encode, dense and compaction programs."""
    from huffmandecoderongpus_tpu_torch.huffio import encode_bytes
    from huffmandecoderongpus_tpu_torch.ops import (
        batch,
        compact,
        encode,
        lane_decode_dense,
        lane_scan,
    )
    from huffmandecoderongpus_tpu_torch.ops import widescan as ws

    rng = np.random.default_rng(cs.SEED)
    cs.draw_streams(rng)  # the batches are drawn after (a)-(i)
    for n in cs.BATCH_SYMBOLS:
        cs.text_like(rng, cs.PAPER1_BYTES, n)
    trio = [encode_bytes(r) for r in (streams["f"][1], streams["g"][1],
                                      cs.text_like(rng, cs.BOOK2_BYTES))]
    hf_a = encode_bytes(streams["a"][1])
    sw = ws.stage_widescan_inputs(hf_a, device=dev)
    sb = batch.stage_batch_inputs(trio, device=dev)
    se = encode.stage_encode_inputs(streams["a"][1], device=dev)
    pe = se["plan"]
    sd, entry, out_rows = cs.dense_staging(torch,
                                           encode_bytes(streams["d"][1]), dev)
    kw = dict(B=sd["B"], H=sd["H"], N=sd["N"])
    _sym, valid = lane_scan.lane_scan(sd["bits"], sd["tab"], entry, **kw)
    cum = torch.cumsum(valid, 0, dtype=torch.int32)
    programs = {
        "wide (a)": lambda: ws.wide_decode_program(
            sw["words"], sw["tab"], sw["lim"], **ws.program_args(sw)),
        "batch (f)+(g)+book2": lambda: batch.batch_decode_program(
            *batch.batch_inputs(sb), **batch.batch_args(sb)),
        "encode (a)": lambda: encode.encode_program(
            se["data3"], se["lo"], se["hi"], se["nval"], ORP=pe["ORP"],
            NROWS=pe["NROWS"]),
        "dense (d)": lambda: lane_decode_dense.lane_decode_dense(
            sd["bits"], sd["tab"], entry, out_rows=out_rows, **kw),
        "compact (d)": lambda: compact.compact(cum, _sym, out_rows=out_rows),
    }
    for what, fn in programs.items():
        split = cs.device_breakdown(torch, fn, per_launch=True)
        out[f"cards {what}"] = split
        print(f"[cards] {tag} {what}: card ms a launch "
              + "  ".join(f"{n} {v:.4f}" for n, v in split.items())
              + f"; card {card}", flush=True)
    if hasattr(compact, "compact_plan"):
        row = cs.compact_stats(torch, compact, cum, _sym, out_rows)
        out["cards compact (d) plan"] = row
        print(f"[cards] {tag} compact (d): {row}; card {card}", flush=True)


if __name__ == "__main__":
    sys.exit(main())
