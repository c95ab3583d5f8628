"""The lane-DFA scans of one tree of the PyTorch port on a GPU, for timing
two trees in turns within one machine.

    python3 huffmandecoderongpus_tpu_torch/harness/scan_turns.py [TREE] [--tag NAME]

Run it as a file, not with ``-m``: it imports the port from TREE (a
checkout of this repository; default the one that holds this file), so
that a parent tree unpacked beside this one (``git archive``), which may
not have this file, is timed by the same code: run parent, change, change,
parent.  Needs one CUDA card and nvcc; imports nothing of JAX.  Takes the
streams (d) and (e) from ``draw_streams`` of this checkout's
``chip_smoke.py`` (same seed, same order) and prints, beside the card's name,
power limit and maximum SM clock:

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
    args = ap.parse_args()
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
    from huffmandecoderongpus_tpu_torch.harness.profiling import (
        profile_lanedfa,
    )
    from huffmandecoderongpus_tpu_torch.harness.timing import event_ms
    from huffmandecoderongpus_tpu_torch.huffio import encode_bytes
    from huffmandecoderongpus_tpu_torch.ops import (
        _build,
        candidate_scan,
        lane_scan,
        lanedfa_sync,
    )
    from huffmandecoderongpus_tpu_torch.ops import lanedfa_decode as ld

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
        print(f"[scans] {args.tag} (d) {kname}: events {ev:.4f} ms, card "
              f"{own} over {rows} rows (G={bits.shape[1]} B={st['B']} "
              f"H={st['H']}); card {card}", flush=True)

    for k, hf in (("d", hf_d), ("e", hf_e)):
        rep = profile_lanedfa(hf, device=dev)
        out[f"prof_{k}_ms"] = {s: v * 1e3 for s, v in rep.items()}
        print(f"[prof] {args.tag} ({k}) lanedfa ms "
              + "  ".join(f"{s} {v * 1e3:.4f}" for s, v in rep.items())
              + f"; card {card}", flush=True)

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
    print(f"[sync] {args.tag} (d) G={bits.shape[1]} B={st['B']}: events "
          f"median {statistics.median(ts):.4f} ms (min {min(ts):.4f}); card "
          + "  ".join(f"{n} {v:.4f}" for n, v in sorted(
              split.items(), key=lambda kv: -kv[1]))
          + f"; card {card}", flush=True)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
