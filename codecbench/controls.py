"""The controls: each cell's timed path with one of the configuration's
guarantees broken, which the check must find.

- The decodes (``lane_wide``, ``widescan_batch``): the port's four-kernel
  program with K3 left out, so lanes entered in the middle of a codeword
  keep K1's guesses (the re-synchronisation that makes the decode
  lossless is skipped).
- The encode (``encode_lanes``): the plain reference with each run of
  symbols starting on a 16-bit boundary (``reference.lane_aligned_encode``),
  so the payload is not one contiguous bitstream.

Run on the card at a cell's own size, a short window a seed:

    python3 codecbench/controls.py --workload enwik8-decode \
        --seeds 11,12,13 --seconds 3

Each seed prints the cell's check numbers (which must exceed their
limits) and ``correct``.
"""

import argparse
import json
import pathlib
import sys
import time

sys.path[0] = str(pathlib.Path(__file__).resolve().parent.parent)

#: lanes of the encode control's runs
ENCODE_RUNS = 8192


def decode_without_fix(hf, device):
    """``decode_widescan``'s four-kernel program with K3 left out: K1, K2,
    the counts at each lane's entry, K4 and the trim."""
    import torch

    from huffmandecoderongpus_tpu_torch.ops import widescan
    from huffmandecoderongpus_tpu_torch.ops.k2_compose import k2_compose
    from huffmandecoderongpus_tpu_torch.ops.k4_compact import k4_compact

    st = widescan.stage_widescan_inputs(hf, device=device)
    args = widescan.program_args(st)
    ORP = args.pop("ORP")
    _w, sym, val, cntmap, exmap, _m = widescan.stage_k1(
        st["words"], st["tab"], st["lim"], **args)
    entry, _tot = k2_compose(exmap, 0)
    n = widescan.select_h(cntmap, entry, args["H"]).clamp(max=ORP)
    dense = k4_compact(sym, val, ORP=ORP)
    mask = torch.arange(ORP, device=dense.device)[None, :] < n[:, None]
    return dense[mask].cpu().numpy()


def control(entry_name: str):
    """The control's ``request(state, i)`` for an entry."""
    if entry_name == "lane_wide":
        return lambda state, i: decode_without_fix(state.current,
                                                   state.device)
    if entry_name == "widescan_batch":
        return lambda state, i: [decode_without_fix(hf, state.device)
                                 for hf in state.current]
    if entry_name == "encode_lanes":
        return _aligned_encode
    raise KeyError(f"no control for entry {entry_name!r}")


def _aligned_encode(state, i):
    import torch

    from codecbench import reference
    from huffmandecoderongpus_tpu_torch import HuffFile

    data = torch.from_numpy(state.data).to(state.device)
    tree, bits, payload = reference.lane_aligned_encode(data, state.tree,
                                                        ENCODE_RUNS)
    return HuffFile(tree=tree, bits=bits, uncompressed_size=int(data.numel()),
                    payload=payload.cpu().numpy())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="run a cell's control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated seeds")
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args(argv)

    from codecbench import harness
    from codecbench.spec import Spec

    spec = Spec()
    entry = spec.traffic(spec.workload(args.workload)["traffic"])["entry"]
    for seed in (int(s) for s in args.seeds.split(",")):
        res, _lines = harness.run_cell(
            spec, args.workload, seed, args.seconds, False, device="cuda",
            t_start=time.perf_counter(), request=control(entry))
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "control": True, "correct": res["correct"],
                          "attempted": res["attempted"],
                          "checks": res["checks"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
