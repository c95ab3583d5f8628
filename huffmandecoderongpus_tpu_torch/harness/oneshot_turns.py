"""K4, the one-shot launch and K1 of one tree of the PyTorch port on a GPU,
for timing two trees in turns within one machine.

    python3 huffmandecoderongpus_tpu_torch/harness/oneshot_turns.py [TREE] [--tag NAME] [--sections k4,oneshot,k1,k1main,k2,md1,encode]

Run it as a file, not with ``-m``, as ``scan_turns.py`` beside it: it
imports the port from TREE (a checkout of this repository; default the one
that holds this file), so that a parent tree unpacked beside this one
(``git archive``) is timed by the same code: run parent, change, change,
parent.  Needs one CUDA card and nvcc; imports nothing of JAX.  Takes the
streams (a)-(d), (f)-(i) and the batches from this checkout's
``chip_smoke.py`` (``draw_streams`` and the draws after it) and prints,
beside the card's name and power limit:

  k4         on (a), (b) and (c): K4 on the cells K1-K3 give it (the tree's
             own wrappers), by CUDA events (median of 20 single launches)
             and on the card (torch.profiler, mean of 5; "not measured"
             where a process's profiler sees no device time), beside the
             bytes it must move at 3.35 TB/s
  oneshot    on (f)-(i): the one-shot program by CUDA events (median of 25
             after 3) and on the card (profiler), its phases (timer
             stamps, median of 5), K1's chain floor (the longest lane's
             2-bit chunks x 40 cycles at the maximum SM clock), and the
             four-kernel program on the same staged stream by events
  k1         k1_scan2 on (a), (b), (d) and (f)-(i) (the four-kernel
             program's K1 on the one-shot streams) and k1_scan2_c01 on
             chip_smoke.py's two batches (the five small streams drawn
             after (a)-(i), and (f), (g) and the book2-sized one):
             by events (median of 20 single launches) and on the card
             (profiler, mean a launch), beside the chain floor (the longest
             lane's 2-bit chunks x 40 cycles at the maximum SM clock) and,
             where the tree has ``k1_plan``, its plan; and
             ``wide_decode_program`` on (a) and (b) by events (median of 25
             after 3)
  k1main     k1_main on the indexed (a) at 512 symbols a block, (b) at 1024
             and (i) at 512 (chip_smoke.py's INDEXED): by events and on the
             card, beside the chain floor and, where the tree has
             ``k1_main_plan``, its plan (another block size is timed as a
             variant tree, ``_parent/<name>``, the same way)
  k2         K2 on the exit maps K1 gives it on (a)-(d) and on both
             batches (the batch's last-lane rows zeroed, as the batch
             program does): by events, and on the card the time a call and
             the kernel launches a call (profiler over every K2 kernel
             name, the three-launch design's too; "not measured" where no
             session's record was whole)
  md1        k1_scan and k3_fix (md = 1) on (c) and on this checkout's
             probes.streams.K1P_CASES (K3' on the cuts K1', K2 and
             fix_rows give, or the case's own): by events and on the card,
             beside each one's chain floor (K1': the longest lane's bits to
             row steps, K3': the longest cut's bits, x 40 cycles at the
             maximum SM clock) and, where the tree has ``k1_scan_plan``,
             K1''s plan; and (c)'s ``wide_decode_program`` by events
             (median of 25 after 3)
  encode     E1 and E2 on the encoder's staging of (a), (b), (c) and
             (g)-(i) (E2 on E1's rows at the plan's ORP): by events and on
             the card, beside the bytes each must move at 3.35 TB/s and,
             where the tree has ``e1_plan``/``e2_plan``, their plans; and
             ``encode_program`` by events (median of 25 after 3) with its
             card time by kernel (E1, E2, E3 and the torch ops between),
             and the ``encode_lanes`` wall (host clock, staging included,
             median of chip_smoke's WALL_RUNS)

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
K4_RUNS = 20
RUNS, WARMUP = 25, 3
PHASE_RUNS = 5


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("tree", nargs="?", default=str(HERE))
    ap.add_argument("--tag", default="tree")
    ap.add_argument("--sections",
                    default="k4,oneshot,k1,k1main,k2,md1,encode")
    args = ap.parse_args()
    sections = args.sections.split(",")
    tree = pathlib.Path(args.tree).resolve()
    sys.path[0] = str(tree)  # not this file's folder
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  HERE / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    import torch

    if not torch.cuda.is_available():
        print("oneshot_turns: no CUDA device", file=sys.stderr)
        return 1
    from huffmandecoderongpus_tpu_torch.harness.timing import event_ms
    from huffmandecoderongpus_tpu_torch.huffio import encode_bytes
    from huffmandecoderongpus_tpu_torch.ops import _build, k2_compose, oneshot
    from huffmandecoderongpus_tpu_torch.ops import widescan as ws
    from huffmandecoderongpus_tpu_torch.ops.k4_compact import k4_compact

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
    dev = torch.device("cuda")
    rng = np.random.default_rng(cs.SEED)
    streams = cs.draw_streams(rng)
    out = {"tag": args.tag, "tree": str(tree), "card": card,
           "clocks_max_sm_mhz": float(mhz)}

    for k in "abc" if "k4" in sections else "":
        hf = encode_bytes(streams[k][1])
        st = ws.stage_widescan_inputs(hf, device=dev)
        a = ws.program_args(st)
        ORP = a.pop("ORP")
        kw = {x: a[x] for x in ("H", "steps_p", "SEG", "md", "chunk2", "C0",
                                "C1", "NS")}
        wmat, sym, val, cntmap, exmap, mrowmap = ws.stage_k1(
            st["words"], st["tab"], st["lim"], B=a["B"], steps=a["steps"],
            **kw)
        entry, _tot = k2_compose.k2_compose(exmap, 0)
        sym, val, _n, _total = ws.stage_k3(wmat, st["tab"], st["lim"],
                                           entry, cntmap, mrowmap, sym, val,
                                           **kw)

        def fn(sym=sym, val=val, ORP=ORP):
            return k4_compact(sym, val, ORP=ORP)

        ev = statistics.median(event_ms(fn, K4_RUNS, warmup=2))
        card_ms = cs.device_breakdown(torch, fn, per_launch=True).get(
            "k4_compact")
        moved = sym.numel() * 5 + sym.shape[1] * ORP  # sym + val, the rows
        bound = moved / cs.HBM_BYTES_PER_S * 1e3
        out[f"k4_{k}"] = dict(G=sym.shape[1], cells=sym.shape[0], ORP=ORP,
                              events_ms=ev, card_ms=card_ms, bound_ms=bound)
        own = ("not measured" if card_ms is None else
               f"{card_ms:.4f} ms, {card_ms / bound:.1f} times the bound")
        print(f"[k4] {args.tag} ({k}): events {ev:.4f} ms, card {own}, "
              f"bound {bound:.6f} ms ({moved} bytes); G={sym.shape[1]} "
              f"cells {sym.shape[0]} ORP={ORP}; card {card}", flush=True)

    for k in "fghi" if "oneshot" in sections else "":
        hf = encode_bytes(streams[k][1])
        st = ws.stage_widescan_inputs(hf, device=dev)
        p = st["plan"]
        args1 = (st["words"], st["tab"], st["lim"])
        kw1, kw4 = oneshot.program_args(st), ws.program_args(st)

        def one(kw1=kw1, args1=args1):
            return oneshot.oneshot_program(*args1, **kw1)

        def four(kw4=kw4, args1=args1):
            return ws.wide_decode_program(*args1, **kw4)

        ev1 = statistics.median(event_ms(one, WARMUP + RUNS)[WARMUP:])
        ev4 = statistics.median(event_ms(four, WARMUP + RUNS)[WARMUP:])
        card_ms = cs.device_breakdown(torch, one, per_launch=True).get(
            "oneshot")
        splits = [oneshot.phase_ms(*args1, **kw1) for _ in range(PHASE_RUNS)]
        phases = {ph: statistics.median(sp[ph] for sp in splits)
                  for ph in oneshot.PHASES}
        chunks = min(int(st["lim"].max()), p["steps_p"]) // 2
        floor = chunks * cs.CHAIN_CYCLES_A_ROW / clock * 1e3
        out[f"oneshot_{k}"] = dict(G=p["G"], B=p["B"], H=st["H"],
                                   md=st["md"], events_ms=ev1,
                                   card_ms=card_ms, phases_ms=phases,
                                   k1_floor_ms=floor, four_kernel_ms=ev4)
        own = "not measured" if card_ms is None else f"{card_ms:.4f} ms"
        print(f"[oneshot] {args.tag} ({k}): events {ev1:.4f} ms, card "
              f"{own}; phases "
              + "  ".join(f"{ph} {v:.4f}" for ph, v in phases.items())
              + f"; K1 floor {floor:.4f} ms; four-kernel program {ev4:.4f} "
              f"ms (events); G={p['G']} B={p['B']} H={st['H']} "
              f"md={st['md']}; card {card}", flush=True)
    # the batches, drawn after (a)-(i) as chip_smoke.py draws them
    small = [cs.text_like(rng, cs.PAPER1_BYTES, n) for n in cs.BATCH_SYMBOLS]
    trio = [streams["f"][1], streams["g"][1],
            cs.text_like(rng, cs.BOOK2_BYTES)]
    if "k1" in sections:
        k1_section(torch, cs, out, streams, small, trio, dev, card, clock,
                   args.tag)
    if "k1main" in sections:
        k1main_section(torch, cs, out, streams, dev, card, clock, args.tag)
    if "k2" in sections:
        k2_section(torch, cs, out, streams, small, trio, dev, card, args.tag)
    if "md1" in sections:
        md1_section(torch, cs, out, streams, dev, card, clock, args.tag)
    if "encode" in sections:
        encode_section(torch, cs, out, streams, dev, card, args.tag)
    print(json.dumps(out))
    return 0


def k1_section(torch, cs, out, streams, small, trio, dev, card, clock,
               tag):
    """The k1 section: both K1 kernels and the four-kernel program."""
    from huffmandecoderongpus_tpu_torch.harness.timing import event_ms
    from huffmandecoderongpus_tpu_torch.huffio import encode_bytes
    from huffmandecoderongpus_tpu_torch.ops import (
        _build,
        batch,
        k1_scan2,
        k1_scan2_c01,
    )
    from huffmandecoderongpus_tpu_torch.ops import widescan as ws

    def one(key, kname, fn, lim, kw):
        ev = statistics.median(event_ms(fn, K4_RUNS, warmup=2))
        card_ms = cs.device_breakdown(torch, fn, per_launch=True).get(kname)
        chunks = min(int(lim.max()), kw["steps_p"]) // 2
        floor = chunks * cs.CHAIN_CYCLES_A_ROW / clock * 1e3
        plan = getattr(k1_scan2, "k1_plan", None)
        plan = plan and plan(lim.shape[0], kw["H"], kw["md"], kw["SEG"],
                             kw["steps_p"], kw.get("NS", 1),
                             _build.sm_count(dev))
        out[key] = dict(G=lim.shape[0], H=kw["H"], md=kw["md"],
                        events_ms=ev, card_ms=card_ms, floor_ms=floor,
                        plan=plan and {k: plan[k] for k in (
                            "T", "lanes", "blocks", "waves", "shared")})
        own = ("not measured" if card_ms is None else
               f"{card_ms:.4f} ms, {card_ms / floor:.1f} times the floor")
        print(f"[k1] {tag} {key}: events {ev:.4f} ms, card {own}; floor "
              f"{floor:.4f} ms ({chunks} chunks); plan {out[key]['plan']}; "
              f"G={lim.shape[0]} H={kw['H']} md={kw['md']}; card {card}",
              flush=True)

    for k in "abdfghi":
        st = ws.stage_widescan_inputs(encode_bytes(streams[k][1]),
                                      device=dev)
        p = st["plan"]
        wmat = ws.words_matrix(st["words"], -(-p["steps_p"] // 32))
        kw = dict(B=p["B"], H=st["H"], steps=p["steps"],
                  steps_p=p["steps_p"], SEG=p["SEG"], md=st["md"],
                  C0=st["C0"], C1=st["C1"], NS=st["NS"])
        one(f"k1_scan2_{k}", "k1_scan2",
            lambda wmat=wmat, st=st, kw=kw: k1_scan2.k1_scan2(
                wmat, st["tab"], st["lim"], **kw), st["lim"], kw)
        if k in "ab":
            args1 = (st["words"], st["tab"], st["lim"])
            a4 = ws.program_args(st)
            ts = event_ms(lambda: ws.wide_decode_program(*args1, **a4),
                          WARMUP + RUNS)[WARMUP:]
            out[f"program_{k}"] = dict(events_ms=statistics.median(ts))
            print(f"[k1] {tag} program_{k}: wide_decode_program events "
                  f"{statistics.median(ts):.4f} ms (min {min(ts):.4f}); "
                  f"card {card}", flush=True)
    for key, raws in (("five", small), ("trio", trio)):
        st = batch.stage_batch_inputs([encode_bytes(r) for r in raws],
                                      device=dev)
        p = st["plan"]
        wmat = ws.words_matrix(st["words"], -(-p["steps_p"] // 32))
        kw = dict(B=p["B"], H=st["H"], steps=p["steps"],
                  steps_p=p["steps_p"], SEG=p["SEG"], md=st["md"])
        one(f"k1_scan2_c01_{key}", "k1_scan2_c01",
            lambda st=st, wmat=wmat, kw=kw: k1_scan2_c01.k1_scan2_c01(
                wmat, st["tabs"], st["lim"], st["c01"], st["bstream"], **kw),
            st["lim"], kw)


def k1main_section(torch, cs, out, streams, dev, card, clock, tag):
    """The k1main section: k1_main on the indexed streams."""
    from huffmandecoderongpus_tpu_torch.harness.timing import event_ms
    from huffmandecoderongpus_tpu_torch.huffio import encode_bytes
    from huffmandecoderongpus_tpu_torch.ops import _build, k1_main
    from huffmandecoderongpus_tpu_torch.ops import widescan as ws

    plan_fn = getattr(k1_main, "k1_main_plan", None)
    for k, K in cs.INDEXED.items():
        hf = encode_bytes(streams[k][1], block_symbols=K)
        st = ws.stage_widescan_indexed(hf, *hf.index, device=dev)
        p = st["plan"]
        wmat = ws.normalize_lane_words(st["raw"], st["sh"]).t().contiguous()
        kw = dict(steps_p=p["steps_p"], md=st["md"], C0=st["C0"],
                  C1=st["C1"], NS=st["NS"])

        def fn(wmat=wmat, st=st, kw=kw):
            return k1_main.k1_main(wmat, st["tab"], st["lim"], **kw)

        G = p["G"]
        chunks = min(int(st["lim"].max()), p["steps_p"]) // 2
        floor = chunks * cs.CHAIN_CYCLES_A_ROW / clock * 1e3
        plan = plan_fn and plan_fn(G, st["md"], st["NS"], p["steps_p"],
                                   _build.sm_count(dev))
        ev = statistics.median(event_ms(fn, K4_RUNS, warmup=2))
        card_ms = cs.device_breakdown(torch, fn, per_launch=True).get(
            "k1_main")
        key = f"k1_main_{k}"
        out[key] = dict(G=G, md=st["md"], NS=st["NS"],
                        steps_p=p["steps_p"], events_ms=ev, card_ms=card_ms,
                        floor_ms=floor,
                        plan=plan and {x: plan[x] for x in (
                            "threads", "blocks", "waves", "shared")})
        own = ("not measured" if card_ms is None else
               f"{card_ms:.4f} ms, {card_ms / floor:.1f} times the floor")
        print(f"[k1] {tag} {key} ({K} symbols a block): events {ev:.4f} ms, "
              f"card {own}; floor {floor:.4f} ms ({chunks} chunks); plan "
              f"{out[key]['plan']}; G={G} md={st['md']} NS={st['NS']} steps_p={p['steps_p']}; "
              f"card {card}", flush=True)


def md1_section(torch, cs, out, streams, dev, card, clock, tag):
    """The md1 section: K1' and K3' on (c) and on the K1P cases, and (c)'s
    program.  The cases come from this checkout's ``probes/streams.py``
    (a parent tree may not have them), staged by the tree's own code."""
    from huffmandecoderongpus_tpu_torch.harness.timing import event_ms
    from huffmandecoderongpus_tpu_torch.huffio import encode_bytes
    from huffmandecoderongpus_tpu_torch.ops import _build, k1_scan, k3_fix
    from huffmandecoderongpus_tpu_torch.ops import widescan as ws

    spec = importlib.util.spec_from_file_location(
        "k1p_streams",
        HERE / "huffmandecoderongpus_tpu_torch" / "probes" / "streams.py")
    ps = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ps)
    st = ws.stage_widescan_inputs(encode_bytes(streams["c"][1]), device=dev)
    p = st["plan"]
    wmat = ws.words_matrix(st["words"], -(-p["steps_p"] // 32))
    kw = dict(B=p["B"], H=st["H"], steps=p["steps"], steps_p=p["steps_p"],
              SEG=p["SEG"], md=st["md"], NS=st["NS"])
    cases = [("c", (wmat, st["tab"], st["lim"]), kw, None)]
    for case in ps.K1P_CASES:
        inputs, kwc, cuts, _hf = ps.k1p_case(case, dev)
        cases.append((case, inputs, kwc, cuts))
    plan_fn = getattr(k1_scan, "k1_scan_plan", None)
    for key, inputs, kw, cuts in cases:
        wmat, tab, lim = inputs
        ent, cut, cut_slot, sym, val = ps.k3p_inputs(inputs, kw, cuts)
        k3kw = dict(steps_p=kw["steps_p"], SEG=kw["SEG"], md=1, NS=kw["NS"])

        def k1(inputs=inputs, kw=kw):
            return k1_scan.k1_scan(*inputs, **kw)

        def k3(wmat=wmat, tab=tab, ent=ent, cut=cut, cut_slot=cut_slot,
               sym=sym, val=val, k3kw=k3kw):
            return k3_fix.k3_fix(wmat, tab, ent, cut, cut_slot, sym, val,
                                 **k3kw)

        row = dict(G=lim.shape[0], H=kw["H"], NS=kw["NS"],
                   steps_p=kw["steps_p"])
        bits = max(min(int(lim.max()), kw["steps"]), 0)
        longest = int(cut.clamp(0, kw["steps_p"]).max())
        for name, fn, n in (("k1_scan", k1, bits), ("k3_fix", k3, longest)):
            ev = statistics.median(event_ms(fn, K4_RUNS, warmup=2))
            card_ms = cs.device_breakdown(torch, fn, per_launch=True).get(
                name)
            floor = n * cs.CHAIN_CYCLES_A_ROW / clock * 1e3
            row[name] = dict(events_ms=ev, card_ms=card_ms, floor_ms=floor,
                             floor_bits=n)
        plan = plan_fn and plan_fn(lim.shape[0], kw["H"], kw["steps_p"],
                                   kw["NS"], _build.sm_count(dev))
        row["plan"] = plan and {x: plan[x] for x in (
            "T", "lanes", "blocks", "waves", "shared")}
        out[f"md1_{key}"] = row

        def own(r):
            if r["card_ms"] is None:
                return "not measured"
            x = r["card_ms"] / r["floor_ms"] if r["floor_ms"] else 0.0
            return f"{r['card_ms']:.4f} ms, {x:.1f} times the floor"

        print(f"[md1] {tag} ({key}): k1_scan events "
              f"{row['k1_scan']['events_ms']:.4f} ms, card "
              f"{own(row['k1_scan'])} ({bits} bits); k3_fix events "
              f"{row['k3_fix']['events_ms']:.4f} ms, card "
              f"{own(row['k3_fix'])} (longest cut {longest} bits); plan "
              f"{row['plan']}; G={lim.shape[0]} H={kw['H']} NS={kw['NS']}; "
              f"card {card}", flush=True)
    args1 = (st["words"], st["tab"], st["lim"])
    a4 = ws.program_args(st)
    ts = event_ms(lambda: ws.wide_decode_program(*args1, **a4),
                  WARMUP + RUNS)[WARMUP:]
    out["program_c"] = dict(events_ms=statistics.median(ts))
    print(f"[md1] {tag} program_c: wide_decode_program events "
          f"{statistics.median(ts):.4f} ms (min {min(ts):.4f}); card {card}",
          flush=True)


def encode_section(torch, cs, out, streams, dev, card, tag):
    """The encode section: E1 and E2 on (a)-(c) and (g)-(i), and the
    encode program."""
    from huffmandecoderongpus_tpu_torch.harness.timing import event_ms
    from huffmandecoderongpus_tpu_torch.ops import (
        _build,
        e1_pack,
        e2_compact,
        encode,
    )

    sms = _build.sm_count(dev)
    for k in "abcghi":
        st = encode.stage_encode_inputs(streams[k][1], device=dev)
        p = st["plan"]
        args = (st["data3"], st["lo"], st["hi"], st["nval"])
        gran, gval, cnt, bits = e1_pack.e1_pack(*args)
        ORP = p["ORP"]
        plans = {
            "e1_pack": getattr(e1_pack, "e1_plan", None) and e1_pack.e1_plan(
                p["G"], p["K"], sms, st["data3"].data_ptr()),
            "e2_compact": getattr(e2_compact, "e2_plan", None)
            and e2_compact.e2_plan(p["G"], 2 * p["K"], ORP, sms,
                                   gran.data_ptr(), gval.data_ptr())}
        runs = {"e1_pack": (lambda args=args: e1_pack.e1_pack(*args),
                            cs.nbytes(*args, gran, gval, cnt, bits)),
                "e2_compact": (
                    lambda gran=gran, gval=gval, ORP=ORP:
                    e2_compact.e2_compact(gran, gval, ORP=ORP),
                    cs.nbytes(gran, gval) + 4 * p["G"] * ORP)}
        row = dict(G=p["G"], K=p["K"], ORP=ORP)
        for name, (fn, moved) in runs.items():
            ev = statistics.median(event_ms(fn, K4_RUNS, warmup=2))
            card_ms = cs.device_breakdown(torch, fn, per_launch=True).get(
                name)
            bound = moved / cs.HBM_BYTES_PER_S * 1e3
            row[name] = dict(events_ms=ev, card_ms=card_ms, bound_ms=bound,
                             plan=plans[name])
            own = ("not measured" if card_ms is None else
                   f"{card_ms:.4f} ms, {card_ms / bound:.1f} times the bound")
            print(f"[encode] {tag} ({k}): {name} events {ev:.4f} ms, card "
                  f"{own}; bound {bound:.6f} ms ({moved} bytes); plan "
                  f"{plans[name]}; G={p['G']} K={p['K']} ORP={ORP}; card "
                  f"{card}", flush=True)

        def program(args=args, p=p):
            return encode.encode_program(*args, ORP=p["ORP"],
                                         NROWS=p["NROWS"])

        ts = event_ms(program, WARMUP + RUNS)[WARMUP:]
        split = cs.device_breakdown(torch, program)
        wall, wall_min = cs.wall_ms(
            torch, lambda raw=streams[k][1]: encode.encode_lanes(
                raw, device=dev))
        row["program"] = dict(events_ms=statistics.median(ts),
                              min_ms=min(ts), card_ms=split)
        row["encode_lanes_wall_ms"] = dict(median=wall, min=wall_min)
        out[f"encode_{k}"] = row
        print(f"[encode] {tag} ({k}): encode_program events "
              f"{statistics.median(ts):.4f} ms (min {min(ts):.4f}); card ms "
              "a program " + "  ".join(f"{n} {v:.4f}"
                                       for n, v in split.items())
              + f"; encode_lanes wall {wall:.4f} ms (min {wall_min:.4f}, "
              f"{cs.WALL_RUNS} runs); card {card}", flush=True)


#: K2's kernel names: this design's one, and the three-launch design's
K2_KERNELS = ("k2_compose_kernel", "k2_groups", "k2_scan", "k2_apply")


def k2_section(torch, cs, out, streams, small, trio, dev, card, tag):
    """The k2 section: K2 on the exit maps of (a)-(d) and both batches."""
    from huffmandecoderongpus_tpu_torch.harness.timing import event_ms
    from huffmandecoderongpus_tpu_torch.huffio import encode_bytes
    from huffmandecoderongpus_tpu_torch.ops import (
        batch,
        k1_scan2_c01,
        k2_compose,
    )
    from huffmandecoderongpus_tpu_torch.ops import widescan as ws

    cases = []
    for k in "abcd":
        st = ws.stage_widescan_inputs(encode_bytes(streams[k][1]),
                                      device=dev)
        a = ws.program_args(st)
        kw = {x: a[x] for x in ("H", "steps_p", "SEG", "md", "chunk2", "C0",
                                "C1", "NS")}
        exmap = ws.stage_k1(st["words"], st["tab"], st["lim"], B=a["B"],
                            steps=a["steps"], **kw)[4]
        cases.append((k, exmap))
    for key, raws in (("five", small), ("trio", trio)):
        st = batch.stage_batch_inputs([encode_bytes(r) for r in raws],
                                      device=dev)
        p = st["plan"]
        wmat = ws.words_matrix(st["words"], -(-p["steps_p"] // 32))
        exmap = k1_scan2_c01.k1_scan2_c01(
            wmat, st["tabs"], st["lim"], st["c01"], st["bstream"], B=p["B"],
            H=st["H"], steps=p["steps"], steps_p=p["steps_p"], SEG=p["SEG"],
            md=st["md"])[3]
        exmap[:, list(st["last_live"])] = 0
        cases.append((key, exmap))
    for k, exmap in cases:
        def fn(exmap=exmap):
            return k2_compose.k2_compose(exmap, 0)

        ev = statistics.median(event_ms(fn, K4_RUNS, warmup=2))
        times, launches = cs.device_breakdown(
            torch, fn, per_launch=True, counts=True,
            symbols={"k2": K2_KERNELS})
        per_call = launches.get("k2")
        card_ms = per_call and times["k2"] * per_call
        HP, G = exmap.shape
        out[f"k2_{k}"] = dict(G=G, HP=HP, events_ms=ev, card_ms=card_ms,
                              kernels_a_call=per_call)
        own = "not measured" if card_ms is None else f"{card_ms:.4f} ms"
        print(f"[k2] {tag} ({k}): events {ev:.4f} ms, card {own} in "
              f"{per_call} kernel launches a call; G={G} HP={HP}; card "
              f"{card}", flush=True)


if __name__ == "__main__":
    sys.exit(main())
