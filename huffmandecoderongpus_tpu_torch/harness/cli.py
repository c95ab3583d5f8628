"""Command line of the port: the reference's test suites and the codec's
commands.

    python -m huffmandecoderongpus_tpu_torch [SUITE] [--repeats N]
        [--device cpu]
    python -m huffmandecoderongpus_tpu_torch encode x.bin [x.huff] [--index K]
    python -m huffmandecoderongpus_tpu_torch decode x.huff [out.bin]
        [--decoder NAME] [--verify RAW [--repeats N]]
    python -m huffmandecoderongpus_tpu_torch verify x.huff x.bin
        [--decoder NAME]
    python -m huffmandecoderongpus_tpu_torch info [CORPUS|x.huff ...]
    python -m huffmandecoderongpus_tpu_torch bits [CORPUS|x.huff] [COUNT]
    python -m huffmandecoderongpus_tpu_torch corpora
    python -m huffmandecoderongpus_tpu_torch decoders
    python -m huffmandecoderongpus_tpu_torch prof x.huff
        [widescan|lanedfa|speculative] [--lanes G]
    python -m huffmandecoderongpus_tpu_torch probe
        dispatch|k1fixed|k4|gather|vpu|vpu2
    python -m huffmandecoderongpus_tpu_torch scaling [CORPUS]
        [lane|wide|block] [--shards N] [--repeats N]

The suites are the JAX package's, which keep mainrun.c's names
(mainrun.c:512-636): ``default hello peskjv peshello bigtable
quickgraph1-3 graph1-4 kjvprof opt bts testall kjv batch`` (default:
``default``).  Each loads the same corpora (``data``: ``HUFF_FILES_DIR``)
and prints the same rows in the same order (``evaluate.evalandshow``: a
checked run, then the minimum of ``--repeats`` timed runs); the device
rows are ``spec_xla``, ``lane_dfa_pallas`` and ``lane_wide`` on
``--device``, ``batch`` decodes paper1, news and book2 in one
``decode_widescan_batch`` program, and the serial rows run on the host.

``encode`` compresses a file with the lane-parallel encoder
(``ops.encode.encode_lanes``) into ``x.huff`` (default: the input's name
plus ``.huff``), with ``--index K`` also a ``.huffidx`` sidecar of every
K-th symbol's bit offset, and prints a summary line.  ``decode`` reads the
file and its verified sidecar, decodes with ``--decoder`` (default
``lane_wide``; ``lane_dfa`` decodes through a sidecar) and writes the
decoded bytes (to stdout without an output path); with ``--verify RAW`` it
instead prints ``evalandshow``'s row for the file against the raw file.
``verify`` byte-compares a decode with a raw file and prints ``OK``
(exit 1 and the differences otherwise).  ``info`` prints each corpus's (or
file's) header and tree height, ``bits`` its leading stream bits,
``corpora`` the corpora found and ``decoders`` the registry.  ``prof``
prints the stage breakdown of one decode of a `.huff` file
(``harness.profiling``: ``lanedfa`` by default, ``widescan`` or
``speculative``).  ``probe`` runs one of the hardware probes (``probes``):
on the card at its script's sizes, on the CPU at cut sizes.  ``scaling``
times a sharded decode of a corpus (default paper1; ``harness.scaling``:
the ``lane`` path by default, ``wide`` or ``block``) at 1, 2, 4, ...
shards: the visible cards, or with ``--shards N`` N virtual shards on
``--device`` (on the CPU one without it).

Every suite and command runs on the card unless ``--device cpu`` is given,
which runs the kernels' plain versions; ``--device cuda`` without a card
raises.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys

import numpy as np

from huffmandecoderongpus_tpu_torch import data as corpus
from huffmandecoderongpus_tpu_torch.harness.evaluate import (
    REPEATS,
    EvalResult,
    compare_uncompressed,
    evalandshow,
    evaluate,
)
from huffmandecoderongpus_tpu_torch.harness.timing import report_resolution
from huffmandecoderongpus_tpu_torch.harness.truncate import graphtest
from huffmandecoderongpus_tpu_torch.huffio import (
    HuffTree,
    index_path,
    read_huff,
    unpack_bits,
    write_huff,
    write_index,
)
from huffmandecoderongpus_tpu_torch.models import all_decoders, get_decoder
from huffmandecoderongpus_tpu_torch.ops.encode import encode_lanes
from huffmandecoderongpus_tpu_torch.ops.lanedfa_decode import require_device

SUITES = [
    "default", "hello", "peskjv", "peshello", "bigtable",
    "quickgraph1", "quickgraph2", "quickgraph3",
    "graph1", "graph2", "graph3", "graph4",
    "kjvprof", "opt", "bts", "testall",
    "kjv",  # the ACC driver's corpus suite (mainrunacc.c:406-409)
    "batch",  # small corpora in one batched device program
]
COMMANDS = ["encode", "decode", "verify", "info", "bits", "corpora",
            "decoders", "prof", "probe", "scaling"]
#: the corpora of the bigtable, bts and testall suites, in their order
BIGTABLE_NAMES = ("paper1", "hello", "news", "kjv.txt", "book2")


def _device_decoders(device) -> list:
    """The decoders filling the reference's opencl/fastgpu/fastgpuOpt1
    suite slots, on ``device``: the speculative pipeline and the optimized
    lane-DFA builds.  ``lane_dfa_sync`` stays out of the suites, as in the
    JAX package."""
    registry = all_decoders(device=device)
    return [registry[n] for n in ("spec_xla", "lane_dfa_pallas", "lane_wide")]


@dataclasses.dataclass(frozen=True)
class _Streams:
    """Several streams as one ``evaluate`` input: the batch suite's."""

    hfs: tuple

    @property
    def uncompressed_size(self) -> int:
        return sum(hf.uncompressed_size for hf in self.hfs)

    @property
    def payload_bytes(self) -> int:
        return sum(hf.payload_bytes for hf in self.hfs)


def run_suite(name: str, repeats: int = REPEATS, *,
              device) -> list[EvalResult]:
    """Run suite ``name``, its decoders on ``device`` (the host rows on the
    host), and return the results of the rows it printed, in order; raises
    SystemExit for an unknown name, DecodeMismatch for any row that decodes
    wrong."""
    device = str(require_device(device))
    load = corpus.load_test_data
    rows = []

    def dec(n):
        return get_decoder(n, device=device)

    def show(d, td, **kw):
        r = evalandshow(d, td, repeats=repeats, **kw)
        rows.append(r)
        return r

    def graph(d, td, incs):
        rows.extend(r for _size, r in graphtest(d, td, incs,
                                                repeats=repeats))

    if name == "default":
        # tree diagnostics of the hello corpus (mainrun.c:512-525)
        t = HuffTree(load("hello").cd.tree)
        print(t.format_codes())
        print(t.format_table())
        print(f" tablenodes : {t.size}")
        for b in (1, 2, 3, 4):
            print(f"tablegroups  {b} : {t.num_groups(b)} ")
        print(t.num_groups(4))
        return rows

    if name == "hello":
        hello = load("hello")
        show(dec("simple"), hello)
        for d in _device_decoders(device):
            show(d, hello)
        show(dec("pes_numpy"), hello)
        return rows

    if name in ("kjv", "kjvprof"):
        # kjv: the ACC driver's corpus suite (mainrunacc.c:406-409)
        td = load("kjv.txt")
        for d in _device_decoders(device):
            show(d, td)
        return rows

    if name in ("peskjv", "peshello"):
        td = load("kjv.txt" if name == "peskjv" else "hello")
        show(dec("pes_numpy"), td)
        return rows

    if name == "bigtable":
        # the headline benchmark (mainrun.c:541-588): the device decoders,
        # the numpy pipeline and the serial baselines on the 5 corpora
        tds = [load(n) for n in BIGTABLE_NAMES]
        for td in tds:
            print(td.info())
        decs = _device_decoders(device) + [
            dec("pes_numpy"), dec("simple"), dec("bigtable_multisym"),
            dec("bigtable_simple")]
        for d in decs:
            for td in tds:
                show(d, td)
        return rows

    if name.startswith("quickgraph") or name.startswith("graph"):
        quick = name.startswith("quickgraph")
        td = load("paper1" if quick else "kjv.txt")
        incs = 10000 if quick else 500000
        which = name[len("quickgraph" if quick else "graph"):]
        if which == "1":
            graph(dec("simple"), td, incs)
        elif which == "2":
            for d in _device_decoders(device):
                graph(d, td, incs)
        elif which == "3":
            graph(dec("bigtable_multisym"), td, incs)
        elif which == "4" and not quick:
            graph(dec("pes_numpy"), td, incs)
        else:
            raise SystemExit(f"unknown graph suite: {name}")
        return rows

    if name == "opt":
        # baseline against optimized device build (mainrun.c:617-623:
        # fastgpu against fastgpuOpt1): the speculative pipeline against
        # the lane-DFA decoders
        td = load("kjv.txt")
        base = show(dec("spec_xla"), td)
        best = None
        for n in ("lane_wide", "lane_dfa_pallas"):
            r = show(dec(n), td)
            if best is None or r.min_seconds < best.min_seconds:
                best = r
        print(f"opt: {best.decoder} is {base.min_seconds / best.min_seconds:.1f}x "
              f"the baseline spec_xla ({base.min_ms:.1f} ms -> "
              f"{best.min_ms:.1f} ms)")
        return rows

    if name == "bts":
        for n in BIGTABLE_NAMES:
            show(dec("bigtable_simple"), load(n))
        return rows

    if name == "batch":
        # the small corpora decoded by one batched device program
        # (ops/batch.py), which pays the per-program floor once
        from huffmandecoderongpus_tpu_torch.ops.batch import (
            decode_widescan_batch,
        )

        tds = [load(n) for n in ("paper1", "news", "book2")]

        def batch(streams, _param=None):
            # auto_split=False: the suite times and verifies the one
            # batched program; each output is checked against its header
            return np.concatenate(decode_widescan_batch(
                list(streams.hfs), device=device, auto_split=False))

        r = evaluate(batch, corpus.TestData(
            name="+".join(td.name for td in tds),
            cd=_Streams(tuple(td.cd for td in tds)),
            ucd=np.concatenate([td.ucd for td in tds])), repeats=repeats)
        rows.append(r)
        for td in tds:
            print(f"  batch {td.name}: OK ({td.ucd.size} bytes)")
        print(f"batched {len(tds)} streams: {r.min_ms:.3f} ms wall  "
              f"{r.gb_per_s:.2f} GB/s aggregate "
              f"(min of {len(r.times)}, incl. host staging/trim)")
        return rows

    if name == "testall":
        # mainrun.c:443-461: the floor, the serial baselines and the
        # jumpbits sweeps
        for cname in BIGTABLE_NAMES:
            td = load(cname)
            show(dec("justreaddata"), td, withcheck=False)
            show(dec("simple"), td)
            show(dec("bigtable_v1"), td)
            show(dec("bigtable_multisym"), td)
            for k in range(1, 15):
                show(dec("jumptable"), td, param=k)
            for k in range(1, 15):
                show(dec("lin"), td, param=k)
        return rows

    raise SystemExit(f"unknown test: {name} (suites: {' '.join(SUITES)})")


def encode(src: str, dst: str | None, index: int | None, device) -> None:
    """Encode file ``src`` into ``dst`` (and its sidecar with ``index``)."""
    dst = dst or src + ".huff"
    raw = np.fromfile(src, dtype=np.uint8)
    hf = encode_lanes(raw, device=device, block_symbols=index or None)
    write_huff(dst, hf)
    if hf.index is not None:
        write_index(index_path(dst), *hf.index, bits=hf.bits,
                    uncompressed_size=hf.uncompressed_size,
                    payload=hf.payload)
    ratio = hf.file_bytes() / max(raw.size, 1)
    print(f"{src}: {raw.size} -> {hf.file_bytes()} bytes "
          f"({ratio:.3f}), {hf.nodes} nodes, {hf.bits} bits"
          + (f", index every {hf.index[1]} symbols" if hf.index else ""))


def prof(src: str, which: str, lanes, device) -> dict:
    """Print and return the stage breakdown of ``which`` ("widescan",
    "lanedfa" or "speculative") decoding the `.huff` file ``src``;
    ``lanes`` is not the speculative pipeline's to set."""
    from huffmandecoderongpus_tpu_torch.harness import profiling

    fns = {"widescan": profiling.profile_widescan,
           "lanedfa": profiling.profile_lanedfa,
           "speculative": profiling.profile_speculative}
    if which not in fns:
        raise SystemExit(f"prof: no breakdown {which!r}; one of "
                         f"{sorted(fns)}")
    kw = {} if which == "speculative" else dict(lanes=lanes)
    report = fns[which](read_huff(src), device=device, **kw)
    print(f"{which} stage breakdown on {src}:")
    print(profiling.format_report(report))
    return report


def scaling(name: str, path: str, repeats: int, shards, device) -> list:
    """The ``scaling`` command: the sweep's table for corpus ``name``, over
    ``shards`` virtual shards on ``device``, or the visible cards."""
    from huffmandecoderongpus_tpu_torch.harness.scaling import (
        format_sweep,
        scaling_sweep,
    )

    dev = require_device(device)
    if shards is not None:
        devices = [dev] * shards
    else:
        devices = None if dev.type == "cuda" else [dev]
    td = corpus.load_test_data(name)
    points = scaling_sweep(td.cd, td.ucd, repeats=repeats, path=path,
                           devices=devices)
    print(f"scaling sweep on {name} ({path} path):")
    print(format_sweep(points))
    return points


def _huff(name: str):
    """A `.huff` path, or a corpus name of ``data``."""
    return read_huff(name) if name.endswith(".huff") else corpus.load_huff(name)


def _need(args, n: int, usage: str) -> None:
    if len(args) < n:
        raise SystemExit(f"usage: {usage}")


def main(argv=None) -> None:
    p = argparse.ArgumentParser(
        prog="huffmandecoderongpus_tpu_torch",
        description="PyTorch/CUDA lane-parallel Huffman codec: the "
                    "reference's benchmark suites and the codec's commands")
    p.add_argument("test", nargs="?", default="default",
                   help=f"suite ({' '.join(SUITES)}) or command "
                        f"({' '.join(COMMANDS)}); default: default")
    p.add_argument("args", nargs="*",
                   help="encode: <input> [output.huff]; "
                        "decode: <input.huff> [output]; "
                        "verify: <input.huff> <raw-file>; "
                        "info: [corpus|x.huff ...]; "
                        "bits: [corpus|x.huff] [count]; "
                        "prof: <input.huff> "
                        "[widescan|lanedfa|speculative]; "
                        "probe: <name>; "
                        "scaling: [corpus] [lane|wide|block]")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default cuda; cpu runs the "
                        "kernels' plain versions)")
    p.add_argument("--repeats", type=int, default=REPEATS,
                   help="suites and decode --verify: timed runs per row "
                        f"after the checked one (default {REPEATS})")
    p.add_argument("--decoder", default="lane_wide",
                   help="decode, verify: the registry's decoder (default "
                        "lane_wide)")
    p.add_argument("--index", type=int, metavar="K", default=None,
                   help="encode: also write a .huffidx sidecar every K "
                        "symbols")
    p.add_argument("--verify", metavar="RAW", default=None,
                   help="decode: compare with this raw file, then time it")
    p.add_argument("--lanes", type=int, metavar="G", default=None,
                   help="prof: the lane count (default: the decoder's plan)")
    p.add_argument("--shards", type=int, metavar="N", default=None,
                   help="scaling: N virtual shards on --device (default: "
                        "the visible cards; one on the CPU)")
    ns = p.parse_args(argv)
    args = ns.args

    if ns.test == "encode":
        _need(args, 1, "encode <input> [output.huff] [--index K]")
        encode(args[0], args[1] if len(args) > 1 else None, ns.index,
               ns.device)
        return

    if ns.test == "decode":
        _need(args, 1, "decode <input.huff> [output]")
        src = args[0]
        hf = read_huff(src)
        dec = get_decoder(ns.decoder, device=ns.device)
        if ns.verify:
            raw = np.fromfile(ns.verify, dtype=np.uint8)
            evalandshow(dec, corpus.TestData(name=src, cd=hf, ucd=raw),
                        repeats=ns.repeats)
            return
        out = np.asarray(dec(hf), dtype=np.uint8)
        if len(args) > 1:
            out.tofile(args[1])
            print(f"{src}: {hf.payload_bytes} -> {out.size} bytes -> "
                  f"{args[1]}")
        else:
            sys.stdout.buffer.write(out.tobytes())
        return

    if ns.test == "verify":
        # the evaluate() check as a command of its own
        _need(args, 2, "verify <input.huff> <raw-file>")
        hf = read_huff(args[0])
        want = np.fromfile(args[1], dtype=np.uint8)
        got = get_decoder(ns.decoder, device=ns.device)(hf)
        diffs = compare_uncompressed(got, want)
        print("OK" if diffs == 0 else f"FAILED: {diffs} differences")
        if diffs:
            raise SystemExit(1)
        return

    if ns.test == "info":
        for name in (args or corpus.available_corpora()):
            hf = _huff(name)
            t = HuffTree(hf.tree)
            print(f"{name}: nodes {hf.nodes}, bits {hf.bits}, "
                  f"uncompressedsize {hf.uncompressed_size}, height "
                  f"{t.height}, mindepth {t.min_depth}")
        return

    if ns.test == "bits":
        # leading stream bits, first bit first (showDataBits,
        # huffdata.c:280-288)
        hf = _huff(args[0] if args else "hello")
        count = int(args[1]) if len(args) > 1 else 64
        print("".join(str(int(b))
                      for b in unpack_bits(hf.payload, min(hf.bits, count))))
        return

    if ns.test == "corpora":
        for name in corpus.available_corpora():
            print(name)
        return

    if ns.test == "decoders":
        for name, d in sorted(all_decoders(device=ns.device).items()):
            print(f"{name:>20}  backend={d.backend}")
        return

    if ns.test == "prof":
        _need(args, 1, "prof <input.huff> [widescan|lanedfa|speculative]")
        prof(args[0], args[1] if len(args) > 1 else "lanedfa", ns.lanes,
             ns.device)
        return

    if ns.test == "probe":
        from huffmandecoderongpus_tpu_torch import probes

        _need(args, 1, "probe dispatch|k1fixed|k4|gather|vpu|vpu2")
        probes.run(args[0], ns.device)
        return

    if ns.test == "scaling":
        scaling(args[0] if args else "paper1",
                args[1] if len(args) > 1 else "lane", ns.repeats,
                ns.shards, ns.device)
        return

    print(f"running test: {ns.test}", file=sys.stderr)
    print(report_resolution(), file=sys.stderr)
    run_suite(ns.test, repeats=ns.repeats, device=ns.device)


if __name__ == "__main__":
    main()
