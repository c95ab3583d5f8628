"""Variants of the compaction kernel on (d), each built alone and timed in
turns within one process.

    python3 huffmandecoderongpus_tpu_torch/harness/compact_variants.py [--source FILE] [--rounds N] [NAME ...]

Needs one CUDA card and nvcc; imports nothing of JAX.  Takes ``csrc/
compact.cu`` of this checkout (or FILE, another design of the same
launcher), makes each variant by a text substitution, builds each into a
library of its own with ``ops/_build.py``'s flags, and times every one on
(d)'s compaction (``chip_smoke.py``'s stream (d): the dense pipeline's
lane scan, ``cumsum``, ``out_rows`` B // min code length + 2) by
``torch.profiler`` (mean a launch), the variants in turn, N rounds (2),
the order reversed every other round.  Variants:

  as-is       the source unchanged
  no-write    without its write-out of the chunk's ranks (ablation)
  no-zero     without its zero fill (ablation)
  neither     without both (ablation)
  regs-64     four blocks an SM (64 registers a thread)
  half-R      chunks of half as many rows
  rows-8      eight rows a thread a batch (where the source has batches)

Each line gives the card ms of every round, the registers, whether the
output equals ``compact_ref`` (on a poisoned output; an ablation is not),
and the kernel's own count (``compact.STATS``) of blocks whose rank union
is wider than two chunks, with their share of the blocks' cycles.  The
last line is one JSON object of every number.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import pathlib
import re
import subprocess
import sys
import tempfile

HERE = pathlib.Path(__file__).resolve().parents[2]

#: name -> [(pattern, replacement)] on the source
VARIANTS = {
    "as-is": [],
    "no-write": [(r"for \(int o = lo \+ rg; o < hi;",
                  "for (int o = lo + rg; o < min(hi, lo);")],
    "no-zero": [(r"for \(;( mine &&)? o < z1;", r"for (;\1 o < min(z1, 0);")],
    "neither": [(r"for \(int o = lo \+ rg; o < hi;",
                 "for (int o = lo + rg; o < min(hi, lo);"),
                (r"for \(;( mine &&)? o < z1;", r"for (;\1 o < min(z1, 0);")],
    "regs-64": [(r"__launch_bounds__\(THREADS, \d\)",
                 "__launch_bounds__(THREADS, 4)")],
    "half-R": [(r"constexpr int R = (\d+);",
                lambda m: f"constexpr int R = {int(m.group(1)) // 2};")],
    "rows-8": [(r"constexpr int RS = 4;", "constexpr int RS = 8;")],
}


def variant(src: str, name: str) -> str | None:
    """``src`` with ``name``'s substitutions, or None where one finds no
    match."""
    for pattern, repl in VARIANTS[name]:
        src, n = re.subn(pattern, repl, src)
        if not n:
            return None
    return src


def constant(src: str, name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--source", default=str(
        HERE / "huffmandecoderongpus_tpu_torch/csrc/compact.cu"))
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("names", nargs="*", default=list(VARIANTS))
    args = ap.parse_args()
    sys.path[0] = str(HERE)
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  HERE / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("compact_variants: no CUDA device", file=sys.stderr)
        return 1
    from huffmandecoderongpus_tpu_torch.huffio import encode_bytes
    from huffmandecoderongpus_tpu_torch.ops import _build, compact, lane_scan
    from huffmandecoderongpus_tpu_torch.probes._timing import card

    dev = torch.device("cuda")
    base = pathlib.Path(args.source).read_text()
    srcs = {n: s for n in args.names if (s := variant(base, n)) is not None}
    work = pathlib.Path(tempfile.mkdtemp(prefix="compact_variants_"))
    builds = {}
    for name, src in srcs.items():
        cu = work / f"{name}.cu"
        cu.write_text(src)
        builds[name] = subprocess.Popen(
            [_build.nvcc(), *_build.NVCC_FLAGS, "-shared", "-o",
             str(work / f"lib{name}.so"), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs, regs = {}, {}
    for name, proc in builds.items():
        log = proc.communicate()[0]
        if proc.returncode:
            print(log[-3000:], file=sys.stderr)
            return 1
        regs[name] = [int(r) for r in re.findall(r"Used (\d+) registers",
                                                 log)]
        lib = ctypes.CDLL(str(work / f"lib{name}.so"))
        lib.ws_compact.argtypes = _build._SIGNATURES["ws_compact"]
        lib.ws_compact.restype = ctypes.c_int
        libs[name] = lib

    rng = np.random.default_rng(cs.SEED)
    sd, entry, out_rows = cs.dense_staging(
        torch, encode_bytes(cs.draw_streams(rng)["d"][1]), dev)
    sym, valid = lane_scan.lane_scan(sd["bits"], sd["tab"], entry, B=sd["B"],
                                     H=sd["H"], N=sd["N"])
    cum = torch.cumsum(valid, 0, dtype=torch.int32)
    steps, G = cum.shape
    want = compact.compact_ref(cum, sym, out_rows=out_rows)
    stream = _build.stream_ptr(cum)

    def call(name, out, stats=None):
        src = srcs[name]
        W, R = constant(src, "W"), constant(src, "R")
        tiles, chunks = -(-G // W), max(1, -(-steps // R))
        rc = libs[name].ws_compact(
            cum.data_ptr(), sym.data_ptr(), out.data_ptr(),
            None if stats is None else stats.data_ptr(), steps, G, out_rows,
            W, R, 4, constant(src, "THREADS"), R * W + 3 * W * 4, tiles,
            chunks, -(-out_rows // chunks), stream)
        if rc:
            raise RuntimeError(f"{name}: the launcher refused ({rc})")
        return out

    ms = {n: [] for n in srcs}
    for rnd in range(args.rounds):
        for name in (list(srcs) if rnd % 2 == 0 else list(srcs)[::-1]):
            out = torch.empty((out_rows, G), dtype=torch.uint8, device=dev)
            ms[name].append(cs.device_breakdown(
                torch, lambda name=name, out=out: call(name, out),
                per_launch=True,
                symbols={"compact": ("lanedfa_compact_kernel",)}).get(
                    "compact"))
    where = card(dev)
    result = {"source": args.source, "card": where, "steps": steps, "G": G,
              "out_rows": out_rows}
    for name in srcs:
        stats = torch.zeros(len(compact.STATS), dtype=torch.int64,
                            device=dev)
        out = torch.full((out_rows, G), 0xEE, dtype=torch.uint8, device=dev)
        exact = torch.equal(call(name, out, stats), want)
        st = dict(zip(compact.STATS, stats.tolist()))
        share = st["wide_cycles"] / max(st["cycles"], 1)
        result[name] = dict(card_ms=ms[name], registers=regs[name],
                            exact=exact, **st)
        print(f"[variant] {name}: card ms "
              + " ".join("not measured" if m is None else f"{m:.5f}"
                         for m in ms[name])
              + f"; registers {regs[name]}; equal to compact_ref {exact}; "
              f"{st['wide_blocks']} wide-union blocks, {share:.3f} of the "
              f"cycles; (d) steps {steps} G {G} out_rows {out_rows}; card "
              f"{where}", flush=True)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
