"""Command line of the port: the ``encode``, ``decode``, ``prof`` and
``probe`` commands.

    python -m huffmandecoderongpus_tpu_torch encode x.bin [x.huff] [--index K]
    python -m huffmandecoderongpus_tpu_torch decode x.huff [out.bin]
        [--decoder NAME]
    python -m huffmandecoderongpus_tpu_torch prof x.huff
        [widescan|lanedfa|speculative] [--lanes G]
    python -m huffmandecoderongpus_tpu_torch probe
        dispatch|k1fixed|k4|gather|vpu|vpu2

``encode`` compresses a file with the lane-parallel encoder
(``ops.encode.encode_lanes``) into ``x.huff`` (default: the input's name
plus ``.huff``), with ``--index K`` also a ``.huffidx`` sidecar of every
K-th symbol's bit offset, and prints a summary line.  ``decode`` reads the
file and its verified sidecar, decodes with ``--decoder`` (default
``lane_wide``; ``lane_dfa`` decodes through a sidecar) and writes the
decoded bytes (to stdout without an output path).  With ``--verify RAW`` it
instead byte-compares the decode with the raw file and then times it: the
minimum wall time over the checked run and ``--repeats`` more.

``prof`` prints the stage breakdown of one decode of a `.huff` file
(``harness.profiling``: ``lanedfa`` by default, as the JAX ``prof``,
``widescan`` or ``speculative``).  ``probe`` runs one of the hardware
probes (``probes``): on the card at its script's sizes, on the CPU at cut
sizes.
Every command runs on the card unless ``--device cpu`` is given, which runs
the kernels' plain versions.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

from huffmandecoderongpus_tpu_torch.huffio import (
    index_path,
    read_huff,
    write_huff,
    write_index,
)
from huffmandecoderongpus_tpu_torch.models import get_decoder
from huffmandecoderongpus_tpu_torch.ops.encode import encode_lanes

#: timed runs after the checked one
REPEATS = 25


def verify_and_time(dec, hf, raw: np.ndarray, name: str, repeats: int):
    """Decode once and compare with ``raw`` (raises on any difference),
    then print the minimum wall time of that run and ``repeats`` more."""
    times = []
    for i in range(repeats + 1):
        t0 = time.perf_counter()
        out = dec(hf)  # host bytes: the decode has finished on the device
        times.append(time.perf_counter() - t0)
        if i == 0 and not np.array_equal(out, raw):
            raise RuntimeError(f"{dec.name} on {name}: decoded bytes differ "
                               "from the raw file")
    best = min(times)
    print(f"{dec.name:>17} {name:>12}     {best * 1e3:.9f} ms"
          f"   {raw.size / best / 1e9:8.4f} GB/s")


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


def main(argv=None) -> None:
    p = argparse.ArgumentParser(
        prog="huffmandecoderongpus_tpu_torch",
        description="PyTorch/CUDA lane-parallel Huffman codec")
    p.add_argument("command", choices=["encode", "decode", "prof", "probe"])
    p.add_argument("args", nargs="+",
                   help="encode: <input> [output.huff]; "
                        "decode: <input.huff> [output]; "
                        "prof: <input.huff> "
                        "[widescan|lanedfa|speculative]; "
                        "probe: <name>")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default cuda; cpu runs the "
                        "kernels' plain versions)")
    p.add_argument("--decoder", default="lane_wide",
                   help="decode: the registry's decoder (default lane_wide)")
    p.add_argument("--index", type=int, metavar="K", default=None,
                   help="encode: also write a .huffidx sidecar every K "
                        "symbols")
    p.add_argument("--verify", metavar="RAW", default=None,
                   help="decode: compare with this raw file, then time it")
    p.add_argument("--repeats", type=int, default=REPEATS,
                   help="decode --verify: timed runs after the verified one")
    p.add_argument("--lanes", type=int, metavar="G", default=None,
                   help="prof: the lane count (default: the decoder's plan)")
    ns = p.parse_args(argv)

    src = ns.args[0]
    dst = ns.args[1] if len(ns.args) > 1 else None
    if ns.command == "prof":
        prof(src, dst or "lanedfa", ns.lanes, ns.device)
        return
    if ns.command == "probe":
        from huffmandecoderongpus_tpu_torch import probes

        probes.run(src, ns.device)
        return
    if ns.command == "encode":
        encode(src, dst, ns.index, ns.device)
        return
    hf = read_huff(src)
    dec = get_decoder(ns.decoder, device=ns.device)
    if ns.verify:
        verify_and_time(dec, hf, np.fromfile(ns.verify, dtype=np.uint8), src,
                        ns.repeats)
        return
    out = np.asarray(dec(hf), dtype=np.uint8)
    if dst:
        out.tofile(dst)
        print(f"{src}: {hf.payload_bytes} -> {out.size} bytes -> {dst}")
    else:
        sys.stdout.buffer.write(out.tobytes())


if __name__ == "__main__":
    main()
