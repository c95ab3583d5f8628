"""Command line of the port: the ``decode`` command.

    python -m huffmandecoderongpus_tpu_torch decode x.huff [out.bin] --device cuda

writes the decoded bytes (to stdout without an output path).  With
``--verify RAW`` it instead byte-compares the decode with the raw file and
then times it: the minimum wall time over the checked run and ``--repeats``
more.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

from huffmandecoderongpus_tpu_torch.huffio import read_huff
from huffmandecoderongpus_tpu_torch.models import get_decoder

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


def main(argv=None) -> None:
    p = argparse.ArgumentParser(
        prog="huffmandecoderongpus_tpu_torch",
        description="PyTorch/CUDA wide-lane Huffman decoder")
    p.add_argument("command", choices=["decode"])
    p.add_argument("args", nargs="+", help="<input.huff> [output]")
    p.add_argument("--device", required=True,
                   help="torch device to decode on, e.g. cuda or cpu")
    p.add_argument("--verify", metavar="RAW", default=None,
                   help="compare with this raw file, then time the decode")
    p.add_argument("--repeats", type=int, default=REPEATS,
                   help="timed runs after the verified one")
    ns = p.parse_args(argv)

    src = ns.args[0]
    hf = read_huff(src)
    dec = get_decoder("lane_wide", device=ns.device)
    if ns.verify:
        verify_and_time(dec, hf, np.fromfile(ns.verify, dtype=np.uint8), src,
                        ns.repeats)
        return
    out = np.asarray(dec(hf), dtype=np.uint8)
    dst = ns.args[1] if len(ns.args) > 1 else None
    if dst:
        out.tofile(dst)
        print(f"{src}: {hf.payload_bytes} -> {out.size} bytes -> {dst}")
    else:
        sys.stdout.buffer.write(out.tobytes())


if __name__ == "__main__":
    main()
