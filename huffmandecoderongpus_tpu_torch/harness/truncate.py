"""Input-size scaling sweeps: truncate a compressed stream at a symbol
boundary and benchmark the reduced instance.

The port's copy of the JAX package's ``harness/truncate.py``.  Semantics
parity with setTargetSizes + graphtest (mainrun.c:361-410): walk the
stream up to the target bit count, cut at the last completed codeword, and
set the matching uncompressed size.  The walk is the port's C++
``truncate_scan``; the truncated instance shares the original payload bytes
(a slice and the exact ``bits``), as the reference reuses its buffers with
reduced sizes.
"""

from __future__ import annotations

from typing import Iterator

from huffmandecoderongpus_tpu_torch import native
from huffmandecoderongpus_tpu_torch.data import TestData
from huffmandecoderongpus_tpu_torch.harness.evaluate import REPEATS, EvalResult, evaluate
from huffmandecoderongpus_tpu_torch.huffio import HuffFile


def set_target_sizes(hf: HuffFile, target_bits: int) -> HuffFile:
    """Truncated instance of ``hf``: the longest prefix of <= ``target_bits``
    bits that ends exactly on a codeword boundary (mainrun.c:361-385)."""
    target_bits = min(int(target_bits), hf.bits)
    bits, nsym = native.truncate_scan(hf.tree, hf.payload_padded(), target_bits)
    nbytes = (bits + 7) // 8
    return HuffFile(
        tree=hf.tree,
        bits=bits,
        uncompressed_size=nsym,
        payload=hf.payload[:nbytes],
    )


def truncate_test_data(td: TestData, target_bits: int) -> TestData:
    """TestData view of a truncated instance, with matching ground truth."""
    cd = set_target_sizes(td.cd, target_bits)
    return TestData(name=td.name, cd=cd, ucd=td.ucd[: cd.uncompressed_size])


def graph_rows(decoder, td: TestData, incs: int, repeats: int = REPEATS,
               param=None) -> Iterator[tuple[int, EvalResult]]:
    """Scaling sweep (graphtest, mainrun.c:387-410): benchmark the decoder at
    target sizes incs, 2*incs, ... up to the full stream.  Yields
    (target_bits, EvalResult) pairs."""
    testsize = incs
    while testsize < td.cd.bits:
        rtd = truncate_test_data(td, testsize)
        yield testsize, evaluate(decoder, rtd, withcheck=True, repeats=repeats, param=param)
        testsize += incs


def graphtest(decoder, td: TestData, incs: int, repeats: int = REPEATS,
              param=None, out=None) -> list[tuple[int, EvalResult]]:
    """Print `size seconds` rows like the reference (mainrun.c:407)."""
    rows = []
    for size, r in graph_rows(decoder, td, incs, repeats=repeats, param=param):
        print(f"{size:8d}  {r.min_seconds:.9f}", file=out)
        rows.append((size, r))
    return rows
