"""The speculative "decode from every bit offset" pipeline.

The port of ``huffmandecoderongpus_tpu/ops/speculative.py``, the source
paper's own algorithm (``fastgpu.cu``): decode a symbol at every bit offset,
double the code-length steps ``levels`` times so that each offset knows the
span of 2^k codewords from it, then let every output index walk those
levels down to its codeword.  ``levels`` is a static function of the
header's size, so no step reads anything back to the host.

On a CUDA device the pipeline runs hand-written kernels, S1
(``spec_all_bits``: windows and table lookups, once), S2 (``spec_tile``:
levels 1..m of a tile in shared memory, once, then ``spec_pair``: a kept
level from the one below, two levels a launch, as ``s2_plan`` says) and
S3 (``spec_query``: the walk, the result and the size check, once); on the
CPU their plain versions.  Every second level is kept for the query, in
int16 where its spans fit (the JAX rule); no odd level is written, and the
query recomputes each from the kept level below.
``speculative_decode_numpy`` is the host oracle, a copy of the JAX
package's numpy pipeline.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from huffmandecoderongpus_tpu_torch.huffio import payload_to_words_u32
from huffmandecoderongpus_tpu_torch.ops import _build
from huffmandecoderongpus_tpu_torch.ops.lanedfa_decode import require_device
from huffmandecoderongpus_tpu_torch.ops.lut import DecodeLUT, build_decode_lut
from huffmandecoderongpus_tpu_torch.ops.spec_all_bits import (  # noqa: F401
    extract_windows,
    spec_all_bits,
)
from huffmandecoderongpus_tpu_torch.ops.spec_double import level_dtype
from huffmandecoderongpus_tpu_torch.ops.spec_pair import spec_pair
from huffmandecoderongpus_tpu_torch.ops.spec_query import spec_query
from huffmandecoderongpus_tpu_torch.ops.spec_tile import s2_plan, spec_tile
from huffmandecoderongpus_tpu_torch.utils.debug import debug_enabled, dump


@dataclasses.dataclass(frozen=True)
class SpecPlan:
    """Static shape/trip-count parameters for one decode."""

    bits: int  # exact payload bit count
    size: int  # uncompressed byte count (from the header)
    height: int  # LUT height
    levels: int  # doubling levels = bits needed to binary-decompose size-1

    @property
    def n_words(self) -> int:
        return (self.bits + 31) // 32 + 1


def make_plan(bits: int, size: int, height: int) -> SpecPlan:
    levels = (size - 1).bit_length() if size > 1 else 0
    return SpecPlan(bits=bits, size=size, height=height, levels=levels)


def double_levels(step0, *, bits: int, height: int, levels: int,
                  size: int) -> list:
    """The kept levels 0, 2, 4, ... below max(levels, 1): ``step0`` and
    every second doubling, each in ``level_dtype``: the tile launch's
    levels 2..m, then a pair launch a kept level (``s2_plan``; ``size``,
    the header's, sets the pairs' block order)."""
    p = s2_plan(bits, height, levels, sms=_build.sm_count(step0.device),
                size=size)
    kept = [step0]
    if p["m"]:
        kept += spec_tile(step0, bits=bits, height=height, m=p["m"],
                          tile=p["tile"])
    for k, seg in zip(p["pairs"], p["segs"]):
        kept.append(spec_pair(kept[-1], bits=bits,
                              dtype=level_dtype(k, height), seg=seg))
    return kept


def speculative_stages(words, lut_sym, lut_len, *, bits: int, size: int,
                       height: int, levels: int) -> dict:
    """Every stage's outputs: ``step0`` and ``sym`` (S1), ``kept`` (S2),
    ``result`` and ``found`` (S3); under ``HUFF_DEBUG`` each is dumped
    (``utils.debug``), as the reference's debug builds print bitdecode,
    bitsteps and bitsindex."""
    step0, sym = spec_all_bits(words, lut_sym, lut_len, bits=bits,
                               height=height)
    kept = double_levels(step0, bits=bits, height=height, levels=levels,
                         size=size)
    result, found = spec_query(kept, sym, bits=bits, size=size,
                               levels=levels)
    if debug_enabled():
        dump("S1 sym", sym)
        for i, level in enumerate(kept):
            dump(f"S2 level {2 * i}", level)
        dump("S3 result", result)
        dump("S3 found", found)
    return dict(step0=step0, sym=sym, kept=kept, result=result, found=found)


def speculative_decode(words, lut_sym, lut_len, *, bits: int, size: int,
                       height: int, levels: int):
    """(decoded uint8 (size,), found_size int32 ()) on ``words``' device,
    as ``speculative_decode_xla``: found_size is ``size`` iff the chain of
    ``size`` codewords ends exactly at ``bits`` and took no invalid span,
    else -1."""
    st = speculative_stages(words, lut_sym, lut_len, bits=bits, size=size,
                            height=height, levels=levels)
    return st["result"], st["found"]


def decode_device_arrays(hf, lut: DecodeLUT | None = None, *, device):
    """(plan, (words int32, lut_sym uint8, lut_len int32) on ``device``)
    for a HuffFile; the words are the payload's uint32 bit patterns with
    one zero pad word."""
    device = require_device(device)
    if lut is None:
        lut = build_decode_lut(hf.tree)
    plan = make_plan(hf.bits, hf.uncompressed_size, lut.height)
    words = payload_to_words_u32(hf.payload, hf.bits, extra_words=1)
    return plan, tuple(torch.from_numpy(a).to(device) for a in (
        words.view(np.int32), lut.sym, lut.length))


def decode_spec(hf, device, lut: DecodeLUT | None = None,
                check_size: bool = True) -> np.ndarray:
    """HuffFile -> decoded bytes through the pipeline on ``device`` (the
    JAX ``decode_xla``).  Raises RuntimeError where the decoded count is
    not the header's."""
    plan, (words, lut_sym, lut_len) = decode_device_arrays(hf, lut,
                                                           device=device)
    result, found = speculative_decode(
        words, lut_sym, lut_len, bits=plan.bits, size=plan.size,
        height=plan.height, levels=plan.levels)
    out = result.cpu().numpy()
    if check_size and int(found) != plan.size:
        raise RuntimeError(f"decoded {int(found)} symbols, header says "
                           f"{plan.size}")
    return out


# ---------------------------------------------------------------------------
# numpy reference semantics (the role pes.c plays in the reference: the
# parallel algorithm executed on the host, used as a cross-check oracle).


def speculative_decode_numpy(hf) -> np.ndarray:
    """Vectorized numpy execution of the same pipeline (oracle/debugging)."""
    lut = build_decode_lut(hf.tree)
    bits, size = hf.bits, hf.uncompressed_size
    words = payload_to_words_u32(hf.payload, bits, extra_words=1)

    b = np.arange(bits, dtype=np.int64)
    q, r = b >> 5, (b & 31).astype(np.uint32)
    lo = words[q] >> r
    hi = np.where(r == 0, 0,
                  (words[q + 1] << (np.uint32(32) - r)) & 0xFFFFFFFF).astype(
        np.uint32)
    win = (lo | hi) & np.uint32(lut.mask)
    ln = lut.length[win].astype(np.int64)
    sym = lut.sym[win]
    step0 = np.where(b + ln <= bits, ln, -1)

    levels = (size - 1).bit_length() if size > 1 else 0
    steps = [step0]
    for _ in range(max(levels - 1, 0)):
        s = steps[-1]
        t = b + s
        tc = np.clip(t, 0, bits - 1)
        w = s[tc]
        ok = (s != -1) & (t < bits) & (w != -1) & (t + w <= bits)
        steps.append(np.where(ok, s + w, -1))

    idx = np.full(bits, -1, dtype=np.int64)
    idx[0] = 0
    for k in range(levels - 1, -1, -1):
        s = steps[k]
        ok = (idx != -1) & (s != -1) & (b + s < bits)
        idx[(b + s)[ok]] = idx[ok] + (1 << k)

    result = np.zeros(size, dtype=np.uint8)
    ok = idx != -1
    result[idx[ok]] = sym[ok]
    found = int(idx.max()) + 1
    if found != size:
        raise RuntimeError(f"decoded {found} symbols, header says {size}")
    return result
