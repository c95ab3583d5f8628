"""The compaction kernel's launch plan and its tiles, on the CPU.

``csrc/compact.cu`` runs a block a tile of ``W`` columns by a chunk of
``R`` rows (``ops/compact.py`` ``compact_plan``).  Here:

- the plan's rules: at (d)'s shape (G 4,096, B + H = 6,665 rows) at least
  four blocks for each of the H100's 132 SMs, shared memory under 48 KB,
  16-byte loads where G and the addresses allow, every column, row and
  output row of its zero fill owned by a block; the launcher's refusals
  mirrored (``compact_plan_ok``);
- the timing harness's variants (``harness/compact_variants.py``) still
  apply to the kernel's source;
- a numpy emulation of the kernel's blocks (each chunk's emissions staged
  at (rank - the column's base, column), written out over the union of
  its columns' rank ranges, its share of the zero fill), showing that
  every output byte has exactly one writer and that the result equals
  ``compact_ref`` on ``probes.streams.COMPACT_CASES``, with the blocks
  whose union is wider than 2R counted as the kernel counts them.

Tolerance: bit-exact (integer outputs).
"""

import numpy as np
import pytest
import torch

from huffmandecoderongpus_tpu_torch.harness import compact_variants as cv
from huffmandecoderongpus_tpu_torch.ops import compact as cp
from huffmandecoderongpus_tpu_torch.probes import streams as ps

#: (d)'s compaction: the dense pipeline's lanes, B + H rows and out_rows
D_SHAPE = (6665, 4096, 3334)
SMS = 132


def emulate_compact(cum, sym, out_rows, p):
    """(out, writers, wide): the kernel's blocks in numpy.  ``writers``
    counts the stores to each output byte; ``wide`` is the kernel's stats
    (blocks whose clipped union is wider than 2R, the rows those unions
    span)."""
    steps, G = cum.shape
    W, R = p["W"], p["R"]
    out = np.full((out_rows, G), 0xEE, dtype=np.uint8)  # poisoned
    writers = np.zeros((out_rows, G), dtype=np.int64)
    wide = [0, 0]
    for chunk in range(p["chunks"]):
        r0, r1 = chunk * R, min(chunk * R + R, steps)
        for tile in range(p["tiles"]):
            g0 = tile * W
            cols = slice(g0, min(g0 + W, G))
            c = cum[r0:r1, cols].astype(np.int64)
            base = (cum[r0 - 1, cols].astype(np.int64) if r0
                    else np.zeros(c.shape[1], np.int64))
            end = c[-1] if r1 > r0 else base
            count = (cum[steps - 1, cols].astype(np.int64) if steps
                     else np.zeros(c.shape[1], np.int64))
            # stage: row r emits where cum rises, at (rank - base, column)
            prev = np.vstack([base[None], c[:-1]])
            stage = np.zeros((R, c.shape[1]), dtype=np.uint8)
            r, col = np.nonzero(c > prev)
            at = c[r, col] - 1 - base[col]
            keep = (at >= 0) & (at < R)
            stage[at[keep], col[keep]] = sym[r0 + r[keep], g0 + col[keep]]
            # write out over the union, clipped to out_rows
            lo = max(int(base.min()), 0)
            hi = min(int(end.max()), out_rows)
            if hi - lo > 2 * R:
                wide[0] += 1
                wide[1] += hi - lo
            top = np.minimum(end, base + R)
            for o in range(lo, hi):
                held = (base <= o) & (o < top)
                j = np.nonzero(held)[0]
                out[o, g0 + j] = stage[o - base[j], j]
                writers[o, g0 + j] += 1
            # this chunk's share of the zero fill
            z0 = chunk * p["zrows"]
            for o in range(z0, min(z0 + p["zrows"], out_rows)):
                j = np.nonzero(o >= count)[0]
                out[o, g0 + j] = 0
                writers[o, g0 + j] += 1
    return out, writers, wide


@pytest.mark.parametrize("case", ps.COMPACT_CASES)
def test_emulated_tiles_write_each_byte_once(case):
    cum, sym, out_rows = ps.compact_case(case, "cpu")
    steps, G = cum.shape
    p = cp.compact_plan(steps, G, out_rows, cum.data_ptr(), sym.data_ptr())
    assert cp.compact_plan_ok(p, steps, G, out_rows, cum.data_ptr(),
                              sym.data_ptr(), 0)
    out, writers, wide = emulate_compact(cum.numpy(), sym.numpy(),
                                         out_rows, p)
    assert (writers == 1).all()
    want = cp.compact_ref(cum, sym, out_rows=out_rows).numpy()
    np.testing.assert_array_equal(out, want)
    assert (wide[0] > 0) == (case == "wide")


def test_wide_case_counts():
    # columns 34-50 emit every row, the rest of their tile a tenth: from
    # the third chunk on their ranks lie more than 2R apart
    cum, sym, out_rows = ps.compact_case("wide", "cpu")
    p = cp.compact_plan(*cum.shape, out_rows)
    wide = emulate_compact(cum.numpy(), sym.numpy(), out_rows, p)[2]
    c = cum.numpy().astype(np.int64)
    W, R, steps = p["W"], p["R"], c.shape[0]
    want = [0, 0]
    for k in range(p["chunks"]):
        for g0 in range(0, c.shape[1], W):
            tile = c[:, g0:g0 + W]
            lo = tile[k * R - 1].min() if k else 0
            hi = min(tile[min(k * R + R, steps) - 1].max(), out_rows)
            if hi - lo > 2 * R:
                want = [want[0] + 1, want[1] + hi - lo]
    assert wide == want and wide[0] >= 2
    assert wide[1] > 2 * R * wide[0]


def test_plan_at_d():
    steps, G, out_rows = D_SHAPE
    p = cp.compact_plan(steps, G, out_rows)
    assert p["blocks"] >= 4 * SMS
    assert p["shared"] < 48 * 1024 and p["threads"] <= 1024
    assert p["vec"] == 4 and p["threads"] % 32 == 0
    assert (p["tiles"], p["chunks"]) == (128, 7)
    assert p["zrows"] * p["chunks"] >= out_rows


@pytest.mark.parametrize("steps,G,out_rows", [
    (0, 5, 3), (1, 1, 1), (64, 128, 64), (65, 129, 0), (6665, 4096, 3334),
    (10_000, 16_384, 5_002), (3, 4095, 1000)])
def test_plan_covers_every_cell(steps, G, out_rows):
    p = cp.compact_plan(steps, G, out_rows)
    assert p["tiles"] * p["W"] >= G > (p["tiles"] - 1) * p["W"]
    assert p["chunks"] * p["R"] >= steps
    assert p["chunks"] == 1 or (p["chunks"] - 1) * p["R"] < steps
    assert p["zrows"] * p["chunks"] >= out_rows
    assert p["blocks"] == p["tiles"] * p["chunks"]
    assert p["shared"] == cp.compact_bytes(p["W"], p["R"])
    # the kernel's batches (a row group 4 rows) split the chunk evenly at
    # both widths, and an output row of a tile is a 32-byte sector
    for vec in (1, 4):
        groups = p["threads"] // (p["W"] // vec)
        assert groups >= 1 and p["R"] % (4 * groups) == 0
    assert p["W"] == 32


@pytest.mark.parametrize("G,cum_ptr,sym_ptr,out_ptr,vec", [
    (4096, 0, 0, 0, 4), (4095, 0, 0, 0, 1), (4096, 4, 0, 0, 1),
    (4096, 0, 2, 0, 1), (4096, 0, 0, 1, 1), (4096, 32, 4, 8, 4)])
def test_plan_vector_width(G, cum_ptr, sym_ptr, out_ptr, vec):
    p = cp.compact_plan(100, G, 50, cum_ptr, sym_ptr, out_ptr)
    assert p["vec"] == vec
    assert cp.compact_plan_ok(p, 100, G, 50, cum_ptr, sym_ptr, out_ptr)
    assert cp.compact_plan_ok(dict(p, vec=1), 100, G, 50, cum_ptr, sym_ptr,
                              out_ptr)


@pytest.mark.parametrize("change", [
    dict(W=64), dict(R=64), dict(threads=128), dict(shared=16),
    dict(tiles=1), dict(chunks=-1), dict(zrows=-1), dict(vec=2)])
def test_plan_ok_refuses_other_plans(change):
    p = cp.compact_plan(*D_SHAPE)
    bad = {k: p[k] + v if k in ("shared", "tiles", "chunks", "zrows")
           else v for k, v in change.items()}
    assert not cp.compact_plan_ok({**p, **bad}, *D_SHAPE, 0, 0, 0)


def test_plan_ok_refuses_misaligned_vectors():
    p = cp.compact_plan(*D_SHAPE)
    assert p["vec"] == 4
    for ptrs in ((4, 0, 0), (0, 1, 0), (0, 0, 2)):
        assert not cp.compact_plan_ok(p, *D_SHAPE, *ptrs)
    assert not cp.compact_plan_ok(p, 6665, 4094, 3334, 0, 0, 0)


def test_cases_hold_the_contract():
    # cum rises by 0 or 1 a row in every case: the kernel relies on it
    for case in ps.COMPACT_CASES:
        cum, _sym, _rows = ps.compact_case(case, "cpu")
        d = torch.diff(cum.to(torch.int64), dim=0,
                       prepend=torch.zeros_like(cum[:1], dtype=torch.int64))
        assert ((d == 0) | (d == 1)).all(), case


@pytest.mark.parametrize("name", sorted(cv.VARIANTS))
def test_timing_variants_apply_to_the_kernel(name):
    # harness/compact_variants.py makes each variant by a substitution on
    # csrc/compact.cu: each must still find its text there, and leave the
    # constants the harness reads
    src = (cv.HERE / "huffmandecoderongpus_tpu_torch/csrc/compact.cu"
           ).read_text()
    got = cv.variant(src, name)
    assert got is not None and (got == src) == (name == "as-is")
    assert cv.constant(got, "W") == cp.W and cv.constant(got, "THREADS") \
        == cp.THREADS
    assert cv.constant(got, "R") == (cp.R // 2 if name == "half-R" else cp.R)
