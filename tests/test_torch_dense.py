"""The port's dense lane-DFA decode and compaction against the JAX package.

``lane_decode_dense`` scans each lane from its entry offset and packs its
symbols to the top of its column (with the lane's count);
``compact`` packs the padded emissions of a scan, given their running
count.  On the CPU the kernels' plain versions run.  They must equal the
JAX package's ``lane_decode_dense_pallas_tiled`` and ``compact_pallas`` in
interpret mode on the rows below each lane's count (the JAX functions
leave the rows past it unspecified; the port's are zero, checked against
numpy), with equal counts, and the dense pipeline (candidate scan,
``compose``, dense decode, trim by the counts) must decode every test
shape to its input.  Tolerance: bit-exact everywhere (integer outputs).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from huffmandecoderongpus_tpu import native
from huffmandecoderongpus_tpu.ops import pallas_lanedfa as jpl
from huffmandecoderongpus_tpu_torch.ops import compact as cp
from huffmandecoderongpus_tpu_torch.ops import lane_decode_dense as ldd
from huffmandecoderongpus_tpu_torch.ops import lanedfa, lanedfa_decode
from huffmandecoderongpus_tpu_torch.ops.candidate_scan import candidate_scan
from huffmandecoderongpus_tpu_torch.ops.lane_scan import lane_scan
from huffmandecoderongpus_tpu_torch.probes import streams as ps
from torch_streams import MD1_SHAPES, SHAPES, make


def _compact_numpy(cum, sym, out_rows):
    """Each column's emitted symbols packed to its top, zero below."""
    steps, G = cum.shape
    prev = np.vstack([np.zeros((1, G), cum.dtype), cum[:-1]])
    out = np.zeros((out_rows, G), dtype=np.uint8)
    for g in range(G):
        s = sym[:, g][cum[:, g] > prev[:, g]][:out_rows]
        out[:s.size, g] = s
    return out


def _random_emissions(rng, steps, G, p=0.3):
    valid = rng.random((steps, G)) < p
    sym = rng.integers(0, 256, (steps, G), np.uint8)
    return np.cumsum(valid, axis=0, dtype=np.int32), sym


def test_compact_matches_pallas():
    # the JAX test's shape: 77 rows, one lane tile, 40 output rows
    rng = np.random.default_rng(0)
    steps, G, out_rows = 77, jpl.LANE_TILE, 40
    cum, sym = _random_emissions(rng, steps, G)
    got = cp.compact(torch.from_numpy(cum), torch.from_numpy(sym),
                     out_rows=out_rows).numpy()
    want = np.asarray(jpl.compact_pallas(jnp.asarray(cum), jnp.asarray(sym),
                                         steps=steps, G=G, out_rows=out_rows,
                                         interpret=True))
    assert got.shape == want.shape == (out_rows, G) and got.dtype == np.uint8
    below = np.arange(out_rows)[:, None] < np.minimum(cum[-1], out_rows)
    np.testing.assert_array_equal(got[below], want[below])
    np.testing.assert_array_equal(got, _compact_numpy(cum, sym, out_rows))


@pytest.mark.parametrize("case", [
    *(pytest.param(shape, id="-".join(map(str, shape)))
      for shape in ((50, 100, 30), (1, 3, 2), (200, 1, 200), (64, 130, 0))),
    *ps.COMPACT_CASES])
def test_compact_any_width(case):
    # random shapes, and the kernel's edge cases (probes.streams
    # COMPACT_CASES: widths off its 128-column tiles, steps off its 64-row
    # chunks, out_rows 0, under and over the counts, silent and full
    # columns, ranks more than two chunks apart, an offset view)
    if isinstance(case, str):
        cum_t, sym_t, out_rows = ps.compact_case(case, "cpu")
        cum, sym = cum_t.numpy(), sym_t.numpy()
    else:
        steps, G, out_rows = case
        rng = np.random.default_rng(steps + G)
        cum, sym = _random_emissions(rng, steps, G, p=0.6)
        cum_t, sym_t = torch.from_numpy(cum), torch.from_numpy(sym)
    got = cp.compact(cum_t, sym_t, out_rows=out_rows)
    assert got.shape == (out_rows, cum.shape[1])
    if case == (50, 100, 30) or case == "rows-under":
        # columns both over and under out_rows
        assert (cum[-1] > out_rows).any() and (cum[-1] < out_rows).any()
    np.testing.assert_array_equal(got.numpy(),
                                  _compact_numpy(cum, sym, out_rows))


def _pallas_compact(cum, sym, out_rows):
    """The JAX ``compact_pallas`` in interpret mode, the columns padded with
    silent ones to its lane tile."""
    steps, G = cum.shape
    Gp = -(-G // jpl.LANE_TILE) * jpl.LANE_TILE
    cum_p = np.zeros((steps, Gp), np.int32)
    sym_p = np.zeros((steps, Gp), np.uint8)
    cum_p[:, :G], sym_p[:, :G] = cum, sym
    return np.asarray(jpl.compact_pallas(
        jnp.asarray(cum_p), jnp.asarray(sym_p), steps=steps, G=Gp,
        out_rows=out_rows, interpret=True))[:, :G]


@pytest.mark.parametrize("case", [
    "short",
    *(pytest.param(c, marks=pytest.mark.interpret)
      for c in ("g1", "g33", "odd-steps", "rows-under", "never+always",
                "offset"))])
def test_compact_cases_match_pallas(case):
    # the port's compaction against the JAX kernel below each column's
    # count (the JAX function leaves the rows past it unspecified, and
    # takes no more rows than steps)
    cum_t, sym_t, out_rows = ps.compact_case(case, "cpu")
    cum, sym = cum_t.numpy(), sym_t.numpy()
    got = cp.compact(cum_t, sym_t, out_rows=out_rows).numpy()
    want = _pallas_compact(cum, sym, out_rows)
    below = np.arange(out_rows)[:, None] < np.minimum(cum[-1], out_rows)
    np.testing.assert_array_equal(got[below], want[below])
    assert not got[~below].any()


def test_kernels_refuse_non_cuda_tensors():
    cum = torch.empty((10, 8), dtype=torch.int32, device="meta")
    sym = torch.empty((10, 8), dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        cp.compact(cum, sym, out_rows=4)
    bits = torch.empty((100, 512), dtype=torch.uint8, device="meta")
    tab = torch.empty((1, 128), dtype=torch.int32, device="meta")
    start = torch.empty(512, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        ldd.lane_decode_dense(bits, tab, start, B=96, H=4, N=40000,
                              out_rows=60)


def _pipeline(hf):
    """The tiled staging, the candidate scan and ``compose``, and the
    dense decode's output rows (the JAX test's bound)."""
    st = lanedfa_decode.stage_lanedfa(hf, device="cpu")
    kw = dict(B=st["B"], H=st["H"], N=st["N"])
    cnt, ex = candidate_scan(st["bits"], st["tab"], **kw)
    entry = lanedfa_decode.compose(cnt, ex)[0]
    md = lanedfa.build_lane_dfa(hf.tree).min_depth
    out_rows = min(st["B"] + st["H"], st["B"] // max(md, 1) + 2)
    return st, kw, entry, out_rows


def _trim(dense, counts):
    keep = torch.arange(dense.shape[0])[:, None] < counts[None, :]
    return dense.t()[keep.t()].numpy()


@pytest.mark.parametrize("name", ["text", "ns2"])
def test_lane_decode_dense_matches_pallas(name):
    raw, hf = make(name)
    st, kw, entry, out_rows = _pipeline(hf)
    G = st["bits"].shape[1]
    assert G == jpl.LANE_TILE
    dense, counts = ldd.lane_decode_dense(st["bits"], st["tab"], entry,
                                          out_rows=out_rows, **kw)
    T = G // jpl.LANE_TILE
    steps = st["B"] + st["H"]
    bits4 = jnp.asarray(np.ascontiguousarray(
        st["bits"].numpy().reshape(steps, T, 8, 128).transpose(1, 0, 2, 3)))
    dense4, counts4 = jpl.lane_decode_dense_pallas_tiled(
        bits4, jnp.asarray(st["tab"].numpy()),
        jnp.asarray(entry.numpy()).reshape(T, 8, 128), out_rows=out_rows,
        G=G, **kw, interpret=True)
    want = np.asarray(dense4).transpose(1, 0, 2, 3).reshape(out_rows, G)
    np.testing.assert_array_equal(counts.numpy(),
                                  np.asarray(counts4).reshape(G))
    below = (np.arange(out_rows)[:, None]
             < np.minimum(counts.numpy(), out_rows)[None, :])
    np.testing.assert_array_equal(dense.numpy()[below], want[below])
    assert not dense.numpy()[~below].any()  # the port zeroes the rest
    np.testing.assert_array_equal(_trim(dense, counts), raw)


@pytest.mark.parametrize("name", sorted(SHAPES) + sorted(MD1_SHAPES))
def test_dense_pipeline_decodes(name):
    raw, hf = make(name)
    st, kw, entry, out_rows = _pipeline(hf)
    dense, counts = ldd.lane_decode_dense(st["bits"], st["tab"], entry,
                                          out_rows=out_rows, **kw)
    assert int(counts.max()) <= out_rows
    np.testing.assert_array_equal(_trim(dense, counts), raw)
    np.testing.assert_array_equal(_trim(dense, counts),
                                  native.simple_decode(hf))
    # compact on the lane scan's padded emissions gives the same rows
    sym, valid = lane_scan(st["bits"], st["tab"], entry, **kw)
    cum = torch.cumsum(valid, 0, dtype=torch.int32)
    assert torch.equal(cum[-1], counts)
    assert torch.equal(cp.compact(cum, sym, out_rows=out_rows), dense)


def test_dense_counts_past_out_rows():
    # counts are each lane's emissions, not clipped: the rows hold the
    # first out_rows symbols, as the JAX function returns them
    raw, hf = make("md1")
    st, kw, entry, out_rows = _pipeline(hf)
    full, counts = ldd.lane_decode_dense(st["bits"], st["tab"], entry,
                                         out_rows=out_rows, **kw)
    short = int(counts.max()) // 2
    dense, cut_counts = ldd.lane_decode_dense(st["bits"], st["tab"], entry,
                                              out_rows=short, **kw)
    assert torch.equal(cut_counts, counts) and int(counts.max()) > short
    assert torch.equal(dense, full[:short])
