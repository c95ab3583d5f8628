"""The port's batched multi-stream decode against the JAX package, on the CPU.

N streams, each with its own tree, through one program: K1 and K3 on
per-stream tables (``k1_scan2_c01``/``k3_fix2_c01``, the JAX ``k1_scan2`` /
``k3_fix2`` with ``c01`` and ``tab_bounds``), one K2 after the stream-final
lanes' exit maps are zeroed, one K4.  Staging must be byte-equal to
``stage_batch_inputs`` (its ``tab_bounds`` read as the port's stream map);
the plain K1/K3 must equal the JAX kernels in interpret mode, stage by
stage through the program; ``decode_widescan_batch`` must equal the input,
the serial native oracle and the JAX routing (auto-split, overflow
re-decode, the envelope refusals).  Tolerance: bit-exact everywhere
(integer outputs; dense rows compared up to each lane's count).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from huffmandecoderongpus_tpu import native
from huffmandecoderongpus_tpu.huffio.encoder import encode_bytes
from huffmandecoderongpus_tpu.ops import pallas_batch as jpb
from huffmandecoderongpus_tpu.ops import pallas_widescan as jws
from huffmandecoderongpus_tpu_torch.ops import batch, k1_scan2_c01
from huffmandecoderongpus_tpu_torch.ops import k2_compose, k3_fix2_c01
from huffmandecoderongpus_tpu_torch.ops import k4_compact, widescan
from torch_streams import BATCHES, as_numpy, batch_text, full_alphabet, md1
from torch_streams import make_batch


def _stream_map(st):
    """The JAX staging's table row groups as the port's stream map: the
    stream of every 128-lane block."""
    p = st["plan"]
    rgs = [sum(rg >= b for b in st["tab_bounds"])
           for rg in range(p["G"] // 128 // p["RB"])]
    return np.repeat(np.asarray(rgs, dtype=np.int32), p["RB"])


def _assert_staging_equal(got, want):
    assert got["plan"] == want["plan"]
    for key in ("H", "md", "last_live", "g0", "g_live", "g_pad"):
        assert got[key] == want[key], key
    N = len(want["g0"])
    tabw = want["tabw"].reshape(N, 8, 128)
    assert not tabw[:, 2:].any()
    for key, w in (("tabs", tabw[:, :2].reshape(2 * N, 128)),
                   ("c01", want["c01"]), ("lim", want["lim2"]),
                   ("words", want["words"]), ("bstream", _stream_map(want))):
        g = got[key].numpy()
        assert g.dtype == w.dtype == np.int32, key
        np.testing.assert_array_equal(g, w.reshape(g.shape), err_msg=key)
    # the last live lane of each stream, inside its own lane range
    bs = got["bstream"].numpy()
    for k, g in enumerate(got["last_live"]):
        assert bs[g // 128] == k


@pytest.mark.parametrize("kw", [{}, dict(B=64), dict(B=700), dict(B=4000),
                                dict(lane_block=2048)])
@pytest.mark.parametrize("case", BATCHES)
def test_stage_batch_matches_jax(case, kw):
    # MIN_B floors an explicit B of 64 at 128; B=700 rounds to whole words
    _, hfs = make_batch(case)
    want = as_numpy(jpb.stage_batch_inputs(hfs, **kw))
    got = batch.stage_batch_inputs(hfs, device="cpu", **kw)
    _assert_staging_equal(got, want)
    if "B" in kw:
        assert got["plan"]["B"] == max(batch.MIN_B, -(-kw["B"] // 32) * 32)
    again = widescan.from_jax_staging(want, "cpu")
    for key in ("tabs", "c01", "lim", "words", "bstream"):
        assert torch.equal(again[key], got[key]), key


def _both_raise(exc, match, hfs, **kw):
    jexc = jws.EnvelopeError if exc is widescan.EnvelopeError else exc
    with pytest.raises(jexc, match=match):
        jpb.stage_batch_inputs(hfs, **kw)
    with pytest.raises(exc, match=match):
        batch.stage_batch_inputs(hfs, device="cpu", **kw)


def test_batch_envelope_refusals():
    # one md=1 or > 127-state member refuses the whole batch, as in JAX
    rng = np.random.default_rng(13)
    ok = encode_bytes(batch_text(rng, 9000))
    _both_raise(widescan.EnvelopeError, "md=1",
                [ok, encode_bytes(md1(rng, 9000))])
    _both_raise(widescan.EnvelopeError, "compact layout",
                [encode_bytes(full_alphabet(rng, 30000)), ok])
    # a lane block whose rows split into no valid row-group block
    _both_raise(widescan.EnvelopeError, "no valid row-group block", [ok, ok],
                lane_block=512)
    _both_raise(ValueError, "empty batch", [])
    with pytest.raises(widescan.EnvelopeError):
        batch.decode_widescan_batch([ok, encode_bytes(md1(rng, 9000))],
                                    device="cpu")


def _jax_batch_stages(hfs):
    """Every stage of the JAX batched program (Pallas kernels in interpret
    mode) in the port's layouts, and the staging it ran on."""
    st = jpb.stage_batch_inputs(hfs)
    p = st["plan"]
    G, H, md = p["G"], st["H"], st["md"]
    R = G // 128
    wmat = jws.words_matrix_device(st["words"], -(-p["steps_p"] // 32))
    kw = dict(G=G, steps_p=p["steps_p"], SEG=p["SEG"], UNROLL=p["UNROLL"],
              md=md, C0=0, C1=0, NS=1, RB=p["RB"],
              tab_bounds=st["tab_bounds"], interpret=True)
    sym, val, cntm, exm, mrm = jws.k1_scan2(
        wmat, st["tabw"], st["lim2"], st["c01"], B=p["B"], H=H,
        steps=p["steps"], **kw)
    HP = cntm.shape[0]
    ex0 = exm.reshape(HP, G)
    bmask = np.zeros(G, dtype=bool)
    bmask[list(st["last_live"])] = True
    exz = jnp.where(jnp.asarray(bmask)[None, :], 0, ex0)
    Rg, NG = p["Rg"], p["NG"]
    ex3 = jnp.pad(exz.T.reshape(NG, Rg, HP).transpose(1, 0, 2),
                  ((0, 0), (0, 0), (0, 128 - HP)))
    ent3, _tot = jws.k2_compose(ex3, jnp.zeros((1, 1), jnp.int32), Rg=Rg,
                                NG=NG, interpret=True)
    entry = ent3[:, :, 0].T.reshape(G).astype(jnp.int32)
    n = jws._select_h(cntm.reshape(HP, G), entry, H)
    cut = jnp.where(entry == 0, 0,
                    jws._select_h(mrm.reshape(HP, G), entry, H) + 1)
    cut = jnp.where(st["lim2"].reshape(G) > 0, cut, 0)
    cut_slot = jnp.where(cut > 0, (cut - 1) // md + 1, 0)
    msym, mval = jws.k3_fix2(wmat, st["tabw"], entry.reshape(R, 128),
                             cut.reshape(R, 128), cut_slot.reshape(R, 128),
                             sym, val, st["c01"], **kw)
    cells = sym.shape[0]
    denseT = jws.k4_compact(msym, mval, G=G, cells_p=cells, ORP=p["ORP"],
                            interpret=True)
    out = dict(sym=sym.reshape(cells, G), val=val.reshape(cells, G),
               cntmap=cntm.reshape(HP, G), exmap=exz,
               mrowmap=mrm.reshape(HP, G), entry=entry, n=n,
               cut=cut, cut_slot=cut_slot, msym=msym.reshape(cells, G),
               mval=mval.reshape(cells, G), denseT=denseT)
    return {k: np.asarray(v) for k, v in out.items()}, as_numpy(st)


def _port_batch_stages(st):
    """The port's plain stages on staged tensors, and the whole program
    through the wrappers."""
    p = st["plan"]
    H, md = st["H"], st["md"]
    wmat = widescan.words_matrix(st["words"], -(-p["steps_p"] // 32))
    args = (st["tabs"], st["lim"], st["c01"], st["bstream"])
    sym, val, cntmap, exmap, mrowmap = k1_scan2_c01.k1_scan2_c01_ref(
        wmat, *args, B=p["B"], H=H, steps=p["steps"], steps_p=p["steps_p"],
        SEG=p["SEG"], md=md)
    exmap[:, list(st["last_live"])] = 0
    entry, _tot = k2_compose.k2_compose_ref(exmap, 0)
    n = widescan.select_h(cntmap, entry, H)
    cut, cut_slot = widescan.fix_rows(entry, mrowmap, st["lim"], H, md)
    msym, mval = k3_fix2_c01.k3_fix2_c01_ref(
        wmat, st["tabs"], entry, cut, cut_slot, sym.clone(), val.clone(),
        st["c01"], st["bstream"], steps_p=p["steps_p"], SEG=p["SEG"], md=md)
    denseT = k4_compact.k4_compact_ref(msym, mval, ORP=p["ORP"])
    prog = batch.batch_decode_program(*batch.batch_inputs(st),
                                      **batch.batch_args(st))
    assert torch.equal(prog[0], denseT) and torch.equal(prog[1], n)
    out = dict(sym=sym, val=val, cntmap=cntmap, exmap=exmap,
               mrowmap=mrowmap, entry=entry, n=n, cut=cut,
               cut_slot=cut_slot, msym=msym, mval=mval, denseT=denseT)
    return {k: v.numpy() for k, v in out.items()}


def _assert_batch_stages(raws, got, want, st):
    for k in ("sym", "val", "cntmap", "exmap", "mrowmap", "entry", "n",
              "cut", "cut_slot", "msym", "mval"):
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    ORP = want["denseT"].shape[1]
    n = want["n"]
    mask = np.arange(ORP)[None, :] < np.minimum(n, ORP)[:, None]
    np.testing.assert_array_equal(got["denseT"][mask], want["denseT"][mask])
    for k, raw in enumerate(raws):
        g0, gk = st["g0"][k], st["g_pad"][k]
        np.testing.assert_array_equal(got["denseT"][g0:g0 + gk][
            mask[g0:g0 + gk]], raw)


@pytest.fixture(scope="module")
def mixed_stages():
    """One interpret-mode JAX run of the batched program on a two-stream
    mixed-md batch and the port's stages on the same staged inputs."""
    rng = np.random.default_rng(12)
    raws = [batch_text(rng, 30000), batch_text(rng, 20000, 64, 1.0)]
    hfs = [encode_bytes(r) for r in raws]
    assert len({max(jpb.build_lane_dfa(h.tree).min_depth, 1)
                for h in hfs}) == 2
    want, jst = _jax_batch_stages(hfs)
    got = _port_batch_stages(widescan.from_jax_staging(jst, "cpu"))
    return raws, got, want, jst


def test_batch_k1_matches_jax(mixed_stages):
    _raws, got, want, _st = mixed_stages
    for k in ("sym", "val", "cntmap", "exmap", "mrowmap"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    # the candidate machinery and the boundary reset both act
    assert want["entry"].max() > 0


def test_batch_k3_k4_match_jax(mixed_stages):
    raws, got, want, st = mixed_stages
    _assert_batch_stages(raws, got, want, st)


@pytest.mark.interpret
@pytest.mark.parametrize("case", BATCHES)
def test_batch_stages_match_jax_interpret(case):
    raws, hfs = make_batch(case)
    want, jst = _jax_batch_stages(hfs)
    got = _port_batch_stages(widescan.from_jax_staging(jst, "cpu"))
    _assert_batch_stages(raws, got, want, jst)


@pytest.mark.parametrize("case", BATCHES)
def test_decode_batch_matches_input_and_oracle(case):
    raws, hfs = make_batch(case)
    outs = batch.decode_widescan_batch(hfs, device="cpu", auto_split=False)
    assert len(outs) == len(raws)
    for out, raw, hf in zip(outs, raws, hfs):
        assert out.dtype == np.uint8
        np.testing.assert_array_equal(out, raw)
        np.testing.assert_array_equal(out, native.simple_decode(hf))


@pytest.mark.interpret
def test_decode_batch_matches_jax_interpret():
    raws, hfs = make_batch("two")
    got = batch.decode_widescan_batch(hfs, device="cpu")
    want = jpb.decode_widescan_batch(hfs, interpret=True)
    for g, w, raw in zip(got, want, raws):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, raw)


def _spy_solo(monkeypatch, calls):
    real = widescan.decode_widescan
    monkeypatch.setattr(widescan, "decode_widescan",
                        lambda hf, **kw: calls.append(hf.bits)
                        or real(hf, **kw))


def _sizes():
    rng = np.random.default_rng(15)
    raws = [batch_text(rng, n) for n in (4000, 8000, 16000)]
    hfs = [encode_bytes(r) for r in raws]
    assert hfs[0].bits < hfs[1].bits < hfs[2].bits
    return raws, hfs


@pytest.mark.parametrize("solo_from,solo", [(1, [0, 1, 2]), (2, [2]),
                                            (None, [])])
def test_auto_split(monkeypatch, solo_from, solo):
    # members at or above BATCH_SOLO_BITS decode alone; fewer than two
    # small members leave no batch at all (the JAX rule)
    raws, hfs = _sizes()
    if solo_from is not None:
        monkeypatch.setattr(batch, "BATCH_SOLO_BITS", hfs[solo_from].bits)
    calls, staged = [], []
    _spy_solo(monkeypatch, calls)
    real = batch.stage_batch_inputs
    monkeypatch.setattr(batch, "stage_batch_inputs",
                        lambda h, **kw: staged.append(len(h)) or real(h,
                                                                      **kw))
    outs = batch.decode_widescan_batch(hfs, device="cpu")
    assert sorted(calls) == sorted(hfs[k].bits for k in solo)
    assert staged == ([] if len(solo) >= 2 else [3 - len(solo)])
    for out, raw in zip(outs, raws):
        np.testing.assert_array_equal(out, raw)


def test_overflow_member_decodes_alone(monkeypatch):
    # B=512 puts ~190 symbols in a lane: a dense row of 128 overflows, and
    # every member re-decodes alone through decode_widescan
    rng = np.random.default_rng(14)
    raws = [batch_text(rng, 9000), batch_text(rng, 9000, skew=2.0),
            np.tile(np.arange(8, dtype=np.uint8), 5)]
    hfs = [encode_bytes(r) for r in raws]
    real = batch.stage_batch_inputs

    def clamped(h, **kw):
        st = real(h, **kw)
        st["plan"]["ORP"] = 128
        return st

    monkeypatch.setattr(batch, "stage_batch_inputs", clamped)
    calls = []
    _spy_solo(monkeypatch, calls)
    outs = batch.decode_widescan_batch(hfs, device="cpu", B=512)
    # the 40-byte member fits its row; the two long ones overflow
    assert calls == [hfs[0].bits, hfs[1].bits]
    for out, raw in zip(outs, raws):
        np.testing.assert_array_equal(out, raw)


def test_cuda_never_falls_back():
    if torch.cuda.is_available():
        pytest.skip("CUDA is available: the check is for hosts without it")
    _, hfs = make_batch("two")
    with pytest.raises(RuntimeError, match="cuda"):
        batch.decode_widescan_batch(hfs, device="cuda")
    meta = torch.empty((8, 1024), dtype=torch.int32, device="meta")
    lane = torch.empty(1024, dtype=torch.int32, device="meta")
    tabs = torch.empty((4, 128), dtype=torch.int32, device="meta")
    bs = torch.empty(8, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        k1_scan2_c01.k1_scan2_c01(meta, tabs, lane, lane, bs, B=224, H=9,
                                  steps=233, steps_p=256, SEG=32, md=2)
    cells = torch.empty((32, 1024), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        k3_fix2_c01.k3_fix2_c01(meta, tabs, lane, lane, lane, cells,
                                cells.to(torch.uint8), lane, bs, steps_p=256,
                                SEG=32, md=2)
