"""The port's multi-device layer against the JAX package, on the CPU.

The JAX side runs on the 8 virtual CPU devices of ``tests/conftest.py``;
the port on ``make_mesh(devices=["cpu"] * D)``, D virtual shards whose
kernel wrappers run their plain versions.  Seeded streams only.
Tolerance: 0 everywhere (integer outputs, compared shard for shard).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from huffmandecoderongpus_tpu import native
from huffmandecoderongpus_tpu.huffio.bitio import payload_to_words_u32
from huffmandecoderongpus_tpu.huffio.encoder import encode_bytes
from huffmandecoderongpus_tpu.models import all_decoders as jax_decoders
from huffmandecoderongpus_tpu.ops.lut import build_decode_lut
from huffmandecoderongpus_tpu.parallel import block_decode as jbd
from huffmandecoderongpus_tpu.parallel import lane_sharded as jls
from huffmandecoderongpus_tpu.parallel import make_mesh as jax_mesh
from huffmandecoderongpus_tpu_torch import huffio
from huffmandecoderongpus_tpu_torch.harness import cli
from huffmandecoderongpus_tpu_torch.harness.scaling import (
    format_sweep,
    scaling_sweep,
)
from huffmandecoderongpus_tpu_torch.models import all_decoders, get_decoder
from huffmandecoderongpus_tpu_torch.ops import k2_compose, lanedfa_decode
from huffmandecoderongpus_tpu_torch.ops import widescan
from huffmandecoderongpus_tpu_torch.ops.candidate_scan import candidate_scan
from huffmandecoderongpus_tpu_torch.ops.k1_scan2 import k1_scan2
from huffmandecoderongpus_tpu_torch.ops.lane_scan import lane_scan
from huffmandecoderongpus_tpu_torch.ops.lanedfa import EnvelopeError
from huffmandecoderongpus_tpu_torch.parallel import (
    Mesh,
    block_decode,
    lane_sharded,
    make_mesh,
)
from test_torch_md1 import _spy
from torch_streams import md1, text_like


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op torch thread while this module runs (its plain scans are
    row loops of small ops; workers side by side stall one another in
    torch's thread pool otherwise)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def cpu_mesh(D):
    return make_mesh(devices=["cpu"] * D)


def stream(name):
    """(raw, HuffFile): ``text`` 8,000 text-like bytes (md 2, height 9),
    ``small`` 400 and ``tiny`` 60 of them, ``eight`` 40,000 bytes over 8
    skewed symbols."""
    rng = np.random.default_rng(
        {"text": 5, "small": 6, "tiny": 11, "eight": 7}[name])
    if name == "eight":
        p = np.array([0.35, 0.2, 0.12, 0.1, 0.08, 0.06, 0.05, 0.04])
        raw = rng.choice(np.arange(8, dtype=np.uint8), size=40000,
                         p=p / p.sum()).astype(np.uint8)
    else:
        raw = text_like(rng, {"text": 8000, "small": 400, "tiny": 60}[name])
    return raw, encode_bytes(raw)


# ---------------------------------------------------------------------------
# the mesh


def test_make_mesh_virtual_shards_and_limits():
    mesh = cpu_mesh(3)
    assert mesh.size == 3 and mesh.first == 0 and mesh.group is None
    assert list(mesh.shards) == [0, 1, 2]
    assert all(d == torch.device("cpu") for d in mesh.devices)
    assert make_mesh(2, devices=["cpu"] * 3).size == 2
    with pytest.raises(ValueError, match="asked for 4 devices"):
        make_mesh(4, devices=["cpu"] * 3)


def test_make_mesh_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        make_mesh()


def test_all_gather_maps_stacks_in_shard_order():
    from huffmandecoderongpus_tpu_torch.parallel import all_gather_maps

    maps = [torch.full((5,), d, dtype=torch.int32) for d in range(3)]
    out = all_gather_maps(cpu_mesh(3), maps)
    assert out.shape == (3, 5)
    np.testing.assert_array_equal(out[:, 0].numpy(), [0, 1, 2])


def test_distributed_init_single_process_is_a_no_op(monkeypatch):
    from huffmandecoderongpus_tpu_torch.parallel import distributed_init

    monkeypatch.delenv("HUFF_NUM_PROCESSES", raising=False)
    monkeypatch.delenv("HUFF_COORDINATOR", raising=False)
    assert distributed_init() is None
    assert distributed_init(num_processes=1) is None


# ---------------------------------------------------------------------------
# block decode (spec_sharded)


@pytest.mark.parametrize("name,D", [("text", 1), ("text", 2), ("text", 3),
                                    ("text", 8), ("tiny", 8)])
def test_block_decode_matches_jax(name, D):
    raw, hf = stream(name)
    lut = build_decode_lut(hf.tree)
    words = payload_to_words_u32(hf.payload, hf.bits, extra_words=2)
    (js, jc, jt, je), jS = jbd.decode_sharded_arrays(
        jnp.asarray(words), jnp.asarray(lut.sym), jnp.asarray(lut.length),
        bits=hf.bits, size=hf.uncompressed_size, height=lut.height,
        mesh=jax_mesh(D))
    (s, c, t, e), S = block_decode.decode_sharded_arrays(
        torch.from_numpy(words.view(np.int32)), torch.from_numpy(lut.sym),
        torch.from_numpy(lut.length), bits=hf.bits,
        size=hf.uncompressed_size, height=lut.height, mesh=cpu_mesh(D))
    js, jc = np.asarray(js), np.asarray(jc)
    assert S == jS and s.shape == (D, S)
    np.testing.assert_array_equal(c.numpy(), jc)
    np.testing.assert_array_equal(t.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(e.numpy(), np.asarray(je))
    for d in range(D):
        np.testing.assert_array_equal(s[d, :c[d]].numpy(), js[d, :jc[d]])
    if name == "tiny":  # trailing blocks start at or past the stream end
        assert (D - 1) * S >= hf.bits and c[-1] == 0
    np.testing.assert_array_equal(
        block_decode.decode_sharded(hf, mesh=cpu_mesh(D)), raw)


def test_block_geometry_keeps_the_jax_rule():
    # S = max(ceil(bits / D), height) rounded up to 32; 2^L >= S
    assert block_decode.block_geometry(1000, 8, 9) == (128, 7)
    assert block_decode.block_geometry(100, 8, 20) == (32, 5)
    assert block_decode.block_geometry(65, 1, 3) == (96, 7)


# ---------------------------------------------------------------------------
# lane-DFA body (lane_sharded)


def _jax_lane_body(hf, D, lanes):
    run, _ = jls.lane_sharded_runner(hf, mesh=jax_mesh(D), lanes=lanes,
                                     use_pallas=False)
    return [np.asarray(x) for x in run()]


@pytest.mark.parametrize("name,D,lanes", [
    ("text", 1, 64), ("text", 2, None), ("text", 2, 64), ("text", 8, 64),
    ("small", 8, None)])
def test_lane_body_matches_jax_xla_body(name, D, lanes):
    raw, hf = stream(name)
    jsym, jval, jn, jtot = _jax_lane_body(hf, D, lanes)
    run, materialize = lane_sharded.lane_sharded_runner(
        hf, mesh=cpu_mesh(D), lanes=lanes)
    out, total = run()
    Gl = jsym.shape[1] // D
    for d, (sym, valid, n) in enumerate(out):
        cols = slice(d * Gl, (d + 1) * Gl)
        np.testing.assert_array_equal(sym.numpy(), jsym[:, cols])
        np.testing.assert_array_equal(valid.numpy(), jval[:, cols])
        np.testing.assert_array_equal(n.numpy(), jn[cols])
    assert int(total) == int(jtot[0]) == hf.uncompressed_size
    got, tot = materialize((out, total))
    np.testing.assert_array_equal(got, raw)


def test_lane_shards_past_the_stream_end_decode_nothing():
    # the small stream at 8 shards: lanes of 512 bits, shards 4-7 start
    # past the stream, so the scans get N - lane0*B <= 0 and no lane is live
    _, hf = stream("small")
    dfa = lanedfa_decode.build_lane_dfa(hf.tree)
    H = dfa.height
    G = lane_sharded.lane_sharded_geometry(hf.bits, H, 8)
    mat, B = lanedfa_decode.bits_matrix(hf.payload, hf.bits, G, H,
                                        round_to=512)
    tab = torch.from_numpy(lanedfa_decode.pad_table(dfa.entry))
    past = [d for d in range(8) if hf.bits - d * B <= 0]
    assert G == 8 and B == 512 and past == [4, 5, 6, 7]
    for d in past:
        bits_d = torch.from_numpy(np.ascontiguousarray(mat[:, d:d + 1]))
        cnt, ex = candidate_scan(bits_d, tab, B=B, H=H, N=hf.bits - d * B)
        assert not cnt.any() and not ex.any()
        sym, valid = lane_scan(bits_d, tab, torch.zeros(1, dtype=torch.int32),
                               B=B, H=H, N=hf.bits - d * B)
        assert not valid.any()


# ---------------------------------------------------------------------------
# compose's shard map and seeded entries


def _numpy_fold(cnt, ex, start, base):
    H, G = cnt.shape
    off = start if 0 <= start < H else 0
    entry, bases, n = [], [], []
    for g in range(G):
        entry.append(off)
        bases.append(base)
        n.append(cnt[off, g])
        base += cnt[off, g]
        off = ex[off, g] if 0 <= ex[off, g] < H else 0
    return np.array(entry), np.array(bases), np.array(n), base


@pytest.mark.parametrize("G", [1, 2, 7, 64])
def test_compose_seeded_and_shard_map_equal_a_numpy_fold(G):
    rng = np.random.default_rng(G)
    H = 9
    cnt = rng.integers(0, 50, size=(H, G)).astype(np.int32)
    ex = rng.integers(-1, H + 2, size=(H, G)).astype(np.int32)
    tc, te = torch.from_numpy(cnt), torch.from_numpy(ex)
    old = lanedfa_decode.compose(tc, te)
    for a, b in zip(old, lanedfa_decode.compose(tc, te, 0, 0)):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    for start, base in ((0, 0), (3, 17), (H - 1, 5), (H + 2, 4)):
        want = _numpy_fold(cnt, ex, start, base)
        got = lanedfa_decode.compose(tc, te, torch.tensor(start), base)
        for w, g in zip(want, got):
            np.testing.assert_array_equal(g.numpy(), w)
    sh_ex, sh_cnt = lanedfa_decode.shard_map_of(tc, te)
    for o in range(H):
        entry, _b, n, total = _numpy_fold(cnt, ex, o, 0)
        last = entry[-1]
        nxt = ex[last, -1] if 0 <= ex[last, -1] < H else 0
        assert sh_cnt[o] == total and sh_ex[o] == nxt


# ---------------------------------------------------------------------------
# wide body (lane_sharded_wide)


def test_wide_body_shards_equal_the_unsharded_plain_program():
    raw, hf = stream("text")
    D = 2
    trace = {}
    run, materialize = lane_sharded.lane_sharded_wide_runner(
        hf, mesh=cpu_mesh(D))
    out, total = run(trace)
    got, tot = materialize((out, total))
    np.testing.assert_array_equal(got, native.simple_decode(hf))
    assert tot == hf.uncompressed_size
    # the unsharded plain K1 and K2 at the same geometry
    st = lane_sharded.wide_sharded_staging(hf, D, device="cpu")
    p = st["plan"]
    Gl = p["G"] // D
    wmat = widescan.words_matrix(st["words"], -(-p["steps_p"] // 32))
    k1 = k1_scan2(wmat, st["tab"], st["lim"], B=p["B"], H=st["H"],
                  steps=p["steps"], steps_p=p["steps_p"], SEG=p["SEG"],
                  md=st["md"], C0=st["C0"], C1=st["C1"], NS=st["NS"])
    entry, _ = k2_compose.k2_compose(k1[3], 0)
    assert trace["all_tot"].shape == (D, 128)
    for d, sh in enumerate(trace["shards"]):
        cols = slice(d * Gl, (d + 1) * Gl)
        for mine, whole in zip(sh["k1"], k1):
            np.testing.assert_array_equal(mine.numpy(), whole[:, cols].numpy())
        # the (D, 128) maps fold to the unsharded K2's entries
        assert trace["my_e"][d] == int(entry[d * Gl]) == sh["start"]
        np.testing.assert_array_equal(sh["entry"].numpy(),
                                      entry[cols].numpy())


@pytest.mark.parametrize("D", [pytest.param(2, marks=pytest.mark.interpret),
                               pytest.param(4, marks=pytest.mark.interpret)])
def test_wide_body_matches_jax_pallas_interpret(D):
    rng = np.random.default_rng(8)
    raw = text_like(rng, 20000)
    hf = encode_bytes(raw)
    run, _ = jls.lane_sharded_wide_runner(hf, mesh=jax_mesh(D), lanes=1024)
    jdense, jn, jtot, _fence = (np.asarray(x) for x in run())
    prun, materialize = lane_sharded.lane_sharded_wide_runner(
        hf, mesh=cpu_mesh(D), lanes=1024)
    out, total = prun()
    np.testing.assert_array_equal(
        torch.cat([dense for dense, _n in out]).numpy(), jdense)
    np.testing.assert_array_equal(torch.cat([n for _d, n in out]).numpy(), jn)
    assert int(total) == int(jtot[0]) == hf.uncompressed_size
    np.testing.assert_array_equal(materialize((out, total))[0], raw)


def test_wide_geometry_keeps_the_jax_rule():
    _, hf = stream("text")
    for D in (1, 2, 4):
        st = lane_sharded.wide_sharded_staging(hf, D, device="cpu")
        G = st["plan"]["G"]
        assert G % (128 * D) == 0 and G // D >= 512
    with pytest.raises(EnvelopeError, match="chunk2"):
        rng = np.random.default_rng(9)
        lane_sharded.wide_sharded_staging(encode_bytes(md1(rng, 20000)), 2,
                                          device="cpu")


# ---------------------------------------------------------------------------
# indexed body


def test_indexed_body_matches_jax_and_the_input():
    raw, hf = stream("eight")
    hf = encode_bytes(raw, block_symbols=256)
    run, _ = jls.lane_sharded_indexed_runner(hf, *hf.index, mesh=jax_mesh(2))
    jdense = np.asarray(run()[0])
    prun, materialize = lane_sharded.lane_sharded_indexed_runner(
        hf, *hf.index, mesh=cpu_mesh(2))
    out = prun()
    assert len(out) == 2 and out[0].shape[0] == jdense.shape[0] // 2
    np.testing.assert_array_equal(torch.cat(out).numpy(), jdense)
    np.testing.assert_array_equal(materialize(out), raw)
    np.testing.assert_array_equal(lane_sharded.decode_lane_sharded_indexed(
        hf, *hf.index, mesh=cpu_mesh(2)), raw)


def test_indexed_body_refuses_md1():
    rng = np.random.default_rng(10)
    raw = (rng.random(60000) < 0.25).astype(np.uint8)
    hf = encode_bytes(raw, block_symbols=256)
    with pytest.raises(EnvelopeError):
        lane_sharded.decode_lane_sharded_indexed(hf, *hf.index,
                                                 mesh=cpu_mesh(2))


# ---------------------------------------------------------------------------
# registry


SHARDED = ("spec_sharded", "lane_sharded_wide", "lane_sharded")


def test_registry_names_the_jax_twenty():
    names = set(all_decoders(device="cpu"))
    assert names == set(jax_decoders()) and len(names) == 20
    for n in SHARDED:
        assert all_decoders(device="cpu")[n].backend == "cuda-sharded"


@pytest.mark.parametrize("name", SHARDED)
@pytest.mark.parametrize("param", [None, 2])
def test_sharded_entries_decode(name, param):
    raw, hf = stream("text")
    out = get_decoder(name, device="cpu")(hf, param)
    np.testing.assert_array_equal(out, raw)


@pytest.mark.parametrize("name", SHARDED)
def test_sharded_bad_size_header_raises(name):
    _, hf = stream("text")
    broken = dataclasses.replace(
        huffio.HuffFile(tree=hf.tree, bits=hf.bits,
                        uncompressed_size=hf.uncompressed_size,
                        payload=hf.payload),
        uncompressed_size=hf.uncompressed_size + 7)
    with pytest.raises(RuntimeError, match="decoded"):
        get_decoder(name, device="cpu")(broken, 2)


def test_lane_sharded_wide_falls_back_on_md1(monkeypatch):
    rng = np.random.default_rng(9)
    raw = md1(rng, 20000)
    hf = encode_bytes(raw)
    calls = _spy(monkeypatch, lane_sharded, "decode_lane_sharded")
    out = get_decoder("lane_sharded_wide", device="cpu")(hf)
    np.testing.assert_array_equal(out, raw)
    assert calls == [1]


def test_sharded_entries_on_cuda_need_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, hf = stream("tiny")
    for name in SHARDED:
        with pytest.raises(RuntimeError, match="cuda"):
            get_decoder(name, device="cuda")(hf)


# ---------------------------------------------------------------------------
# scaling sweep and the CLI's scaling command


@pytest.mark.parametrize("path", ["lane", "block"])
def test_scaling_sweep_over_virtual_shards(path):
    raw, hf = stream("small")
    points = scaling_sweep(hf, raw, repeats=1, path=path,
                           devices=["cpu"] * 2)
    assert [p.devices for p in points] == [1, 2]
    assert points[0].speedup == 1.0 and points[0].efficiency == 1.0
    assert all(p.min_seconds > 0 and p.gb_per_s > 0 for p in points)
    assert format_sweep(points).splitlines()[0].split() == [
        "devices", "min_s", "GB/s", "speedup", "efficiency"]


def test_scaling_sweep_rejects_a_wrong_decode():
    raw, hf = stream("text")
    wrong = raw.copy()
    wrong[3] ^= 1
    with pytest.raises(RuntimeError, match="wrong at 1 devices"):
        scaling_sweep(hf, wrong, repeats=1, path="block", devices=["cpu"])
    with pytest.raises(ValueError, match="unknown path"):
        scaling_sweep(hf, raw, path="mesh", devices=["cpu"])


def test_scaling_command(tmp_path, monkeypatch, capsys):
    raw, _ = stream("text")
    raw.tofile(tmp_path / "paper1")
    huffio.write_huff(tmp_path / "paper1.huff", huffio.encode_bytes(raw))
    monkeypatch.setenv("HUFF_FILES_DIR", str(tmp_path))
    monkeypatch.setenv("HUFF_CACHE_DIR", str(tmp_path / "cache"))
    cli.main(["scaling", "paper1", "block", "--device", "cpu", "--shards",
              "2", "--repeats", "1"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "scaling sweep on paper1 (block path):"
    assert [int(line.split()[0]) for line in lines[2:]] == [1, 2]
    assert "scaling" in cli.COMMANDS


def test_mesh_is_frozen():
    mesh = cpu_mesh(1)
    assert isinstance(mesh, Mesh)
    with pytest.raises(dataclasses.FrozenInstanceError):
        mesh.size = 2
