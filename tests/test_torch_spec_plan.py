"""S2's launch plan, its tile and pair launches emulated in numpy, and S4's
packed table and register walk, on the CPU.

``s2_plan``'s rules at heights 1-22 (m even and below the top kept level,
every level up to m int16, the halo at most a quarter of the tile, two
int16 buffers of the staged span in a block's 227 KB, whole waves, the
kept levels above m a pair launch each, no odd level) and the launcher's
refusals (``s2_plan_ok``); the tile launch (``csrc/spec_tile.cu``) block by
block in numpy: step0 staged over the tile and its halo cut at ``bits``,
the range shrinking level by level, every read inside the level below's
range, every kept offset written by one block; the pair launch
(``csrc/spec_pair.cu``) by its four loads.  Both against ``spec_double_ref``
chained, and the whole pipeline on them against the JAX
``speculative_decode_xla``'s ``(result, found_size)`` on seeded streams,
the tiny inputs, a stream cut 3 bits short and
``probes.streams.SPEC_CASES`` (several blocks a stream, bits off and on a
tile, a halo past the end, trees 17 and 22 tall).  S4: ``pack_table``'s
entries unpack to the table at heights 1, 9, 16, 17 and 22, and the
kernel's walk (a 96-bit buffer topped up a word ahead, the next window
from the entry's own shift) emulated step by step against the plain walk.
Tolerance 0 (integer outputs).
"""

import dataclasses
import importlib.util
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from huffmandecoderongpus_tpu.ops import speculative as jspec
from huffmandecoderongpus_tpu_torch import huffio
from huffmandecoderongpus_tpu_torch.ops import onethread, spec_double
from huffmandecoderongpus_tpu_torch.ops import spec_all_bits as s1
from huffmandecoderongpus_tpu_torch.ops import spec_pair, spec_query
from huffmandecoderongpus_tpu_torch.ops import spec_tile
from huffmandecoderongpus_tpu_torch.ops import speculative as spec
from huffmandecoderongpus_tpu_torch.ops.lut import build_decode_lut
from huffmandecoderongpus_tpu_torch.probes import streams as ps
from torch_streams import full_alphabet, text_like

SEED = 20
TINY = [b"a", b"ab", b"aab", b"x" * 7]


def _raw(name):
    rng = np.random.default_rng(SEED)
    if name == "text":  # height 9, 15 levels
        return text_like(rng, 20_000)
    if name == "alpha":
        return full_alphabet(rng, 1 << 14)
    if name == "u12":  # height 4, 15 levels
        return rng.choice(np.arange(65, 77, dtype=np.uint8), size=20_000)
    return np.frombuffer(TINY[int(name[4:])], dtype=np.uint8)


STREAMS = ["text", "alpha", "u12", *(f"tiny{i}" for i in range(len(TINY)))]
_CACHE = {}


def stream(name):
    """(raw, HuffFile, tile or None) of a stream, a SPEC_CASES case, or
    "cut" (text cut 3 bits short: raw None)."""
    if name not in _CACHE:
        if name in ps.SPEC_CASES:
            _CACHE[name] = ps.spec_case(name)
        elif name == "cut":
            _raw_, hf, _t = stream("text")
            _CACHE[name] = (None, huffio.HuffFile(
                tree=hf.tree, bits=hf.bits - 3,
                uncompressed_size=hf.uncompressed_size,
                payload=hf.payload[:(hf.bits + 4) // 8]), None)
        else:
            raw = _raw(name)
            _CACHE[name] = (raw, huffio.encode_bytes(raw), None)
    return _CACHE[name]


def staged(hf):
    plan, (w, s, ln) = spec.decode_device_arrays(hf, device="cpu")
    step0, sym = spec.spec_all_bits(w, s, ln, bits=plan.bits,
                                    height=plan.height)
    return plan, step0, sym


# ---- the plan ---------------------------------------------------------------

#: (bits, levels): small to kjv-sized streams at 8 MiB's 23 levels
SHAPES = [(10, 3), (1000, 5), (27_000, 13), (100_000, 17),
          (26_700_000, 23), (66_000_000, 23), (200_000_000, 26)]


def size_of(levels):
    """The smallest header size with ``levels`` doubling levels."""
    return (1 << (levels - 1)) + 1 if levels else 1


@pytest.mark.parametrize("height", range(1, 23))
def test_plan_rules(height):
    for bits, levels in SHAPES:
        for sms in (132, 114):
            p = spec_tile.s2_plan(bits, height, levels,
                                  size=size_of(levels), sms=sms)
            top, m, tile = p["top"], p["m"], p["tile"]
            assert top == (levels - 1) // 2 * 2
            assert m % 2 == 0 and 2 <= m <= top
            assert (1 << m) * height <= 32767  # every level up to m int16
            h = ((1 << m) - 1) * height
            assert p["halo"] == h and 4 * h <= tile and tile % 8 == 0
            assert p["span"] == -(-min(tile + h, bits) // 8) * 8
            assert p["shared"] == 4 * p["span"] <= 227 * 1024 // 2
            assert p["threads"] == 512
            assert p["blocks"] == -(-bits // tile)
            # the tile fills half an SM's shared memory, cut to whole
            # waves of two blocks an SM
            tile0 = (spec_tile.SPAN_MAX - h) // 8 * 8
            waves = -(-(-(-bits // tile0)) // (2 * sms))
            assert tile <= tile0 and p["blocks"] <= waves * 2 * sms
            # m is the largest that fits: m + 2 is past the top, past int16
            # or its halo past a fifth of the span
            m2 = m + 2
            h2 = ((1 << m2) - 1) * height
            assert (m2 > top or (1 << m2) * height > 32767
                    or 5 * h2 + 8 > spec_tile.SPAN_MAX)
            # the kept levels above m, one pair launch each; no odd level
            assert p["pairs"] == tuple(range(m + 2, top + 1, 2))
            assert p["launches"] == 1 + len(p["pairs"])
            assert spec_tile.s2_plan_ok(p, bits, height)


def test_plan_on_kjv_sized_text_is_eight_launches():
    p = spec_tile.s2_plan(26_700_000, 9, 23, size=5_504_597)
    assert (p["m"], p["halo"], p["pairs"]) == (8, 2295,
                                               (10, 12, 14, 16, 18, 20, 22))
    assert p["launches"] == 8 and p["blocks"] == 4 * 2 * 132
    assert p["segs"] == (1,) * 6 + (4967,)  # three spans of 20 past 20 MB


@pytest.mark.parametrize("levels", [0, 1, 2])
def test_plan_has_no_launch_below_three_levels(levels):
    p = spec_tile.s2_plan(1000, 9, levels, size=size_of(levels))
    assert p["m"] == 0 and p["pairs"] == () and p["launches"] == 0


@pytest.mark.parametrize("change", ["tile-8", "tile+4", "m+2", "m-1",
                                    "shared+4", "threads", "halo>tile/4",
                                    "past-int16"])
def test_launcher_refuses_other_plans(change):
    bits, height = 100_000, 9
    p = dict(spec_tile.s2_plan(bits, height, 17, size=size_of(17)))
    if change == "tile-8":
        p["tile"] -= 8  # the shared bytes no longer match
    elif change == "tile+4":
        p["tile"] += 4
        p["shared"] = 4 * -(-min(p["tile"] + p["halo"], bits) // 8) * 8
    elif change == "m+2":
        p["m"] += 2
    elif change == "m-1":
        p["m"] -= 1
    elif change == "shared+4":
        p["shared"] += 4
    elif change == "threads":
        p["threads"] = 1024
    elif change == "halo>tile/4":
        p["tile"] = 4 * p["halo"] - 8
        p["shared"] = 4 * -(-min(p["tile"] + p["halo"], bits) // 8) * 8
    else:
        height = 64  # 2^10 x 64 past int16, and past height 22
    assert not spec_tile.s2_plan_ok(p, bits, height)
    if change in ("tile+4", "m+2", "m-1", "halo>tile/4"):  # (m, tile) bad
        step0 = torch.zeros(bits, dtype=torch.int16)
        with pytest.raises(ValueError, match="refuses"):
            spec_tile.spec_tile(step0, bits=bits, height=height, m=p["m"],
                                tile=p["tile"])


def test_plan_takes_a_tile_and_refuses_one_too_small():
    p = spec_tile.s2_plan(14_000, 10, 12, size=size_of(12), tile=2048)
    assert (p["m"], p["tile"], p["blocks"]) == (4, 2048, 7)
    with pytest.raises(ValueError):
        # < 4 halos at m 2
        spec_tile.s2_plan(14_000, 10, 12, size=size_of(12), tile=100)
    with pytest.raises(ValueError):
        spec_tile.s2_plan(14_000, 10, 12, size=size_of(12), tile=2044)


# ---- the launches emulated --------------------------------------------------

def emulate_tile(step0, bits, height, m, tile):
    """The tile launch block by block: kept levels 2..m (int64 arrays)."""
    s0 = step0.numpy().astype(np.int64)
    assert s0.max(initial=0) <= height
    h = spec_tile.halo(m, height)
    outs = [np.full(bits, -7, dtype=np.int64) for _ in range(m // 2)]
    writes = np.zeros((m // 2, bits), dtype=np.int64)
    for lo in range(0, bits, tile):
        rest = bits - lo
        n_prev = min(tile + h, rest)
        src = s0[lo:lo + n_prev].copy()  # the staged step0, cut at bits
        span = spec_tile._span(bits, height, m, tile)
        assert span % 8 == 0 and n_prev <= span
        keep = min(tile, rest)
        for j in range(1, m + 1):
            n = min(tile + ((1 << m) - (1 << j)) * height, rest)
            assert n <= n_prev
            s = src[:n]
            t = np.arange(n) + s
            read = (s != -1) & (t < rest)
            assert (t[read] < n_prev).all()  # inside the level below
            w = np.where(read, src[np.clip(t, 0, n_prev - 1)], -1)
            r = np.where(read & (w != -1) & (t + w <= rest), s + w, -1)
            assert (r <= 32767).all()  # int16 in shared memory
            if j % 2 == 0:
                outs[j // 2 - 1][lo:lo + keep] = r[:keep]
                writes[j // 2 - 1, lo:lo + keep] += 1
            src, n_prev = r, n
    assert (writes == 1).all()  # every kept offset, one block
    return outs


def emulate_pair(K, bits):
    """The pair launch: kept level 2j + 2 from K, by its four loads."""
    K = K.numpy().astype(np.int64)
    b = np.arange(bits)

    def at(x, ok):
        return np.where(ok, K[np.clip(x, 0, bits - 1)], -1)

    a = K[b]
    c = at(b + a, (a != -1) & (b + a < bits))
    t = b + a
    o1 = np.where((a != -1) & (t < bits) & (c != -1) & (t + c <= bits),
                  a + c, -1)
    t1 = b + o1
    d = at(t1, (o1 != -1) & (t1 < bits))
    t2 = t1 + d
    e = at(t2, (d != -1) & (t2 < bits))
    o2 = np.where((d != -1) & (t2 < bits) & (e != -1) & (t2 + e <= bits),
                  d + e, -1)
    return np.where((o1 != -1) & (t1 < bits) & (o2 != -1)
                    & (t1 + o2 <= bits), o1 + o2, -1)


def emulated_levels(step0, plan, tile=None):
    """The kept levels as the tile and pair launches make them."""
    p = spec_tile.s2_plan(plan.bits, plan.height, plan.levels,
                          size=plan.size, tile=tile)
    kept = [step0]
    if p["m"]:
        kept += [torch.from_numpy(x).to(torch.int16) for x in emulate_tile(
            step0, plan.bits, plan.height, p["m"], p["tile"])]
    for k in p["pairs"]:
        dt = spec_double.level_dtype(k, plan.height)
        kept.append(torch.from_numpy(emulate_pair(kept[-1],
                                                  plan.bits)).to(dt))
    return p, kept


def chained(step0, plan):
    """The kept levels by ``spec_double_ref`` a level."""
    kept, s = [step0], step0
    for k in range(1, max(plan.levels, 1)):
        s = spec_double.spec_double_ref(
            s, bits=plan.bits, dtype=spec_double.level_dtype(k, plan.height))
        if k % 2 == 0:
            kept.append(s)
    return kept


CASES = [*STREAMS, "cut", *ps.SPEC_CASES]


@pytest.mark.parametrize("name", CASES)
def test_emulated_launches_match_chained_levels_and_jax(name):
    raw, hf, tile = stream(name)
    plan, step0, sym = staged(hf)
    p, kept = emulated_levels(step0, plan, tile)
    want = chained(step0, plan)
    assert len(kept) == len(want) == spec_query.kept_count(plan.levels)
    for j, (got, w) in enumerate(zip(kept, want)):
        assert got.dtype == w.dtype == spec_double.level_dtype(2 * j,
                                                               plan.height)
        assert torch.equal(got, w), f"kept level {2 * j}"
    q = dict(bits=plan.bits, size=plan.size, levels=plan.levels)
    result, found = spec_query.spec_query_ref(kept, sym, **q)
    jw, js, jl = jspec.decode_device_arrays(hf)[1]
    jr, jf = jspec.speculative_decode_xla(jw, js, jl, bits=plan.bits,
                                          size=plan.size,
                                          height=plan.height,
                                          levels=plan.levels)
    assert int(found) == int(jf)
    np.testing.assert_array_equal(result.numpy(), np.asarray(jr))
    if raw is None:
        assert int(found) == -1
    else:
        assert int(found) == raw.size
        np.testing.assert_array_equal(result.numpy(), raw)


@pytest.mark.parametrize("name", ps.SPEC_CASES)
def test_spec_cases_cover_their_edges(name):
    _raw_, hf, tile = stream(name)
    plan = spec.make_plan(hf.bits, hf.uncompressed_size,
                          build_decode_lut(hf.tree).height)
    p = spec_tile.s2_plan(plan.bits, plan.height, plan.levels,
                          size=plan.size, tile=tile)
    ends = [lo + p["tile"] for lo in range(0, plan.bits, p["tile"])]
    halo_past = any(e < plan.bits < e + p["halo"] for e in ends)
    block = 1 << spec_query.BLOCK_LEVELS
    assert ps.QUERY_BLOCK == block
    if name.startswith("fib"):
        assert plan.height == int(name[3:]) and p["blocks"] == 1
        assert (plan.height > s1.SHARED_HEIGHT) == (plan.height >= 15)
    elif name.startswith("cut"):
        # a taken -1 in the last block's prefix, or only in its threads'
        # own levels (the walk, emulated)
        assert plan.size == ps.CUT_SIZE and plan.size % block == 5
        bad = {part for _k, _n, _l, part, b in _emulated_query(name)[3]
               if b}
        assert bad == ({"prefix", "block"} if name == "cut-prefix"
                       else {"block"})
    elif name.startswith("text-block"):
        assert plan.size - block == int(name[10:] or 0)
    elif name == "h1-t16":
        assert plan.bits % p["tile"] == 0 and p["blocks"] == 5
    else:
        assert plan.bits % p["tile"] and p["blocks"] >= 4
        assert halo_past == (name != "alpha-t8192")
    if name == "text-halo-past":
        assert plan.bits - 3 * p["tile"] < 124 and p["blocks"] == 4


@pytest.mark.parametrize("name", ["text", "u12", "tiny3", "cut", "fib22"])
def test_wrappers_on_cpu_run_the_plain_versions(name):
    _raw_, hf, _tile = stream(name)
    plan, step0, _sym = staged(hf)
    p = spec_tile.s2_plan(plan.bits, plan.height, plan.levels,
                          size=plan.size)
    want = chained(step0, plan)
    got = spec_tile.spec_tile(step0, bits=plan.bits, height=plan.height,
                              m=p["m"], tile=p["tile"])
    assert all(torch.equal(g, w) for g, w in zip(got, want[1:]))
    for j, k in enumerate(p["pairs"]):
        lv = spec_pair.spec_pair(want[k // 2 - 1], bits=plan.bits,
                                 dtype=spec_double.level_dtype(k,
                                                               plan.height))
        assert torch.equal(lv, want[k // 2])
    assert all(torch.equal(g, w) for g, w in zip(
        spec.double_levels(step0, bits=plan.bits, height=plan.height,
                           levels=plan.levels, size=plan.size), want))


# ---- S4 ---------------------------------------------------------------------

TREE_HEIGHTS = {1: lambda: stream("tiny0")[1].tree,
                9: lambda: stream("text")[1].tree,
                16: lambda: ps.fib_tree_stream(np.random.default_rng(0), 17,
                                               10, 1)[1],
                17: lambda: stream("fib17")[1].tree,
                22: lambda: stream("fib22")[1].tree}


@pytest.mark.parametrize("height", sorted(TREE_HEIGHTS))
def test_packed_table_unpacks_to_the_table(height):
    lut = build_decode_lut(TREE_HEIGHTS[height]())
    assert lut.height == height
    sym, ln = torch.from_numpy(lut.sym), torch.from_numpy(lut.length)
    tab = onethread.pack_table(sym, ln)
    assert tab.dtype == torch.int16 and tab.numel() % 8 == 0
    assert tab.numel() == max(1 << height, 8)
    assert (tab[1 << height:] == 0).all()
    entries = tab[:1 << height].to(torch.int32)
    assert torch.equal((entries >> 5).to(torch.uint8), sym)
    assert torch.equal((entries & 31) + 1, ln)


def _fsr(lo, hi, s):
    return (((hi << 32) | lo) >> (s & 31)) & 0xFFFFFFFF


def _fslc(lo, hi, s):
    return ((((hi << 32) | lo) << min(s, 32)) >> 32) & 0xFFFFFFFF


def emulate_onethread(words, tab, bits, size, height):
    """The kernel's walk, step by step: (out, n); checks at each lookup
    that the buffer holds the stream's next 2h bits or more (those inside
    the words: past the pad word the buffer takes it again) and zeros past
    them, and that a word goes in only where it fits."""
    w = [x & 0xFFFFFFFF for x in words.tolist()]
    tab = [x & 0xFFFF for x in tab.tolist()]
    last = len(w) - 1
    stream_bits = sum(x << (32 * i) for i, x in enumerate(w))
    mask2 = ((1 << height) - 1) << 1
    two = 2 * height
    st = dict(b0=w[min(0, last)], b1=w[min(1, last)], b2=0,
              nxt=w[min(2, last)], next=2, avail=64, pos=0, n=0)
    out = [0] * size

    def step(e):
        b0, b1, b2 = st["b0"], st["b1"], st["b2"]
        assert st["avail"] >= two
        known = min(st["avail"], 32 * len(w) - st["pos"])
        buf = b0 | (b1 << 32) | (b2 << 64)
        assert buf & ((1 << known) - 1) == (stream_bits >> st["pos"]) & (
            (1 << known) - 1)
        assert buf >> st["avail"] == 0
        f = tab[(_fsr(b0, b1, e) & mask2) >> 1]
        ln = (e & 31) + 1
        st["b0"], st["b1"], st["b2"] = (_fsr(b0, b1, ln), _fsr(b1, b2, ln),
                                        b2 >> ln)
        st["avail"] -= ln
        st["pos"] += ln
        if st["n"] < size:
            out[st["n"]] = e >> 5
        st["n"] += 1
        return f

    e = tab[((st["b0"] << 1) & mask2) >> 1]
    while st["pos"] < bits:
        a = st["avail"]
        assert a < two or a == 64
        if a < 32:
            st["b0"] |= _fslc(0, st["nxt"], a)
            st["b1"] |= _fslc(st["nxt"], 0, a)
        else:
            st["b1"] |= _fslc(0, st["nxt"], a - 32)
            st["b2"] |= _fslc(st["nxt"], 0, a - 32)
        st["avail"] += 32
        assert st["avail"] <= 96
        st["next"] += 1
        st["nxt"] = w[min(st["next"], last)]
        while st["avail"] >= two and st["pos"] < bits:
            e = step(e)
    return torch.tensor(out, dtype=torch.uint8), st["n"]


@pytest.mark.parametrize("name,delta", [
    ("text", 0), ("u12", 0), ("tiny0", 0), ("tiny2", 0), ("cut", 0),
    ("text", -10), ("text", 7), ("fib17", 0), ("fib22", 0),
    ("h1-t16", 0)])
def test_emulated_walk_matches_the_plain_walk(name, delta):
    _raw_, hf, _tile = stream(name)
    hf = dataclasses.replace(hf, uncompressed_size=hf.uncompressed_size
                             + delta)
    plan, (w, s, ln) = spec.decode_device_arrays(hf, device="cpu")
    kw = dict(bits=plan.bits, size=plan.size, height=plan.height)
    tab = onethread.pack_table(s, ln)
    got, gn = emulate_onethread(w, tab, **kw)
    want, wn = onethread.onethread_ref(w, s, ln, **kw)
    assert gn == int(wn)
    assert torch.equal(got, want)


@pytest.mark.parametrize("bits,seg", [(1, 1), (5000, 1), (5000, 2),
                                      (5000, 5), (1_000_000, 7),
                                      (26_716_362, 4967)])
def test_pair_block_order_takes_every_block_once(bits, seg):
    # csrc/spec_pair.cu: nseg * seg blocks, physical block p takes block
    # (p % nseg) * seg + p / nseg, none past the last
    n = spec_pair.blocks(bits)
    nseg = -(-n // seg)
    order = [b for b in ((p % nseg) * seg + p // nseg
                         for p in range(nseg * seg)) if b < n]
    assert sorted(order) == list(range(n))
    if seg > 1:  # blocks a span apart run together
        assert all(b % seg == 0 for b in order[:min(nseg, len(order))])


@pytest.mark.parametrize("height", [1, 9, 20, 22])
def test_plan_orders_pairs_by_span_only_past_the_l2(height):
    for bits, size in ((26_716_362, 5_504_597), (59_694_639, 8_388_608),
                       (100_000, 20_000)):
        levels = (size - 1).bit_length()
        p = spec_tile.s2_plan(bits, height, levels, size=size)
        assert len(p["segs"]) == len(p["pairs"])
        for k, seg in zip(p["pairs"], p["segs"]):
            span = (1 << (k - 2)) * bits / size
            elem = spec_double.level_dtype(k - 2, height).itemsize
            far = 3 * span * elem >= spec_tile.SPAN_ORDER_BYTES
            assert (seg > 1) == (far and round(span / 1024) > 1)
            assert 1 <= seg <= spec_pair.blocks(bits)


# ---- S3: a block's prefix, then its tree --------------------------------------

REPO = pathlib.Path(__file__).resolve().parent.parent


def _chip_smoke():
    """chip_smoke.py as a module (its bounds), imported once."""
    if "cs" not in _CACHE:
        loader = importlib.util.spec_from_file_location(
            "chip_smoke", REPO / "chip_smoke.py")
        cs = importlib.util.module_from_spec(loader)
        loader.loader.exec_module(cs)
        _CACHE["cs"] = cs
    return _CACHE["cs"]


def emulate_query(kept, sym, *, bits, size, levels,
                  B=spec_query.BLOCK_LEVELS, threads=spec_query.THREADS,
                  shuf=spec_query.SHUFFLE_LEVELS):
    """The kernel's launch (``csrc/spec_query.cu``) block by block in
    numpy: thread 0 walks the block's prefix (base's bits >= B), warp 0
    expands ``shuf`` levels by shuffles (lane l the node base +
    l 2^(B-shuf)), then a level a round over the block's threads (node
    (2m + 1) 2^k from (2m) 2^k, m = thread + threads u), a node at or past
    ``size`` making no jump; then a thread an output.  Returns (result,
    found, jumps): a jump (level, node it leads to, kept loads, part:
    "prefix", "warp" or "block", its span -1) each edge walked."""
    lv = [k.numpy().astype(np.int64) for k in kept]
    sy = sym.numpy()
    jumps = []
    state = dict(bad=False, end=False)

    def jump(k, pos, node, part):
        at = min(pos, bits - 1)
        d1 = delta = int(lv[k // 2][at])
        if k % 2:  # the second load at a clamped offset, whatever d1 is
            t = pos + d1
            d2 = int(lv[k // 2][min(max(t, 0), bits - 1)])
            ok = d1 != -1 and t < bits and d2 != -1 and t + d2 <= bits
            delta = d1 + d2 if ok else -1
        jumps.append((k, node, 1 + k % 2, part, delta == -1))
        if delta == -1:
            state["bad"] = True
            return pos
        return pos + delta

    result = np.full(size, -1, dtype=np.int64)
    for base in range(0, size, 1 << B):
        p = 0
        for k in range(levels - 1, B - 1, -1):
            if base >> k & 1:
                p = jump(k, p, base >> k << k, "prefix")
        lanes = [p] * 32
        for r in range(shuf):
            b = shuf - 1 - r
            was = list(lanes)
            for lane in range(32):
                n = base + (lane << (B - shuf))
                if lane & ((2 << b) - 1) == 1 << b and n < size:
                    lanes[lane] = jump(B - 1 - r,
                                       was[lane & ~((2 << b) - 1)], n,
                                       "warp")
        pos = {lane << (B - shuf): p for lane, p in enumerate(lanes)}
        for k in range(B - shuf - 1, -1, -1):
            for t in range(threads):
                for m in range(t, 1 << (B - 1 - k), threads):
                    at = (2 * m + 1) << k
                    if base + at < size:
                        assert at not in pos  # one writer a node
                        pos[at] = jump(k, pos[(2 * m) << k], base + at,
                                       "block")
        for i in range(min(1 << B, size - base)):
            result[base + i] = sy[min(pos[i], bits - 1)]
            if base + i == size - 1:
                ln = int(lv[0][min(pos[i], bits - 1)])
                state["end"] = ln != -1 and pos[i] + ln == bits
    assert (result >= 0).all()
    found = size if state["end"] and not state["bad"] else -1
    return torch.from_numpy(result.astype(np.uint8)), found, jumps


def _ctz(n):
    return (n & -n).bit_length() - 1


def _jax_decode(name, hf, plan):
    if ("jax", name) not in _CACHE:
        jw, js, jl = jspec.decode_device_arrays(hf)[1]
        jr, jf = jspec.speculative_decode_xla(
            jw, js, jl, bits=plan.bits, size=plan.size, height=plan.height,
            levels=plan.levels)
        _CACHE["jax", name] = (np.asarray(jr), int(jf))
    return _CACHE["jax", name]


def _emulated_query(name):
    """(plan, result, found, jumps, plain result, plain found) of a case."""
    if ("query", name) not in _CACHE:
        _raw_, hf, _tile = stream(name)
        plan, step0, sym = staged(hf)
        kept = chained(step0, plan)
        q = dict(bits=plan.bits, size=plan.size, levels=plan.levels)
        _CACHE["query", name] = (plan, *emulate_query(kept, sym, **q),
                                 *spec_query.spec_query_ref(kept, sym, **q))
    return _CACHE["query", name]


@pytest.mark.parametrize("name", CASES)
def test_emulated_query_matches_plain_and_jax(name):
    raw, hf, _tile = stream(name)
    plan, result, found, _jumps, want, wfound = _emulated_query(name)
    assert found == int(wfound)
    assert torch.equal(result, want)
    jr, jf = _jax_decode(name, hf, plan)
    assert found == jf
    np.testing.assert_array_equal(result.numpy(), jr)
    assert found == (-1 if raw is None else raw.size)


@pytest.mark.parametrize("name", CASES)
def test_emulated_query_reads_each_edge_once(name):
    # every node n in 1..size-1 has its edge walked: a tree edge once in
    # the grid, a prefix edge (n a multiple of 2^B) once a block that
    # shares it; at level ctz(n), two loads where it is odd; so the
    # distinct edges read what chip_smoke.py spec_query_moved counts
    plan, _r, _f, jumps, _w, _wf = _emulated_query(name)
    B = spec_query.BLOCK_LEVELS
    tree = [n for _k, n, _l, part, _b in jumps if part != "prefix"]
    assert len(tree) == len(set(tree))
    assert all(n % (1 << B) for n in tree)
    assert all(n % (1 << B) == 0 for _k, n, _l, part, _b in jumps
               if part == "prefix")
    assert all(k == _ctz(n) and loads == 1 + k % 2
               for k, n, loads, _p, _b in jumps)
    first = {}  # each distinct edge's loads, its first walk
    for k, n, loads, _p, _b in jumps:
        first.setdefault(n, (k, loads))
    assert set(first) == set(range(1, plan.size))
    moved = 2 * plan.size + sum(
        spec_double.level_dtype(k - k % 2, plan.height).itemsize * loads
        for k, loads in first.values())
    assert moved == _chip_smoke().spec_query_moved(plan.size, plan.levels,
                                                   plan.height)
    # beside them, each block's prefix: at most its levels above B
    blocks = -(-plan.size >> B)
    prefix = len(jumps) - len(tree)
    assert prefix - sum(1 for n in first if n % (1 << B) == 0) <= (
        blocks * max(plan.levels - B, 0))


# ---- S1: runs of offsets on the packed table ------------------------------


def emulate_all_bits(words, lut_sym, lut_len, *, bits, height, sms=132,
                     per_sm=4):
    """The kernel's launch (``csrc/spec_all_bits.cu``) in numpy: the
    packed table (``pack_table``'s entry) whole in shared memory up to
    SHARED_HEIGHT, else its first level there and the rest from the packed
    table; a thread a run of RUN offsets from one 64-bit window,
    grid-stride over persistent blocks.  Returns (step0, sym, windows that
    read the device-memory table), checking that every offset is written
    by one run, every shift is 0..31 and every window ends inside the 64
    bits, and every word read lies inside ``words``."""
    packed = onethread.pack_table(lut_sym, lut_len).numpy().astype(
        np.int64) & 0xFFFF
    first_bits = min(height, s1.SHARED_HEIGHT)
    first = packed[:1 << first_bits]
    w = words.numpy().astype(np.int64) & 0xFFFFFFFF
    run = s1.RUN
    runs = -(-bits // run)
    grid = min(-(-runs // 512), sms * per_sm) * 512
    owner = np.arange(runs) % grid  # grid-stride: thread g, g + grid, ...
    assert np.bincount(owner, minlength=1).sum() == runs
    b0 = np.arange(runs, dtype=np.int64) * run
    q = b0 >> 5
    assert q.max() + 1 < w.size
    window = w[q] | (w[q + 1] << 32)
    step0 = np.zeros(bits, dtype=np.int64)
    sym = np.zeros(bits, dtype=np.int64)
    writes = np.zeros(bits, dtype=np.int64)
    far = 0
    for j in range(run):
        shift = (b0 & 31) + j
        assert shift.max() <= 31 and shift.max() + height <= 64
        win = (window >> shift) & ((1 << height) - 1)
        e = first[win & ((1 << first_bits) - 1)]
        if height > first_bits:
            miss = (e & 31) >= s1.SHARED_HEIGHT
            e = np.where(miss, packed[win], e)
            far += int(miss[b0 + j < bits].sum())
        ln = ((e & 31) + 1) & 31
        b = b0 + j
        keep = b < bits
        step0[b[keep]] = np.where(b + ln <= bits, ln, -1)[keep]
        sym[b[keep]] = (e >> 5)[keep]
        writes[b[keep]] += 1
    assert (writes == 1).all()
    return (torch.from_numpy(step0.astype(np.int16)),
            torch.from_numpy(sym.astype(np.uint8)), far)


def _jax_stage1(words, sym, length, height, bits):
    b = jnp.arange(bits, dtype=jnp.int32)
    win = jspec.extract_windows(jnp.asarray(words.numpy().view(np.uint32)), b,
                                height).astype(jnp.int32)
    ln = jnp.take(jnp.asarray(length.numpy()), win, mode="clip")
    sy = jnp.take(jnp.asarray(sym.numpy()), win, mode="clip")
    return np.asarray(jnp.where(b + ln <= bits, ln, -1)), np.asarray(sy)


def _check_all_bits(w, s, ln, bits, height):
    step0, sym, far = emulate_all_bits(w, s, ln, bits=bits, height=height)
    want = s1.spec_all_bits_ref(w, s, ln, bits=bits, height=height)
    assert torch.equal(step0, want[0]) and torch.equal(sym, want[1])
    js, jy = _jax_stage1(w, s, ln, height, bits)
    np.testing.assert_array_equal(step0.numpy(), js)
    np.testing.assert_array_equal(sym.numpy(), jy)
    return far


@pytest.mark.parametrize("name", CASES)
def test_emulated_all_bits_matches_plain_and_jax(name):
    _raw_, hf, _tile = stream(name)
    plan, (w, s, ln) = spec.decode_device_arrays(hf, device="cpu")
    far = _check_all_bits(w, s, ln, plan.bits, plan.height)
    if plan.height <= s1.SHARED_HEIGHT:
        assert far == 0


@pytest.mark.parametrize("height,name", [(1, "tiny0"), (9, "text"),
                                         (14, "fib14"), (15, "fib15"),
                                         (20, "fib20"), (22, "fib22")])
@pytest.mark.parametrize("cut", [0, 3, 13])
def test_emulated_all_bits_at_heights_and_stream_ends(height, name, cut):
    # a tail shorter than a run and the -1 cut at the stream's end: the
    # stream's last ``cut`` bits dropped (bits no multiple of RUN)
    _raw_, hf, _tile = stream(name)
    plan, (w, s, ln) = spec.decode_device_arrays(hf, device="cpu")
    assert plan.height == height
    bits = max(plan.bits - cut, 1)
    _check_all_bits(w, s, ln, bits, height)
    step0 = s1.spec_all_bits_ref(w, s, ln, bits=bits, height=height)[0]
    if cut:
        assert bits % s1.RUN and (step0[-1] == -1 or step0[-1] <= 1)


@pytest.mark.parametrize("name,lengths", [("text", (3, 9)),
                                          *ps.NO_CODE_CASES])
def test_zero_length_windows_keep_their_symbol(name, lengths):
    _raw_, hf, _tile = stream(name)
    height, s, ln = ps.table_without_codes(hf.tree, lengths)
    s, ln = torch.from_numpy(s), torch.from_numpy(ln)
    assert (ln == 0).any()
    # the entry keeps the symbol whole; length 0 packs as 31
    e = onethread.pack_table(s, ln)[:1 << height].to(torch.int32) & 0xFFFF
    assert torch.equal(e >> 5, s.to(torch.int32))
    assert torch.equal(((e & 31) + 1) & 31, ln)
    plan, (w, _s, _ln) = spec.decode_device_arrays(hf, device="cpu")
    far = _check_all_bits(w, s, ln, plan.bits, height)
    step0 = s1.spec_all_bits_ref(w, s, ln, bits=plan.bits, height=height)[0]
    assert (step0 == 0).any()
    if height > s1.SHARED_HEIGHT:
        assert far > 0
