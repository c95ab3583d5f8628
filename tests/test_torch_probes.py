"""The probe kernels' plain versions against the scripts' own Pallas kernels.

The four probe kernels (``probe_inc``, ``probe_arith``, ``probe_gather``,
``k4_stripped``) port the ``pl.pallas_call`` sites of ``scripts/``.  On the
CPU their wrappers run the plain torch versions, which must equal:

- the scripts' kernels run in Pallas interpret mode, where a script makes
  its kernel outside ``main()`` (``probe_vpu2.make_arith`` and
  ``make_gather``, ``probe_gather.probe``, ``probe_vpu.probe_i16_gather``
  and ``probe_roll``, ``hw_k4probe._k4_stripped``);
- a jnp copy of the kernel's body, citing the script's line, where the
  script defines it inside ``main()`` or inside a timing function
  (``triv_k``, ``med_k``, ``grid_k``, ``probe_vpu.probe_arith``'s and
  ``probe_gather``'s bodies, ``probe_gather.py:54-55``).

The scripts load from ``scripts/`` by path and stay as they are.  Inputs
are seeded numpy; the chains run at S = 16 to 64 steps, past the point
(about 30 steps) where they overflow and wrap.  Tolerance: bit-exact
(integer outputs).
"""

import contextlib
import functools
import importlib.util
import io
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from huffmandecoderongpus_tpu_torch.ops import _build
from huffmandecoderongpus_tpu_torch.ops import k4_stripped as k4s
from huffmandecoderongpus_tpu_torch.ops import probe_arith as pa
from huffmandecoderongpus_tpu_torch.ops import probe_gather as pg
from huffmandecoderongpus_tpu_torch.ops import probe_inc as pi
from huffmandecoderongpus_tpu_torch.probes import probe_gather as port_gather
from huffmandecoderongpus_tpu_torch.probes import probe_vpu as port_vpu
from huffmandecoderongpus_tpu_torch.probes import probe_vpu2 as port_vpu2
from huffmandecoderongpus_tpu_torch.probes import streams as ps

SCRIPTS = pathlib.Path(__file__).resolve().parent.parent / "scripts"


@functools.cache
def script(name):
    """Module ``scripts/<name>.py``, loaded by path."""
    spec = importlib.util.spec_from_file_location(f"_script_{name}",
                                                  SCRIPTS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _x(seed=0):
    """The probes' (128, 128) int32 input: the script's arange % 128, with
    a seeded permutation so that rows differ."""
    rng = np.random.default_rng(seed)
    return rng.permutation(128 * 128).reshape(128, 128).astype(np.int32) % 128


# ---- probe_vpu2: make_arith (P2 xor3) and make_gather (P3 chained) --------


@pytest.mark.parametrize("P,S", [(1, 16), (4, 40), (8, 64)])
def test_arith_xor3_matches_make_arith(P, S):
    x = _x(P)
    with pltpu.force_tpu_interpret_mode():
        run, nops = script("probe_vpu2").make_arith(P, S)
        want = np.asarray(run(jnp.asarray(x)))
    assert nops == 2 * P * S == pa.OPS_A_STEP["xor3"] * P * S
    got = pa.probe_arith(torch.from_numpy(x), body="xor3", S=S, P=P)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("P,S", [(1, 16), (4, 40), (8, 64)])
def test_gather_chain_matches_make_gather(P, S):
    x = _x(10 + P)
    with pltpu.force_tpu_interpret_mode():
        run, nops = script("probe_vpu2").make_gather(P, S)
        want = np.asarray(run(jnp.asarray(x)))
    assert nops == P * S
    t = torch.from_numpy(x)
    np.testing.assert_array_equal(
        pg.probe_gather_chain(t, t, P=P, S=S).numpy(), want)


# ---- probe_gather.py: probe (axis 1) and the axis-0 kernel ----------------


@pytest.mark.parametrize("case", range(len(port_gather.AXIS1)))
def test_gather_axis1_matches_probe(case):
    label, axis, tab, idx = port_gather.cases()[case]
    assert axis == 1
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(script("probe_gather").probe(
            jnp.asarray(tab), jnp.asarray(idx), tab.shape))
    got = pg.probe_gather(torch.from_numpy(tab), torch.from_numpy(idx),
                          axis=1)
    np.testing.assert_array_equal(got.numpy(), want, err_msg=label)


def _k0(tab_ref, idx_ref, out_ref):
    # jnp copy of the kernel body at scripts/probe_gather.py:54-55
    out_ref[...] = jnp.take_along_axis(tab_ref[...], idx_ref[...], axis=0)


@pytest.mark.parametrize("case", range(len(port_gather.AXIS0)))
def test_gather_axis0_matches_body(case):
    label, axis, tab, idx = port_gather.cases()[len(port_gather.AXIS1)
                                                + case]
    assert axis == 0
    want = np.asarray(pl.pallas_call(
        _k0, out_shape=jax.ShapeDtypeStruct(tab.shape, tab.dtype),
        interpret=True)(jnp.asarray(tab), jnp.asarray(idx)))
    got = pg.probe_gather(torch.from_numpy(tab), torch.from_numpy(idx),
                          axis=0)
    np.testing.assert_array_equal(got.numpy(), want, err_msg=label)
    np.testing.assert_array_equal(got.numpy(),
                                  np.take_along_axis(tab, idx, axis=0))


# ---- probe_vpu.py: i16 gather and roll (print EXACT/WRONG) ----------------


def _lines(fn):
    buf = io.StringIO()
    with pltpu.force_tpu_interpret_mode(), contextlib.redirect_stdout(buf):
        fn()
    return buf.getvalue().splitlines()


def test_i16_gather_script_and_plain():
    lines = _lines(script("probe_vpu").probe_i16_gather)
    assert lines == ["i16 gather int16: EXACT", "i16 gather uint16: EXACT"]
    for dt in port_vpu.I16_CASES:
        tab, idx = port_vpu.i16_case(dt, "cpu")
        got = port_vpu._np(pg.probe_gather(tab, idx, axis=1))
        want = np.take_along_axis(port_vpu._np(tab),
                                  port_vpu._np(idx).astype(np.int64), axis=1)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_roll_script_and_plain():
    lines = _lines(script("probe_vpu").probe_roll)
    assert len(lines) == len(port_vpu.ROLLS)
    assert all(line.endswith(": EXACT") for line in lines), lines
    for shape, shift, ax in port_vpu.ROLLS:
        x = port_vpu.roll_case(shape, "cpu")
        np.testing.assert_array_equal(pg.probe_roll(x, shift, axis=ax).numpy(),
                                      np.roll(x.numpy(), shift, axis=ax))


@pytest.mark.parametrize("shift", [0, 1, 127, -5, 300])
def test_roll_index_wraps(shift):
    rng = np.random.default_rng(shift & 0xFF)
    x = rng.integers(-1000, 1000, (6, 128)).astype(np.int32)
    for ax in (0, 1):
        got = pg.probe_roll(torch.from_numpy(x), shift, axis=ax).numpy()
        np.testing.assert_array_equal(got, np.roll(x, shift, axis=ax))


def _roll_k(x_ref, o_ref, *, shift, ax):
    # the kernel of scripts/probe_vpu.py:129-133, there defined inside
    # probe_roll's loop
    o_ref[...] = pltpu.roll(x_ref[...], shift, axis=ax)


@pytest.mark.parametrize("case", range(len(port_vpu.ROLLS)))
def test_roll_plain_matches_script_kernel(case):
    shape, shift, ax = port_vpu.ROLLS[case]
    x = np.random.default_rng(case).integers(-2**31, 2**31, shape,
                                             dtype=np.int64).astype(np.int32)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(pl.pallas_call(
            functools.partial(_roll_k, shift=shift, ax=ax),
            in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM)],
            out_specs=pl.BlockSpec(memory_space=pltpu.VMEM),
            out_shape=jax.ShapeDtypeStruct(shape, jnp.int32))(jnp.asarray(x)))
    got = pg.probe_roll_ref(torch.from_numpy(x), shift, axis=ax)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        pg.probe_roll(torch.from_numpy(x), shift, axis=ax).numpy(), want)


@pytest.mark.parametrize("dtype", [np.int32, np.int16, np.uint16, np.uint8])
@pytest.mark.parametrize("turns,extra", [(-1, -3), (0, -5), (0, 0), (1, 0),
                                         (1, 7), (3, 1)],
                         ids=["-W-3", "-5", "0", "W", "W+7", "3W+1"])
def test_roll_matches_np_roll(dtype, turns, extra):
    # shifts of turns times the axis' length plus extra: below zero, zero,
    # the length and past it, on both axes
    rng = np.random.default_rng(turns + 10)
    x = rng.integers(0, np.iinfo(dtype).max, (7, 40)).astype(dtype)
    for ax in (0, 1):
        s = turns * x.shape[ax] + extra
        got = port_vpu._np(pg.probe_roll(torch.from_numpy(x), s, axis=ax))
        assert got.dtype == x.dtype
        np.testing.assert_array_equal(got, np.roll(x, s, axis=ax))


@pytest.mark.parametrize("itype", [np.int16, np.uint16])
@pytest.mark.parametrize("axis", [0, 1])
def test_gather_16bit_index_clamps(itype, axis):
    # the kernel reads int16 and uint16 indices as given: a negative int16
    # reads element 0, a uint16 past the axis (above 32,767 too) the last
    rng = np.random.default_rng(axis)
    tab = rng.integers(0, 1 << 20, (12, 40)).astype(np.int32)
    n = tab.shape[axis]
    info = np.iinfo(itype)
    idx = rng.integers(-3, n + 3, tab.shape)
    idx[0, :4] = (info.min, info.max, -1 if info.min else 40000, n)
    idx = idx.astype(itype)
    assert idx.min() < 0 if info.min else idx.max() > 32767
    got = pg.probe_gather(torch.from_numpy(tab), torch.from_numpy(
        idx.view(np.int16)).view(torch.uint16) if itype == np.uint16
        else torch.from_numpy(idx), axis=axis)
    want = np.take_along_axis(tab, np.clip(idx.astype(np.int64), 0, n - 1),
                              axis=axis)
    np.testing.assert_array_equal(got.numpy(), want)


# ---- hw_k4probe.py: _k4_stripped (P4) --------------------------------------


def _script_k4_stripped(sym, nib, ORP, stage):
    """The script's kernel (``hw_k4probe.py:42-78``) in interpret mode at
    its own specs (``hw_k4probe.py:112-127``) on (cells_p, G) inputs, G a
    multiple of 128 (lane g = r * 128 + lane)."""
    cells_p, G = sym.shape
    R = G // 128
    cells_pp = -(-cells_p // 128) * 128
    RT = 8 if R % 8 == 0 else R
    spec = pl.BlockSpec((cells_p, RT, 128), lambda t: (0, t, 0))
    kern = functools.partial(script("hw_k4probe")._k4_stripped,
                             cells_p=cells_p, cells_pp=cells_pp, ORP=ORP,
                             RT=RT, stage=stage)
    return np.asarray(pl.pallas_call(
        kern, grid=(R // RT,), in_specs=[spec, spec],
        out_specs=pl.BlockSpec((RT * 128, ORP), lambda t: (t, 0)),
        out_shape=jax.ShapeDtypeStruct((G, ORP), jnp.uint8),
        interpret=True)(jnp.asarray(sym.reshape(cells_p, R, 128)),
                        jnp.asarray(nib.reshape(cells_p, R, 128))))


@pytest.mark.parametrize("cells_p", [128, 130])
@pytest.mark.parametrize("stage", k4s.STAGES)
def test_k4_stripped_matches_script(cells_p, stage):
    G, ORP = 256, 256
    rng = np.random.default_rng(cells_p)
    sym = rng.integers(0, 2**31, (cells_p, G), dtype=np.int64).astype(
        np.int32)
    sym[rng.random(sym.shape) < 0.3] *= -1
    nib = rng.integers(0, 256, (cells_p, G)).astype(np.uint8)
    want = _script_k4_stripped(sym, nib, ORP, stage)
    got = k4s.k4_stripped(torch.from_numpy(sym), torch.from_numpy(nib),
                          ORP=ORP, stage=stage)
    assert got.dtype == torch.uint8 and got.shape == (G, ORP)
    np.testing.assert_array_equal(got.numpy(), want)
    assert not got[:, 128:].any()


@pytest.mark.parametrize("case", ps.P4_CASES)
@pytest.mark.parametrize("stage", k4s.STAGES)
def test_k4_stripped_cases_match_script(case, stage):
    # P4's edge cases at one script block of 128 lanes (the script takes
    # multiples of 128; G = 64 is a case of the kernel's plan alone)
    sym, nib, ORP = ps.p4_case(case, "cpu", G=128)
    got = k4s.k4_stripped(sym.contiguous(), nib.contiguous(), ORP=ORP,
                          stage=stage)
    want = _script_k4_stripped(sym.numpy(), nib.numpy(), ORP, stage)
    np.testing.assert_array_equal(got.numpy(), want)


# ---- the kernel's split, emulated ------------------------------------------


def byte_perm(x, y, s):
    """CUDA's ``__byte_perm(x, y, s)`` on uint32 arrays: byte n of the
    result is byte ((s >> 4n) & 7) of y:x."""
    both = [(np.asarray(v, np.uint32) >> np.uint32(8 * b)) & np.uint32(0xFF)
            for v in (x, y) for b in range(4)]
    return sum(both[(s >> (4 * n)) & 7] << np.uint32(8 * n)
               for n in range(4)).astype(np.uint32)


def add8(a, b):
    """``csrc/k4_stripped.cu`` add8: a + b a byte at a time, mod 256."""
    m, h = np.uint32(0x7F7F7F7F), np.uint32(0x80808080)
    return (((a & m) + (b & m)) ^ ((a ^ b) & h)).astype(np.uint32)


def pop4(v):
    """Each byte's low-nibble popcount, a byte each."""
    x = v & np.uint32(0x0F0F0F0F)
    x = (x & np.uint32(0x05050505)) + ((x >> np.uint32(1))
                                       & np.uint32(0x05050505))
    return (x & np.uint32(0x03030303)) + ((x >> np.uint32(2))
                                          & np.uint32(0x03030303))


def emulate_p4(sym, nib, ORP, stage, p):
    """P4's blocks in numpy as the kernel runs them: ``vec`` lanes' low
    bytes packed in a word (its sym packing by byte permutes), a thread's
    ``jr`` columns over every window (padded cells zero), in the prefix
    stage each window's range totals scanned a byte a lane for the carries
    and summed for wpre, the words transposed to lanes' rows by the
    kernel's byte permutes, the rows written out with zeros past 127."""
    cells_p, G = sym.shape
    vec, jr, LB = p["vec"], p["jr"], p["lanes"]
    LG, NJ, nb = LB // vec, 128 // jr, G // LB
    windows = -(-cells_p // 128)
    u = sym.view(np.uint32).reshape(cells_p, nb, LG, vec)
    v = nib.astype(np.uint32).reshape(cells_p, nb, LG, vec)
    if vec == 4:
        lo = byte_perm(u[..., 0], u[..., 1], 0x0040)
        hi = byte_perm(u[..., 2], u[..., 3], 0x0040)
        sp = byte_perm(lo, hi, 0x5410)
        vp = sum(v[..., b] << np.uint32(8 * b) for b in range(4))
    else:
        sp, vp = u[..., 0] & np.uint32(0xFF), v[..., 0]
    pad = windows * 128 - cells_p
    sp = np.concatenate([sp, np.zeros((pad, nb, LG), np.uint32)])
    vp = np.concatenate([vp, np.zeros((pad, nb, LG), np.uint32)])
    sp = sp.reshape(windows, NJ, jr, nb, LG)
    vp = vp.reshape(windows, NJ, jr, nb, LG).astype(np.uint32)
    acc = np.zeros((NJ, jr, nb, LG), np.uint32)
    wpre = np.zeros((nb, LG), np.uint32)
    for w in range(windows):
        if stage == "transpose":
            acc ^= sp[w] ^ vp[w]
            continue
        loc = np.cumsum(pop4(vp[w]), axis=1, dtype=np.uint32)
        run = loc[:, -1]                      # (NJ, nb, LG), each <= 4 jr
        assert (run & np.uint32(0xFF)).max() <= 4 * jr
        carry = np.zeros_like(run)
        for i in range(1, NJ):
            carry[i] = add8(carry[i - 1], run[i - 1])
        total = add8(carry[-1], run[-1])
        wpre = add8(wpre, total)
        acc ^= add8(carry[:, None], loc) ^ sp[w]
    acc = add8(acc, wpre)
    rows = np.zeros((nb, LB, 128), np.uint8)
    for q in range(jr // 4):
        a = [acc[:, 4 * q + k] for k in range(4)]     # (NJ, nb, LG)
        if vec == 4:
            t0, t1 = byte_perm(a[0], a[1], 0x5140), byte_perm(a[2], a[3],
                                                              0x5140)
            t2, t3 = byte_perm(a[0], a[1], 0x7362), byte_perm(a[2], a[3],
                                                              0x7362)
            words = [byte_perm(t0, t1, 0x5410), byte_perm(t0, t1, 0x7632),
                     byte_perm(t2, t3, 0x5410), byte_perm(t2, t3, 0x7632)]
        else:
            words = [byte_perm(byte_perm(a[0], a[1], 0x0040),
                               byte_perm(a[2], a[3], 0x0040), 0x5410)]
        for b, word in enumerate(words):              # lane lg * vec + b
            by = np.stack([(word >> np.uint32(8 * k)) & np.uint32(0xFF)
                           for k in range(4)], -1).astype(np.uint8)
            for n in range(NJ):                      # columns n jr + 4q ..
                rows[:, b::vec, n * jr + 4 * q:n * jr + 4 * q + 4] = by[n]
    out = np.zeros((G, ORP), np.uint8)
    out[:, :128] = rows.reshape(G, 128)
    return out


@pytest.mark.parametrize("case", ps.P4_CASES)
@pytest.mark.parametrize("stage", k4s.STAGES)
def test_k4_stripped_emulation_matches_plain(case, stage):
    sym, nib, ORP = ps.p4_case(case, "cpu")
    G = sym.shape[1]
    p = k4s.p4_plan(G, sym.data_ptr(), nib.data_ptr(), 0, ORP)
    assert p["vec"] == (1 if case == "offset" else 4)
    got = emulate_p4(sym.numpy(), nib.numpy(), ORP, stage, p)
    want = k4s.k4_stripped_ref(sym, nib, ORP=ORP, stage=stage).numpy()
    np.testing.assert_array_equal(got, want)
    # the same split with a lane a thread (what an offset view takes)
    q = k4s.p4_plan(G, 1, 0, 0, ORP)
    np.testing.assert_array_equal(
        emulate_p4(sym.numpy(), nib.numpy(), ORP, stage, q), want)


@pytest.mark.parametrize("G", [64, 128, 8192, 16_384])
def test_p4_plan_rules(G):
    # (a): 8,192 lanes in 256 blocks of 128 threads; every lane and column
    # once; shared memory under 48 KB
    for ptrs in ((0, 0), (4, 0), (0, 1)):
        p = k4s.p4_plan(G, *ptrs, 0, 1024)
        assert p["lanes"] * p["blocks"] == G
        assert (p["lanes"] // p["vec"]) * (128 // p["jr"]) == p["threads"]
        assert p["jr"] % 4 == 0 and 128 % p["jr"] == 0
        assert p["threads"] <= 1024 and p["threads"] % 32 == 0
        assert p["shared"] < 48 * 1024
        assert p["vec"] == (4 if ptrs == (0, 0) else 1)
        assert k4s.p4_plan_ok(p, G, 1024, *ptrs, 0)
    assert k4s.p4_plan(8192)["blocks"] == 256
    assert k4s.p4_plan(G, ORP=132)["store"] == 4
    assert k4s.p4_plan(G, out_ptr=8, ORP=1024)["store"] == 4


@pytest.mark.parametrize("change", [
    dict(lanes=64), dict(jr=16), dict(threads=256), dict(shared=5632 + 16),
    dict(vec=2), dict(store=8)])
def test_p4_plan_ok_refuses_other_plans(change):
    p = k4s.p4_plan(8192)
    assert not k4s.p4_plan_ok({**p, **change}, 8192, 1024, 0, 0, 0)


def test_p4_plan_ok_refuses_misaligned():
    p = k4s.p4_plan(8192)
    assert not k4s.p4_plan_ok(p, 8192, 1024, 4, 0, 0)      # 16-byte sym
    assert not k4s.p4_plan_ok(p, 8192, 1024, 0, 2, 0)      # 4-byte nib
    assert not k4s.p4_plan_ok(p, 8192, 132, 0, 0, 0)       # 16-byte rows
    assert not k4s.p4_plan_ok(p, 8192, 1024, 0, 0, 8)      # 16-byte out
    assert not k4s.p4_plan_ok(p, 8160, 1024, 0, 0, 0)      # G % 64


# ---- bodies defined inside the scripts' main() -----------------------------


def test_triv_matches_body():
    # jnp copy of triv_k, scripts/hw_dispatch.py:45-46 and
    # scripts/hw_k1fixed.py:50-51: o = x + 1, here at the int32 edges
    x = np.random.default_rng(1).integers(-2**31, 2**31, (8, 128),
                                          dtype=np.int64).astype(np.int32)
    x[0, :3] = (2**31 - 1, -1, -2**31)
    want = np.asarray(jnp.asarray(x) + 1)
    np.testing.assert_array_equal(pi.probe_inc(torch.from_numpy(x)).numpy(),
                                  want)


def test_triv5_matches_body():
    # hw_k1fixed.py:66-73: five triv_k chained
    x = np.random.default_rng(2).integers(-100, 100, (8, 128)).astype(
        np.int32)
    t = torch.from_numpy(x)
    for _ in range(5):
        t = pi.probe_inc(t)
    np.testing.assert_array_equal(t.numpy(), x + 5)


def test_grid_matches_body():
    # jnp copy of grid_k, scripts/hw_k1fixed.py:79-89: every scratch zeroed
    # at grid step 0, o = x + s1[0, 0] for each of the (1, 4) grid's blocks
    x = np.random.default_rng(3).integers(-2**31, 2**31, (4, 32, 128),
                                          dtype=np.int64).astype(np.int32)
    s1 = jnp.zeros((32, 128), jnp.int32)
    s2 = jnp.zeros((14, 32, 128), jnp.int32)
    s3 = jnp.zeros((12, 32, 128), jnp.int32)
    s4 = jnp.zeros((12, 32, 128), jnp.int32)
    want = np.stack([np.asarray(jnp.asarray(x[s]) + s1[0, 0])
                     for s in range(4)])
    out, work = pi.probe_grid(torch.from_numpy(x))
    np.testing.assert_array_equal(out.numpy(), want)
    np.testing.assert_array_equal(
        work.numpy(), np.concatenate([np.asarray(s2), np.asarray(s3),
                                      np.asarray(s4)]))
    assert work.shape == (pi.WORK_BLOCKS, 32, 128)


@pytest.mark.parametrize("S", [16, 64])
def test_mul3_matches_med_body(S):
    # jnp copy of med_k, scripts/hw_dispatch.py:58-61 (64 steps there)
    x = np.random.default_rng(S).integers(-2**31, 2**31, (32, 128),
                                          dtype=np.int64).astype(np.int32)
    want = jax.lax.fori_loop(0, S, lambda i, a: a * 3 + i, jnp.asarray(x))
    got = pa.probe_arith(torch.from_numpy(x), body="mul3", S=S)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("dtype", [np.int32, np.int16])
@pytest.mark.parametrize("S", [16, 48])
def test_addxor_matches_probe_arith_body(dtype, S):
    # jnp copy of probe_arith's kern, scripts/probe_vpu.py:35-44 (nops 8)
    info = np.iinfo(dtype)
    x = np.random.default_rng(S).integers(info.min, info.max, (128, 128),
                                          endpoint=True).astype(dtype)
    xj = jnp.asarray(x)

    def body(i, acc):
        a, b = acc
        for _ in range(4):
            a = a + b
            b = b ^ a
        return a, b

    a, b = jax.lax.fori_loop(0, S, body, (xj, xj + jnp.asarray(1, xj.dtype)))
    got = pa.probe_arith(torch.from_numpy(x), body="addxor", S=S)
    assert got.dtype == torch.from_numpy(x).dtype
    np.testing.assert_array_equal(got.numpy(), np.asarray(a + b))


@pytest.mark.parametrize("S", [1, 16, 40])
def test_broadcast_chain_matches_probe_gather_body(S):
    # jnp copy of probe_gather's kern, scripts/probe_vpu.py:67-74: row 0 of
    # the (8, 128) table broadcast, S chained gathers from idx
    rng = np.random.default_rng(S)
    tab = rng.integers(0, 1 << 20, (8, 128)).astype(np.int32)
    tab[0] = rng.permutation(128)
    idx = rng.integers(0, 128, (128, 128)).astype(np.int32)
    t = jnp.broadcast_to(jnp.asarray(tab)[0:1, :], (128, 128))
    want = jax.lax.fori_loop(
        0, S, lambda i, c: jnp.take_along_axis(t, c & 127, axis=1),
        jnp.asarray(idx))
    got = pg.probe_gather_chain(torch.from_numpy(tab), torch.from_numpy(idx),
                                P=1, S=S, broadcast=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---- the inputs the chained gathers are checked on ---------------------------


@pytest.mark.parametrize("P", pg.CHAINS)
def test_chain_check_input_tells_a_wrong_chain(P):
    # the script's input makes every chain a fixed point, so its sums are
    # the same at any S; the seeded permuted input shows a missed step or
    # another row
    x = port_vpu2.script_input("cpu")
    assert torch.equal(pg.probe_gather_chain(x, x, P=P, S=16),
                       pg.probe_gather_chain(x, x, P=P, S=0))
    xv = port_vpu2.permuted("cpu")
    want = pg.probe_gather_chain(xv, xv, P=P, S=16)
    assert not torch.equal(want, pg.probe_gather_chain(xv, xv, P=P, S=15))
    assert not torch.equal(want, pg.probe_gather_chain(xv.roll(1, 0), xv,
                                                       P=P, S=16))


def test_broadcast_check_input_tells_a_wrong_chain():
    # the script's broadcast chain stays at 1 whatever it does; the seeded
    # one shows a missed step and a kernel that reads its own row
    tab, idx = port_vpu.chain_case("cpu")
    assert (pg.probe_gather_chain(tab, idx, P=1, S=16,
                                  broadcast=True) == 1).all()
    tab, idx = port_vpu.chain_check_case("cpu")
    want = pg.probe_gather_chain(tab, idx, P=1, S=16, broadcast=True)
    assert not torch.equal(want, pg.probe_gather_chain(tab, idx, P=1, S=15,
                                                       broadcast=True))
    assert not torch.equal(want[:8], pg.probe_gather_chain(tab, idx[:8], P=1,
                                                           S=16))


# ---- the wrappers' checks ---------------------------------------------------


@pytest.mark.parametrize("call", [
    lambda: pa.probe_arith(torch.zeros((4, 4), dtype=torch.int32),
                           body="xor3", S=4, P=3),
    lambda: pa.probe_arith(torch.zeros((4, 4), dtype=torch.int16),
                           body="mul3", S=4),
    lambda: pa.probe_arith(torch.zeros((4, 4), dtype=torch.int32),
                           body="nope", S=4),
    lambda: pg.probe_gather_chain(torch.zeros((2, 96), dtype=torch.int32),
                                  torch.zeros((2, 96), dtype=torch.int32),
                                  P=1, S=1),
    lambda: pg.probe_gather(torch.zeros((2, 8), dtype=torch.int64),
                            torch.zeros((2, 8), dtype=torch.int32), axis=1),
    lambda: k4s.k4_stripped(torch.zeros((4, 64), dtype=torch.int32),
                            torch.zeros((4, 64), dtype=torch.uint8), ORP=64,
                            stage="prefix"),
    lambda: k4s.k4_stripped(torch.zeros((4, 64), dtype=torch.int32),
                            torch.zeros((4, 64), dtype=torch.uint8), ORP=128,
                            stage="full"),
    # a tensor off the CPU goes to require_cuda, which refuses it unless it
    # is CUDA, on the first tensor's device, and contiguous
    lambda: pg.probe_gather(torch.zeros((2, 8), dtype=torch.int32,
                                        device="meta"),
                            torch.zeros((2, 8), dtype=torch.int32), axis=1),
    lambda: _build.require_cuda("mixed", torch.zeros(4, device="meta"),
                                torch.zeros(4)),
    lambda: pg.probe_gather(torch.zeros((8, 2), dtype=torch.int32,
                                        device="meta").t(),
                            torch.zeros((2, 8), dtype=torch.int32,
                                        device="meta"), axis=1),
    lambda: _build.require_cuda("strided", torch.zeros((4, 4))[:, ::2]),
    lambda: pi.probe_inc(torch.zeros((8, 128), dtype=torch.int32,
                                     device="meta")),
    lambda: pg.probe_roll(torch.zeros((8, 128), dtype=torch.int32,
                                      device="meta"), 3, axis=1),
    lambda: pg.probe_gather(torch.zeros((2, 8), dtype=torch.int32),
                            torch.zeros((2, 8), dtype=torch.int64), axis=1),
    lambda: pg.probe_gather(torch.zeros((2, 8), dtype=torch.int32),
                            torch.zeros((2, 8), dtype=torch.uint8), axis=0),
    lambda: pg.probe_roll(torch.zeros((2, 8), dtype=torch.int64), 1, axis=1),
], ids=["xor3-P3", "mul3-int16", "body", "chain-C96", "gather-int64",
        "k4-ORP64", "k4-stage", "gather-meta-and-cpu", "mixed-devices",
        "gather-noncontiguous", "noncontiguous", "inc-meta", "roll-meta",
        "index-int64", "index-uint8", "roll-int64"])
def test_wrappers_refuse(call):
    with pytest.raises(ValueError):
        call()
