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

from huffmandecoderongpus_tpu_torch.ops import k4_stripped as k4s
from huffmandecoderongpus_tpu_torch.ops import probe_arith as pa
from huffmandecoderongpus_tpu_torch.ops import probe_gather as pg
from huffmandecoderongpus_tpu_torch.ops import probe_inc as pi
from huffmandecoderongpus_tpu_torch.probes import probe_gather as port_gather
from huffmandecoderongpus_tpu_torch.probes import probe_vpu as port_vpu
from huffmandecoderongpus_tpu_torch.probes import probe_vpu2 as port_vpu2

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


# ---- hw_k4probe.py: _k4_stripped (P4) --------------------------------------


@pytest.mark.parametrize("cells_p", [128, 130])
@pytest.mark.parametrize("stage", k4s.STAGES)
def test_k4_stripped_matches_script(cells_p, stage):
    G, ORP = 256, 256
    R = G // 128
    cells_pp = -(-cells_p // 128) * 128
    rng = np.random.default_rng(cells_p)
    sym = rng.integers(0, 2**31, (cells_p, R, 128), dtype=np.int64).astype(
        np.int32)
    sym[rng.random(sym.shape) < 0.3] *= -1
    nib = rng.integers(0, 256, (cells_p, R, 128)).astype(np.uint8)
    # the script's specs (hw_k4probe.py:112-127)
    RT = 8 if R % 8 == 0 else R
    spec = pl.BlockSpec((cells_p, RT, 128), lambda t: (0, t, 0))
    kern = functools.partial(script("hw_k4probe")._k4_stripped,
                             cells_p=cells_p, cells_pp=cells_pp, ORP=ORP,
                             RT=RT, stage=stage)
    want = np.asarray(pl.pallas_call(
        kern, grid=(R // RT,), in_specs=[spec, spec],
        out_specs=pl.BlockSpec((RT * 128, ORP), lambda t: (t, 0)),
        out_shape=jax.ShapeDtypeStruct((G, ORP), jnp.uint8),
        interpret=True)(jnp.asarray(sym), jnp.asarray(nib)))
    # the port's K4 layout: (cells_p, G), lane g = r * 128 + lane
    got = k4s.k4_stripped(torch.from_numpy(sym.reshape(cells_p, G)),
                          torch.from_numpy(nib.reshape(cells_p, G)), ORP=ORP,
                          stage=stage)
    assert got.dtype == torch.uint8 and got.shape == (G, ORP)
    np.testing.assert_array_equal(got.numpy(), want)
    assert not got[:, 128:].any()


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
], ids=["xor3-P3", "mul3-int16", "body", "chain-C96", "gather-int64",
        "k4-ORP64", "k4-stage"])
def test_wrappers_refuse(call):
    with pytest.raises(ValueError):
        call()
