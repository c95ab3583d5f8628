"""Trees of exactly 128 internal states, on the CPU.

A 129-symbol tree has 128 internal states: one table chunk (NS = 1), whose
readers (``ops/pair.py`` ``e1_fields``, ``ops/quad.py`` ``decode_entry``,
``csrc/widescan.cuh``) take the compact layout, and the 7-bit state field
of a compact entry holds states 0-127.  The port packs such a tree compact;
the JAX package packs it wide in one chunk, so its own readers misdecode it
(a deliberate divergence, ``ROADMAP.md`` Queue 3).  Here both 129-symbol
streams (md 1, and md >= 2) decode to their input through
``decode_widescan`` on the four-kernel program and, for md >= 2, the
one-shot route; ``from_jax_staging`` converts the JAX package's tables of
this shape; and the JAX package's count differs (interpret mode).
Tolerance: bit-exact.
"""

import numpy as np
import pytest

from huffmandecoderongpus_tpu import native
from huffmandecoderongpus_tpu.ops import pallas_widescan as jws
from huffmandecoderongpus_tpu_torch.ops import oneshot, widescan
from torch_streams import STATES128, as_numpy, make

NAMES = sorted(STATES128)


def _spy(monkeypatch, module, name):
    calls = []
    real = getattr(module, name)

    def wrapped(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(module, name, wrapped)
    return calls


@pytest.mark.parametrize("name", NAMES)
def test_128_states_pack_compact(name):
    _raw, hf = make(name, seed=1)
    st = widescan.stage_widescan_inputs(hf, device="cpu")
    assert st["dfa"].entry.shape[0] // 2 == 128 and st["NS"] == 1
    assert (st["md"] == 1) == (name == "s128md1")
    tab = st["tab"].numpy().astype(np.int64) & 0xFFFFFFFF
    assert tab[:, 127].all()  # state 127 is there
    # compact: every entry of a bit or chunk that emits has bit 7 set and
    # holds a next state below 128; none has the wide layout's emit bit
    # without it
    for half in (0, 1):
        e = (tab >> (16 * half)) & 0xFFFF
        assert not ((e & 0x8000) & ~((e & 0x80) << 8)).any()


@pytest.mark.parametrize("name", NAMES)
def test_128_states_decode(name, monkeypatch):
    raw, hf = make(name, seed=1)
    want = native.simple_decode(hf)
    np.testing.assert_array_equal(want, raw)
    four = ("k1_scan2", "k3_fix2") if name == "s128" else ("k1_scan",
                                                           "k3_fix")
    calls = [_spy(monkeypatch, widescan, k) for k in four]
    ones = _spy(monkeypatch, oneshot, "oneshot_program")
    out = widescan.decode_widescan(hf, device="cpu", oneshot=False)
    np.testing.assert_array_equal(out, raw)
    assert [len(c) for c in calls] == [1, 1] and not ones
    if name == "s128":  # the one-shot route, md >= 2 only
        st = widescan.stage_widescan_inputs(hf, device="cpu")
        assert oneshot.oneshot_eligible(st)
        out = widescan.decode_widescan(hf, device="cpu", oneshot=True)
        np.testing.assert_array_equal(out, raw)
        assert len(ones) == 1 and [len(c) for c in calls] == [1, 1]


@pytest.mark.parametrize("name", NAMES)
def test_128_states_from_jax_staging_converts(name):
    _raw, hf = make(name, seed=1)
    got = widescan.stage_widescan_inputs(hf, device="cpu")
    want = as_numpy(jws.stage_widescan_inputs(hf))
    # the JAX table is wide in one chunk, which differs ...
    assert not np.array_equal(got["tab"].numpy(), want["tabw"])
    carried = widescan.from_jax_staging(want, "cpu")
    # ... and is converted to the port's layout
    np.testing.assert_array_equal(carried["tab"].numpy(), got["tab"].numpy())
    assert carried["NS"] == 1


def test_128_states_indexed_staging_converts():
    # the indexed staging (md >= 2, a quad table) carries no tree
    raw, hf = make("s128", seed=1)
    from huffmandecoderongpus_tpu.huffio.encoder import encode_bytes

    hfi = encode_bytes(raw, block_symbols=256)
    got = widescan.stage_widescan_indexed(hfi, *hfi.index, device="cpu")
    want = as_numpy(jws.stage_widescan_indexed(hfi, *hfi.index))
    carried = widescan.from_jax_staging(want, "cpu")
    np.testing.assert_array_equal(carried["tab"].numpy(), got["tab"].numpy())
    out = widescan.decode_widescan_indexed(hfi, *hfi.index, device="cpu")
    np.testing.assert_array_equal(out, raw)


def test_tables_below_128_states_carry_as_they_are():
    # a JAX table of 127 states or fewer, or of more than one chunk, is the
    # port's already
    for name in ("text", "md1", "md1wide", "ns2"):
        _raw, hf = make(name)
        want = as_numpy(jws.stage_widescan_inputs(hf))
        carried = widescan.from_jax_staging(want, "cpu")
        np.testing.assert_array_equal(carried["tab"].numpy(), want["tabw"])


@pytest.mark.interpret
def test_jax_package_misdecodes_128_states():
    # the divergence: the JAX program decodes another count from the same
    # stream (its readers take its wide one-chunk table for compact)
    raw, hf = make("s128", seed=1)
    with pytest.raises(RuntimeError, match="header says 60000"):
        jws.decode_widescan(hf, interpret=True, oneshot=False)
    np.testing.assert_array_equal(
        widescan.decode_widescan(hf, device="cpu", oneshot=False), raw)
