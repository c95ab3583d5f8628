"""The port's min-code-length-1 path against the JAX package, on the CPU.

Trees with a 1-bit code run the 1-bit kernels ``k1_scan``/``k3_fix`` over
the pair table (``pack_pair_table``) in place of ``k1_scan2``/``k3_fix2``;
K2 and K4 are shared.  Stage parity: the JAX Pallas kernels run in
interpret mode (512 lanes), the port's plain torch versions take the same
staged inputs (``from_jax_staging``).  Slice parity: whole decodes equal
the raw input and the serial native oracle.  Tolerance: bit-exact
everywhere (integer outputs; the dense rows are compared up to each lane's
count, where the TPU kernel leaves unspecified bytes).
"""

import numpy as np
import pytest
import torch

from huffmandecoderongpus_tpu import native
from huffmandecoderongpus_tpu.ops import lanedfa as jlanedfa
from huffmandecoderongpus_tpu.ops import pallas_widescan as jws
from huffmandecoderongpus_tpu_torch.ops import k1_scan, k3_fix, widescan
from test_torch_widescan import (
    _assert_dense_equal,
    _assert_stages_equal,
    _jax_stages,
    _port_stages,
)
from torch_streams import MD1_SHAPES, SHAPES, as_numpy, make

MD1_NAMES = sorted(MD1_SHAPES)
ALL_STAGES = ["sym", "val", "cntmap", "exmap", "mrowmap", "entry", "tot", "n",
              "cut", "cut_slot", "msym", "mval"]


def _spy(monkeypatch, module, name):
    """Count the calls of ``module.name`` (still calling it)."""
    calls = []
    real = getattr(module, name)

    def wrapped(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(module, name, wrapped)
    return calls


@pytest.mark.parametrize("name", sorted(SHAPES) + MD1_NAMES)
def test_pack_pair_table_matches(name):
    _, hf = make(name)
    dfa = jlanedfa.build_lane_dfa(hf.tree)
    got = widescan.pack_pair_table(dfa)
    want = np.asarray(jws.pack_pair_table(dfa))
    assert got.dtype == np.int32 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    if name == "md1wide":
        assert got.shape[0] == 2  # the wide entry layout


@pytest.mark.parametrize("lanes", [512, None])
@pytest.mark.parametrize("name", MD1_NAMES)
def test_stage_md1_matches(name, lanes):
    _, hf = make(name)
    got = widescan.stage_widescan_inputs(hf, device="cpu", lanes=lanes)
    want = as_numpy(jws.stage_widescan_inputs(hf, lanes=lanes))
    assert got["chunk2"] is want["chunk2"] is False
    assert got["plan"] == want["plan"]
    for k in ("H", "md", "C0", "C1", "NS"):
        assert got[k] == want[k], k
    np.testing.assert_array_equal(got["tab"].numpy(), want["tabw"])
    np.testing.assert_array_equal(got["words"].numpy(), want["words"])
    np.testing.assert_array_equal(got["lim"].numpy(),
                                  want["lim2"].reshape(-1))
    carried = widescan.from_jax_staging(want, "cpu")
    assert carried["chunk2"] is False and carried["plan"] == got["plan"]
    for k in ("tab", "words", "lim"):
        assert torch.equal(carried[k], got[k]), k


@pytest.fixture(scope="module")
def md1_stages():
    """One interpret-mode JAX run of k1_scan/K2/k3_fix/K4 (~2 min) and the
    port's stages on the same staged inputs."""
    raw, hf = make("md1")
    want, jst = _jax_stages(hf, lanes=512)
    assert not jst["chunk2"]
    got = _port_stages(widescan.from_jax_staging(jst, "cpu"))
    return raw, got, want


def test_k1_cells_match_jax(md1_stages):
    _, got, want = md1_stages
    _assert_stages_equal(got, want, ["sym", "val"])


def test_k1_maps_match_jax(md1_stages):
    _, got, want = md1_stages
    _assert_stages_equal(got, want, ["cntmap", "exmap", "mrowmap"])
    # the stream really exercises the candidate machinery
    assert (want["mrowmap"][1:] >= 0).any() and want["entry"].max() > 0


def test_k2_entries_match_jax(md1_stages):
    _, got, want = md1_stages
    _assert_stages_equal(got, want, ["entry", "tot", "n"])


def test_fix_rows_match_jax(md1_stages):
    _, got, want = md1_stages
    _assert_stages_equal(got, want, ["cut", "cut_slot"])


def test_k3_splice_matches_jax(md1_stages):
    _, got, want = md1_stages
    _assert_stages_equal(got, want, ["msym", "mval"])


def test_k4_dense_matches_jax(md1_stages):
    raw, got, want = md1_stages
    _assert_dense_equal(got, want)
    ORP = got["denseT"].shape[1]
    mask = np.arange(ORP)[None, :] < got["n"][:, None]
    np.testing.assert_array_equal(got["denseT"][mask], raw)


@pytest.mark.interpret
@pytest.mark.parametrize("name,seed", [("md1wide", 3), ("md1abab", 0)])
def test_md1_stages_match_jax_interpret(name, seed):
    # the JAX package's leader halo-publish regression (seed 3: a leader
    # must publish -1 past the main chain's exit, where the halo's zero
    # bits emit the 1-bit symbol on every row) and its md=1 phase-locked
    # stream, stage by stage
    raw, hf = make(name, seed=seed)
    want, jst = _jax_stages(hf, lanes=512)
    got = _port_stages(widescan.from_jax_staging(jst, "cpu"))
    _assert_stages_equal(got, want, ALL_STAGES)
    _assert_dense_equal(got, want)


@pytest.mark.parametrize("lanes", [512, None])
@pytest.mark.parametrize("name", MD1_NAMES)
def test_md1_decode_matches_input_and_oracle(name, lanes, monkeypatch):
    # through the 1-bit kernels, never the lane-DFA fallback
    raw, hf = make(name, seed=1)
    scans = _spy(monkeypatch, widescan, "k1_scan")
    fixes = _spy(monkeypatch, widescan, "k3_fix")
    fallbacks = _spy(monkeypatch, widescan, "decode_lanedfa_tiled")
    out = widescan.decode_widescan(hf, device="cpu", lanes=lanes)
    assert (len(scans), len(fixes), len(fallbacks)) == (1, 1, 0)
    np.testing.assert_array_equal(out, raw)
    np.testing.assert_array_equal(out, native.simple_decode(hf))


def test_halo_publish_regression_decodes():
    # the seed-3 stream whole (its stage parity runs in the interpret tier)
    raw, hf = make("md1wide", seed=3)
    assert widescan.stage_widescan_inputs(hf, device="cpu",
                                          lanes=512)["NS"] == 2
    out = widescan.decode_widescan(hf, device="cpu", lanes=512)
    np.testing.assert_array_equal(out, raw)


def test_k3_fix_splices_in_place():
    # the plain K3' writes into the cells it is given and returns them
    raw, hf = make("md1")
    st = widescan.stage_widescan_inputs(hf, device="cpu", lanes=512)
    args = widescan.program_args(st)
    p = st["plan"]
    wmat = widescan.words_matrix(st["words"], -(-p["steps_p"] // 32))
    kw = dict(steps_p=p["steps_p"], SEG=p["SEG"], md=1, NS=st["NS"])
    sym, val, cntmap, exmap, mrowmap = k1_scan.k1_scan(
        wmat, st["tab"], st["lim"], B=args["B"], H=args["H"],
        steps=args["steps"], **kw)
    entry, _ = widescan.k2_compose(exmap, 0)
    cut, cut_slot = widescan.fix_rows(entry, mrowmap, st["lim"], st["H"], 1)
    assert (cut > 0).any()
    s2, v2 = k3_fix.k3_fix(wmat, st["tab"], entry, cut, cut_slot, sym, val,
                           **kw)
    assert s2 is sym and v2 is val
