"""Multi-device lane decodes: the lane axis sharded over the mesh.

The port of ``huffmandecoderongpus_tpu/parallel/lane_sharded.py``.  The
single-device decoders already cut the stream into G lanes with per-lane
exit maps; sharded, shard d owns lanes [d*Gl, (d+1)*Gl) and the maps
compose on two levels:

  ``lane_sharded_runner`` (the registry's ``lane_sharded``): the lane-DFA
      chain.  Each shard takes its columns of the (B+H, G) bit matrix (a
      column carries its lane's halo, so a slice is a whole shard) and runs
      ``candidate_scan``, folds its lanes' maps into a shard map for each
      entry offset of its first lane (``lanedfa_decode.shard_map_of``),
      the (D, H) shard maps are gathered (``mesh.all_gather_maps``) and
      folded in D steps to each shard's entry and base, ``compose`` seeds
      the shard's lanes there, and ``lane_scan`` decodes them.
  ``lane_sharded_wide_runner`` (``lane_sharded_wide``): the four-kernel
      program.  Each shard runs K1 on its columns of the one halo'd word
      matrix, K2 for its composite map (``tot``), then, after the (D, 128)
      gather and fold, K2 again from its true entry, ``select_h``,
      ``fix_rows``, K3 and K4; the total is the sum over shards.
  ``lane_sharded_indexed_runner``: `.huffidx` blocks are the lanes; each
      shard runs ``normalize_lane_words``, ``k1_main`` and K4 on its
      blocks, with no collective.

A kernel wrapper takes a shard's inputs as any other: its kernel on a CUDA
tensor, its plain version on a CPU one.  Each kernel launches once a shard
a call.  Shards on one device run one after another on its stream.  Each
runner returns ``(run, materialize)``: ``run()`` is the sharded device
program alone (what a scaling sweep times), ``materialize`` compacts its
output to host bytes.  The runners take a one-process mesh; the multi-
process decode is ``multihost.decode_sharded_multihost``.  The JAX
package's ``CHECK_VMA_PALLAS`` (its ``shard_map`` checker's exemption for
Pallas bodies) has no counterpart here: no checker runs.
"""

from __future__ import annotations

import numpy as np
import torch

from huffmandecoderongpus_tpu_torch.ops.candidate_scan import candidate_scan
from huffmandecoderongpus_tpu_torch.ops.k1_main import k1_main_plan
from huffmandecoderongpus_tpu_torch.ops.k1_scan2 import k1_scan2
from huffmandecoderongpus_tpu_torch.ops.k2_compose import k2_compose
from huffmandecoderongpus_tpu_torch.ops.k3_fix2 import k3_fix2
from huffmandecoderongpus_tpu_torch.ops.k4_compact import k4_compact
from huffmandecoderongpus_tpu_torch.ops.lane_scan import lane_scan
from huffmandecoderongpus_tpu_torch.ops.lanedfa import (
    EnvelopeError,
    bits_matrix,
    build_lane_dfa,
    pad_table,
    pick_lanes,
)
from huffmandecoderongpus_tpu_torch.ops.lanedfa_decode import (
    compose,
    prefix_maps,
    shard_map_of,
)
from huffmandecoderongpus_tpu_torch.ops.widescan import (
    fix_rows,
    indexed_args,
    select_h,
    stage_widescan_indexed,
    stage_widescan_inputs,
    wide_decode_indexed_program,
    words_matrix,
)
from huffmandecoderongpus_tpu_torch.parallel.mesh import (
    Mesh,
    all_gather_maps,
    make_mesh,
)


def _one_process(mesh: Mesh | None) -> Mesh:
    if mesh is None:
        mesh = make_mesh()
    if mesh.group is not None:
        raise ValueError("the lane-sharded runners take a one-process mesh")
    return mesh


def _check(total: int, emitted: int, hf, check_size: bool) -> None:
    if check_size and total != hf.uncompressed_size:
        raise RuntimeError(
            f"decoded {total} symbols, header says {hf.uncompressed_size}")
    if check_size and emitted != hf.uncompressed_size:
        raise RuntimeError(
            f"emitted {emitted} symbols, header says {hf.uncompressed_size}")


def fold_shard_maps(all_ex: torch.Tensor, all_cnt: torch.Tensor | None = None):
    """The D-step fold of the gathered (D, E) shard maps, the same on every
    shard: shard 0 enters at offset 0, shard k+1 at ``all_ex[k, e_k]``.
    Returns each shard's entry offset and symbol base ((D,) int64; the bases
    zero without ``all_cnt``) and the total (0-d int64), on the maps' device
    with no read back to the host."""
    D = all_ex.shape[0]
    dev = all_ex.device
    e = torch.zeros((), dtype=torch.int64, device=dev)
    base = torch.zeros_like(e)
    my_e, my_base = [], []
    for k in range(D):
        my_e.append(e)
        my_base.append(base)
        if all_cnt is not None:
            base = base + all_cnt[k, e].to(torch.int64)
        e = all_ex[k, e].to(torch.int64)
    return torch.stack(my_e), torch.stack(my_base), base


# ---------------------------------------------------------------------------
# lane-DFA body


def lane_sharded_geometry(bits: int, H: int, D: int,
                          lanes: int | None = None) -> int:
    """G, the JAX rule: the lane-DFA plan's lanes (``pick_lanes``, or
    ``lanes``), at least D and at most one a tree height of bits, rounded
    up to a multiple of D.  The scans' tile plan takes any lane count, so
    no shard's lanes are rounded further (the JAX Pallas body needs whole
    1024-lane tiles a shard; its XLA body, which the tests hold this
    against, does not)."""
    G = pick_lanes(bits) if lanes is None else int(lanes)
    G = max(D, min(G, bits // H if bits >= H else 1))
    return -(-G // D) * D


def lane_sharded_runner(hf, mesh: Mesh | None = None,
                        lanes: int | None = None):
    """Stage the lane-DFA sharded decode once; returns ``(run,
    materialize)``.  ``run()`` returns a list of (sym, valid, n_lane), one
    a local shard in lane order ((B+H, Gl) uint8 twice and (Gl,) int32, on
    its device), and the total (0-d int64 tensor); ``materialize(out)``
    returns (host bytes, total)."""
    mesh = _one_process(mesh)
    D = mesh.size
    dfa = build_lane_dfa(hf.tree)
    H = max(dfa.height, 1)
    N = int(hf.bits)
    G = lane_sharded_geometry(N, H, D, lanes)
    Gl = G // D
    mat, B = bits_matrix(hf.payload, hf.bits, G, H, round_to=512)
    tab = pad_table(dfa.entry)
    shards = []
    for d, dev in zip(mesh.shards, mesh.devices):
        cols = np.ascontiguousarray(mat[:, d * Gl:(d + 1) * Gl])
        # a shard's lanes start at lane d*Gl: the scans bound lane g of
        # the shard by N - (d*Gl + g)*B, zero or less past the stream
        shards.append((torch.from_numpy(cols).to(dev),
                       torch.from_numpy(tab).to(dev), N - d * Gl * B))

    def run():
        kw = dict(B=B, H=H)
        scans = []
        for bits_d, tab_d, n_d in shards:
            cnt, ex = candidate_scan(bits_d, tab_d, N=n_d, **kw)
            maps = prefix_maps(cnt, ex)
            scans.append((cnt, ex, maps, shard_map_of(cnt, ex, maps)))
        all_ex = all_gather_maps(mesh, [s[3][0] for s in scans])
        all_cnt = all_gather_maps(mesh, [s[3][1] for s in scans])
        my_e, my_base, total = fold_shard_maps(all_ex, all_cnt)
        out = []
        for (bits_d, tab_d, n_d), (cnt, ex, maps, _), d in zip(
                shards, scans, mesh.shards):
            dev = bits_d.device
            entry, _bases, _n, _t = compose(cnt, ex, my_e[d].to(dev),
                                            my_base[d].to(dev), maps=maps)
            sym, valid = lane_scan(bits_d, tab_d, entry, N=n_d, **kw)
            out.append((sym, valid, valid.sum(0, dtype=torch.int32)))
        return out, total

    def materialize(res):
        out, total = res
        got = [sym.t()[valid.t() > 0].cpu() for sym, valid, _n in out]
        return torch.cat(got).numpy(), int(total)

    return run, materialize


def decode_lane_sharded(hf, mesh: Mesh | None = None,
                        lanes: int | None = None,
                        check_size: bool = True) -> np.ndarray:
    """Lane-DFA decode with lanes sharded over a mesh, to host bytes
    (``lane_sharded_runner`` is the staged surface)."""
    run, materialize = lane_sharded_runner(hf, mesh=mesh, lanes=lanes)
    out, total = materialize(run())
    _check(total, out.size, hf, check_size)
    return out


# ---------------------------------------------------------------------------
# wide body: K1-K4 a shard


def wide_sharded_staging(hf, D: int, *, device, lanes: int | None = None):
    """``stage_widescan_inputs`` restaged to the JAX sharded geometry: G a
    multiple of 128*D with at least 512 lanes a shard (staging rounds G to
    a power of two).  Raises EnvelopeError for a tree without the 2-bit
    tables (md = 1) or lanes that do not split over D shards."""
    st = stage_widescan_inputs(hf, device=device, lanes=lanes)
    if not st["chunk2"]:
        raise EnvelopeError("tree/geometry not chunk2-eligible")
    G0 = st["plan"]["G"]
    G = -(-max(G0, 512 * D) // (128 * D)) * 128 * D
    if G != G0:
        st = stage_widescan_inputs(hf, device=device, lanes=G)
        G = st["plan"]["G"]
        if G % (128 * D):
            raise EnvelopeError(
                f"lane count {G} not divisible over {D} shards")
        if not st["chunk2"]:
            raise EnvelopeError("tree/geometry not chunk2-eligible")
    if G // D < 512:
        raise EnvelopeError("fewer than 512 lanes per shard")
    return st


def lane_sharded_wide_runner(hf, mesh: Mesh | None = None,
                             lanes: int | None = None):
    """Stage the four-kernel sharded decode; returns ``(run,
    materialize)``.  ``run()`` returns a list of (denseT (Gl, ORP) uint8,
    n (Gl,) int32), one a local shard in lane order, and the total (0-d
    int64 tensor); ``materialize(out)`` returns (host bytes, total) and
    raises OverflowError when a lane overflowed its dense row.

    K2's ``start`` is a host int, so the fold of the gathered (D, 128)
    composite maps reads them to the host: one sync a decode, between each
    shard's first K2 and its second.  Raises EnvelopeError outside the
    geometry (``wide_sharded_staging``)."""
    mesh = _one_process(mesh)
    D = mesh.size
    st = wide_sharded_staging(hf, D, device=mesh.devices[0], lanes=lanes)
    p = st["plan"]
    G, H, md = p["G"], st["H"], st["md"]
    Gl = G // D
    ORP = p["ORP"]
    # the halo'd word matrix is built once: a shard's last lane reads the
    # next shard's first lane's words
    wmat = words_matrix(st["words"], -(-p["steps_p"] // 32))
    shards = []
    for d, dev in zip(mesh.shards, mesh.devices):
        cols = slice(d * Gl, (d + 1) * Gl)
        shards.append((wmat[:, cols].contiguous().to(dev),
                       st["tab"].to(dev),
                       st["lim"][cols].contiguous().to(dev)))
    k1 = dict(B=p["B"], H=H, steps=p["steps"], steps_p=p["steps_p"],
              SEG=p["SEG"], md=md, C0=st["C0"], C1=st["C1"], NS=st["NS"])
    k3 = dict(steps_p=p["steps_p"], SEG=p["SEG"], md=md, C0=st["C0"],
              C1=st["C1"], NS=st["NS"])

    def run(trace=None):
        scans = []
        for wm, tab, lim in shards:
            k1_out = k1_scan2(wm, tab, lim, **k1)
            _entry, tot = k2_compose(k1_out[3], 0)
            scans.append((k1_out, tot))
        all_tot = all_gather_maps(mesh, [s[1].to(torch.int64)
                                         for s in scans])
        my_e = fold_shard_maps(all_tot)[0].tolist()
        if trace is not None:
            trace.update(all_tot=all_tot, my_e=my_e, shards=[])
        out = []
        total = None
        for (wm, tab, lim), (k1_out, tot), d in zip(shards, scans,
                                                    mesh.shards):
            sym, val, cntmap, exmap, mrowmap = k1_out
            entry, _tot = k2_compose(exmap, my_e[d])
            HP = cntmap.shape[0]
            n = select_h(cntmap, entry, HP)
            s = n.sum().to(mesh.devices[0])
            total = s if total is None else total + s
            cut, cut_slot = fix_rows(entry, mrowmap, lim, HP, md)
            if trace is not None:  # K3 splices sym and val in place
                k1_kept = tuple(t.clone() for t in k1_out)
            sym, val = k3_fix2(wm, tab, entry, cut, cut_slot, sym, val, **k3)
            denseT = k4_compact(sym, val, ORP=ORP)
            out.append((denseT, n))
            if trace is not None:
                trace["shards"].append(dict(
                    inputs=(wm, tab, lim), k1=k1_kept, tot=tot,
                    start=my_e[d], entry=entry, cut=(cut, cut_slot),
                    k3=(sym, val), k4=denseT, n=n))
        return out, total

    def materialize(res):
        out, total = res
        got = []
        for denseT, n in out:
            if int(n.max()) > ORP:
                raise OverflowError("a lane overflowed the dense buffer")
            mask = torch.arange(ORP, device=n.device)[None, :] < n[:, None]
            got.append(denseT[mask].cpu())
        return torch.cat(got).numpy(), int(total)

    return run, materialize


def decode_lane_sharded_wide(hf, mesh: Mesh | None = None,
                             lanes: int | None = None,
                             check_size: bool = True) -> np.ndarray:
    """Four-kernel decode with lanes sharded over a mesh, to host bytes;
    outside its geometry (EnvelopeError) or when a lane overflows its dense
    row (OverflowError) the lane-DFA sharded decode takes the stream, as in
    the JAX package."""
    mesh = _one_process(mesh)
    try:
        run, materialize = lane_sharded_wide_runner(hf, mesh=mesh,
                                                    lanes=lanes)
        out, total = materialize(run())
    except (EnvelopeError, OverflowError):
        return decode_lane_sharded(hf, mesh=mesh, lanes=lanes,
                                   check_size=check_size)
    _check(total, out.size, hf, check_size)
    return out


# ---------------------------------------------------------------------------
# indexed body: `.huffidx` blocks over the mesh, no collective


def lane_sharded_indexed_runner(hf, offsets, block_symbols: int,
                                mesh: Mesh | None = None):
    """Stage the index-sharded decode; returns ``(run, materialize)``.
    ``run()`` returns a list of denseT (Gl, ORP) uint8, one a local shard;
    ``materialize(out)`` returns the host bytes, each lane trimmed to its
    count from the index.  The lanes are padded to a multiple of 512*D
    (pad lanes decode nothing).  Raises EnvelopeError outside the indexed
    envelope or where ``k1_main``'s plan refuses a shard's lanes (the
    counterpart of the JAX ``_rb_for``)."""
    mesh = _one_process(mesh)
    D = mesh.size
    st = stage_widescan_indexed(hf, offsets, block_symbols,
                                device=mesh.devices[0],
                                lane_multiple=512 * D)
    p = st["plan"]
    G = p["G"]
    if G % (128 * D):
        raise EnvelopeError(f"lane count {G} not divisible over {D} shards")
    Gl = G // D
    if Gl < 512:
        raise EnvelopeError("fewer than 512 lanes per shard")
    try:
        k1_main_plan(Gl, st["md"], st["NS"], p["steps_p"])
    except ValueError as e:
        raise EnvelopeError(str(e)) from e
    args = indexed_args(st)
    shards = []
    for d, dev in zip(mesh.shards, mesh.devices):
        rows = slice(d * Gl, (d + 1) * Gl)
        shards.append(tuple(st[k][rows].contiguous().to(dev)
                            for k in ("raw", "sh", "lim"))
                      + (st["tab"].to(dev),))
    counts = st["counts"]
    ORP = p["ORP"]

    def run():
        return [wide_decode_indexed_program(raw, sh, tab, lim, **args)
                for raw, sh, lim, tab in shards]

    def materialize(out):
        dense = torch.cat([t.cpu() for t in out]).numpy()
        return dense[np.arange(ORP)[None, :] < counts[:, None]]

    return run, materialize


def decode_lane_sharded_indexed(hf, offsets, block_symbols: int,
                                mesh: Mesh | None = None,
                                check_size: bool = True) -> np.ndarray:
    """The indexed decode with its `.huffidx` blocks sharded over a mesh, to
    host bytes: no discovery, no collective.  Raises EnvelopeError for
    callers to take another route."""
    run, materialize = lane_sharded_indexed_runner(hf, offsets,
                                                   block_symbols, mesh=mesh)
    out = materialize(run())
    if check_size and out.size != hf.uncompressed_size:
        raise RuntimeError(
            f"emitted {out.size} symbols, header says {hf.uncompressed_size}")
    return out
