"""Block-parallel sharded decode: the speculative pipeline over a mesh.

The port of ``huffmandecoderongpus_tpu/parallel/block_decode.py`` (the
registry's ``spec_sharded``).  The stream is cut into D blocks of S bits,
one a shard:

  * each shard decodes a symbol at every bit of its block (windows and two
    table lookups), then doubles, L times, its (hop, count) map saturating
    at the block's edge and its block-local code-length steps;
  * its exit map for the first ``height`` bits (a chain enters a block only
    there) goes to every shard in one gather of (D, height) maps
    (``mesh.all_gather_maps``), and each shard folds the D maps in the same
    D steps to learn its true entry bit, its symbol base and its count;
  * each output index of the block walks the steps down from that entry,
    gathers only, and picks its symbol; the host trims each block's span to
    its count and joins them in block order.

The JAX package runs this as XLA ops under ``shard_map`` with no Pallas
kernel, so here it is torch ops on each shard's device, shard after shard.
Out-of-range reads are clamped by hand where the JAX program clamps them
(``jnp.take(..., mode="clip")``): torch raises there on the CPU and reads
out of bounds on the card.  Entries of a span past its count are whatever
the gathers give, as in the JAX program.
"""

from __future__ import annotations

import numpy as np
import torch

from huffmandecoderongpus_tpu_torch.huffio import payload_to_words_u32
from huffmandecoderongpus_tpu_torch.ops.lut import DecodeLUT, build_decode_lut
from huffmandecoderongpus_tpu_torch.parallel.mesh import (
    Mesh,
    all_gather_maps,
    make_mesh,
)


def block_geometry(bits: int, D: int, height: int) -> tuple[int, int]:
    """(S, L): bits a block, at least ``height`` (the entry candidates fit
    in one block) and rounded up to 32, and the doubling levels with 2^L >=
    S (a block's chain has at most S codewords).  A trailing block may
    start at or past the stream's end, and is then all terminal."""
    S = max(-(-bits // D), height)
    S = (S + 31) & ~31
    return S, max((S - 1).bit_length(), 1)


def _windows(w64: torch.Tensor, b: torch.Tensor, height: int):
    """``height``-bit LSB-first windows at bit offsets ``b`` of the words
    ``w64`` (uint32 bit patterns as int64), word indices clamped to the
    last word as the JAX ``extract_windows`` clamps them."""
    last = w64.numel() - 1
    q, r = b >> 5, b & 31
    lo = w64[q.clamp(max=last)] >> r
    hi = (w64[(q + 1).clamp(max=last)] << (32 - r)) & 0xFFFFFFFF
    return (lo | hi) & ((1 << height) - 1)


def _block_steps(w64, lut_sym, lut_len, d: int, *, S, N, H, L, height):
    """One block's program up to the collective: its symbols at every bit
    (uint8 (S,)), its code-length steps at levels 0..L ((S,) int32 each,
    -1 where a span leaves the block or the stream), and its exit map
    (hop, count) (H,) int32 for the first H bits."""
    dev = w64.device
    i32 = dict(dtype=torch.int32, device=dev)
    start = d * S
    lim = min(start + S, N)
    win = _windows(w64, start + torch.arange(S, dtype=torch.int64,
                                             device=dev), height)
    top = lut_len.numel() - 1
    ln = lut_len[win.clamp(max=top)].to(torch.int32)
    sym = lut_sym[win.clamp(max=top)]
    del win
    # positions stay below 2^31 (``bits`` is an int32 in the format)
    bl = torch.arange(S, **i32)
    b = start + bl
    # codewords overrunning the stream jump to the terminal N; bits at or
    # past N are terminal where they stand; neither is on the true chain
    valid0 = (b < N) & (b + ln <= N)
    hop = torch.where(valid0, b + ln, torch.where(b < N, N, b))
    cnt = valid0.to(torch.int32)
    steps = [torch.where(valid0 & (b + ln < lim), ln, -1)]
    for _ in range(L):
        inside = hop < lim
        t = (hop - start).clamp(0, S - 1)
        hop, cnt = (torch.where(inside, hop[t], hop),
                    torch.where(inside, cnt + cnt[t], cnt))
        s = steps[-1]
        s_t = s[(bl + s).clamp(0, S - 1)]
        ok = (s != -1) & (s_t != -1) & (b + s + s_t < lim)
        steps.append(torch.where(ok, s + s_t, -1))
    return sym, steps, hop[:H].clone(), cnt[:H].clone()


def fold_entries(exits: torch.Tensor, counts: torch.Tensor, *, S: int,
                 N: int):
    """The D-step composition of the gathered (D, H) exit maps, the same on
    every shard: each block's true entry bit, its symbol base and its
    symbol count ((D,) int64 each), and the total (0-d), on the maps'
    device with no read back to the host."""
    D, H = exits.shape
    dev = exits.device
    e = torch.zeros((), dtype=torch.int64, device=dev)
    base = torch.zeros_like(e)
    my_e, my_base, my_n = [], [], []
    for k in range(D):
        done = e >= N
        j = (e - k * S).clamp(0, H - 1)
        ex = torch.where(done, e, exits[k, j].to(torch.int64))
        cn = torch.where(done, 0, counts[k, j].to(torch.int64))
        my_e.append(e)
        my_base.append(base)
        my_n.append(cn)
        e, base = ex, base + cn
    return torch.stack(my_e), torch.stack(my_base), torch.stack(my_n), base


def _block_spans(sym, steps, entry, d: int, *, S):
    """Index assignment, gather-only: output i of the block starts at its
    true entry and jumps by the level-k span for each set bit k of i; the
    symbol at the bit it lands on.  Entries past the block's count are
    whatever the gathers give (the host trims them)."""
    dev = sym.device
    j0 = (entry.to(dev) - d * S).clamp(0, S - 1).to(torch.int32)
    il = torch.arange(S, dtype=torch.int32, device=dev)
    pos = j0.expand(S).clone()
    for k in range(len(steps) - 1, -1, -1):
        delta = steps[k][pos]
        pos = torch.where(((il >> k) & 1) == 1, pos + delta.clamp(min=0),
                          pos)
        pos.clamp_(0, S - 1)
    return sym[pos]


def decode_sharded_arrays(words, lut_sym, lut_len, *, bits, size, height,
                          mesh: Mesh):
    """Device part of the sharded decode over this process's shards.
    ``words`` (uint32 bit patterns as int32 or int64, two zero pad words),
    ``lut_sym`` uint8 and ``lut_len`` int32 are replicated: each shard takes
    its own copy on its device.  Returns ((spans (Dl, S) uint8, counts (Dl,)
    int32, totals (Dl,) int32, entries (Dl,) int32), S), this process's Dl
    shards in shard order on the mesh's first device: each block's padded
    span, its symbol count, the stream's total and the block's entry bit.
    ``size`` is the header's, unused (as in the JAX program)."""
    del size
    S, L = block_geometry(int(bits), mesh.size, int(height))
    H = int(height)
    kw = dict(S=S, N=int(bits), H=H, L=L, height=H)
    replicas = {}

    def on(dev):
        if dev not in replicas:
            w = torch.as_tensor(words).to(dev).to(torch.int64) & 0xFFFFFFFF
            replicas[dev] = (w, torch.as_tensor(lut_sym).to(dev),
                             torch.as_tensor(lut_len).to(dev))
        return replicas[dev]

    local = [_block_steps(*on(dev), d, **kw)
             for d, dev in zip(mesh.shards, mesh.devices)]
    exits = all_gather_maps(mesh, [x[2] for x in local])
    counts = all_gather_maps(mesh, [x[3] for x in local])
    my_e, _my_base, my_n, total = fold_entries(exits, counts, S=S, N=int(bits))
    spans = [_block_spans(sym, steps, my_e[d], d, S=S)
             for d, (sym, steps, _x, _c) in zip(mesh.shards, local)]
    dev0 = mesh.devices[0]
    mine = slice(mesh.first, mesh.first + len(mesh.devices))
    i32 = torch.int32
    return ((torch.stack([s.to(dev0) for s in spans]),
             my_n[mine].to(i32), total.to(i32).expand(len(spans)).clone(),
             my_e[mine].to(i32)), S)


def join_spans(spans: torch.Tensor, counts: torch.Tensor) -> np.ndarray:
    """The host bytes of (D, S) padded spans trimmed to their (D,) counts,
    in block order."""
    counts = counts.cpu().numpy()
    spans = spans.cpu().numpy()
    return np.concatenate([spans[d, :int(n)] for d, n in enumerate(counts)]
                          or [np.zeros(0, np.uint8)])


def stage_block(hf, lut: DecodeLUT | None = None):
    """The sharded decode's host inputs: (words (int32), lut_sym, lut_len,
    height) as numpy."""
    if lut is None:
        lut = build_decode_lut(hf.tree)
    words = payload_to_words_u32(hf.payload, hf.bits, extra_words=2)
    return (words.view(np.int32), lut.sym, lut.length, lut.height)


def decode_sharded(hf, mesh: Mesh | None = None, lut: DecodeLUT | None = None,
                   check_size: bool = True) -> np.ndarray:
    """Decode a HuffFile block-parallel over a one-process mesh (default:
    ``make_mesh()``, every visible card) to host bytes.  Raises
    RuntimeError when the decoded total is not the header's size."""
    if mesh is None:
        mesh = make_mesh()
    if mesh.group is not None:
        raise ValueError("decode_sharded: a mesh across processes decodes "
                         "through multihost.decode_sharded_multihost")
    words, lut_sym, lut_len, height = stage_block(hf, lut)
    (spans, counts, totals, _entries), _S = decode_sharded_arrays(
        torch.from_numpy(words), torch.from_numpy(lut_sym),
        torch.from_numpy(lut_len), bits=hf.bits, size=hf.uncompressed_size,
        height=height, mesh=mesh)
    total = int(totals[0])
    if check_size and total != hf.uncompressed_size:
        raise RuntimeError(
            f"decoded {total} symbols, header says {hf.uncompressed_size}")
    return join_spans(spans, counts)
