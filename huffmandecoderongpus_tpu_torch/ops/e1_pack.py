"""E1: each lane packs its symbols' codes into 16-bit granules.

Replaces ``huffmandecoderongpus_tpu/ops/pallas_encode.py`` ``e1_pack`` /
``_e1_kernel``.  CUDA source: ``csrc/e1_pack.cu``.

Lane g's symbols are column g of ``data3`` (K, G) uint8; rows at or past
``nval[g]`` pack zero bits.  Each symbol appends its two half-codes (the
``lo``/``hi`` tables of ``encode.build_pack_tables``) to a granule
accumulator, and after each half, sub-step row ``2k + half`` records
``acc & 0xFFFF`` in ``gran`` and whether a granule completed in ``gval``.
The last row takes the residual granule.  ``cnt`` is each lane's granule
count, ``bits`` its code bits.
"""

from __future__ import annotations

import torch

from huffmandecoderongpus_tpu_torch.ops import _build

GRAN = 16
HALF = 13

#: kernel launches made by ``e1_pack`` on CUDA tensors
launches = 0


def e1_pack(data3, lo, hi, nval):
    """(gran (2K, G) int32 of u16 values, gval (2K, G) uint8, cnt (G,)
    int32, bits (G,) int32) from ``data3`` (K, G) uint8, the 256-entry
    int32 tables ``lo``/``hi`` and ``nval`` (G,) int32.  CPU tensors run
    the plain version; CUDA tensors launch the kernel."""
    if data3.device.type == "cpu":
        return e1_pack_ref(data3, lo, hi, nval)
    global launches
    _build.require_cuda("e1_pack", data3, lo, hi, nval)
    K, G = data3.shape
    if (data3.dtype != torch.uint8 or lo.shape != (256,) or hi.shape != (256,)
            or nval.shape != (G,)
            or {lo.dtype, hi.dtype, nval.dtype} != {torch.int32}):
        raise ValueError("e1_pack: data3 (K, G) uint8, int32 tables (256,) "
                         "and nval (G,)")
    dev = data3.device
    gran = torch.empty((2 * K, G), dtype=torch.int32, device=dev)
    gval = torch.empty((2 * K, G), dtype=torch.uint8, device=dev)
    cnt = torch.empty(G, dtype=torch.int32, device=dev)
    bits = torch.empty(G, dtype=torch.int32, device=dev)
    rc = _build.get_lib().ws_e1_pack(
        data3.data_ptr(), lo.data_ptr(), hi.data_ptr(), nval.data_ptr(),
        gran.data_ptr(), gval.data_ptr(), cnt.data_ptr(), bits.data_ptr(),
        K, G, _build.stream_ptr(data3))
    launches += 1
    _build.check(rc, "e1_pack")
    return gran, gval, cnt, bits


def e1_pack_ref(data3, lo, hi, nval):
    """Plain torch E1: the accumulator of every lane at once, one symbol
    row after another."""
    K, G = data3.shape
    dev = data3.device
    gran = torch.empty((2 * K, G), dtype=torch.int32, device=dev)
    gval = torch.empty((2 * K, G), dtype=torch.uint8, device=dev)
    acc = torch.zeros(G, dtype=torch.int64, device=dev)
    nb = torch.zeros_like(acc)
    cnt = torch.zeros_like(acc)
    bits = torch.zeros_like(acc)
    lo, hi, nval = lo.to(torch.int64), hi.to(torch.int64), nval.to(torch.int64)
    for k in range(K):
        sym = data3[k].to(torch.int64)
        valid = k < nval
        for half, tab in ((0, lo), (1, hi)):
            ent = torch.where(valid, tab[sym], 0)
            acc = acc | ((ent & ((1 << HALF) - 1)) << nb)
            nb = nb + (ent >> HALF)
            bits = bits + (ent >> HALF)
            emit = nb >= GRAN
            gran[2 * k + half] = (acc & 0xFFFF).to(torch.int32)
            gval[2 * k + half] = emit.to(torch.uint8)
            acc = torch.where(emit, acc >> GRAN, acc)
            nb = torch.where(emit, nb - GRAN, nb)
            cnt = cnt + emit.to(torch.int64)
    gran[2 * K - 1] = (acc & 0xFFFF).to(torch.int32)
    gval[2 * K - 1] = (nb > 0).to(torch.uint8)
    cnt = cnt + (nb > 0).to(torch.int64)
    return gran, gval, cnt.to(torch.int32), bits.to(torch.int32)
