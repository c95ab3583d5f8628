"""K2: compose per-lane exit maps into each lane's true entry offset.

Replaces ``huffmandecoderongpus_tpu/ops/pallas_widescan.py`` ``k2_compose`` /
``_k2_kernel``.  CUDA source: ``csrc/k2_compose.cu``.

``entry[0] = start`` and ``entry[l + 1] = exmap[entry[l], l]``: a sequential
composition of G small maps.  Both versions split it in three steps over
NGp groups of L lanes: (1) each group's composite map over all 128 entry
offsets, (2) one scan over the group composites, (3) each group applies its
first lane's entry.  An entry offset at or past the map rows (HP) reads 0,
as the TPU kernel's 128-wide padding does.  Also returns the block's
composite map ``tot`` (128,) uint8: lane G-1's exit for each entry offset of
lane 0.
"""

from __future__ import annotations

import torch

from huffmandecoderongpus_tpu_torch.ops import _build

#: kernel launches made by ``k2_compose`` on CUDA tensors
launches = 0

#: entry offsets a map is evaluated at (the TPU kernel's lane width)
NE = 128
#: most groups the scan step walks
MAX_GROUPS = 256


def groups(G: int) -> tuple[int, int]:
    """(L, NGp): lanes per group and the number of groups."""
    L = -(-G // MAX_GROUPS)
    if G % L:
        raise ValueError(f"k2_compose: {G} lanes do not split into groups")
    return L, G // L


def k2_compose(exmap, start: int = 0):
    """Entries (G,) int32 of every lane and the composite map (128,) uint8,
    from ``exmap`` (HP, G) int32.  CPU tensors run the plain version; CUDA
    tensors launch the kernel."""
    if exmap.device.type == "cpu":
        return k2_compose_ref(exmap, start)
    global launches
    _build.require_cuda("k2_compose", exmap)
    HP, G = exmap.shape
    if not 0 <= start < NE or HP > NE:
        raise ValueError("k2_compose: start and map rows must be below 128")
    L, NGp = groups(G)
    dev = exmap.device
    entry = torch.empty(G, dtype=torch.int32, device=dev)
    tot = torch.empty(NE, dtype=torch.uint8, device=dev)
    gmap = torch.empty((NGp, NE), dtype=torch.uint8, device=dev)
    goff = torch.empty(NGp, dtype=torch.int32, device=dev)
    rc = _build.get_lib().ws_k2_compose(
        exmap.data_ptr(), entry.data_ptr(), tot.data_ptr(),
        gmap.data_ptr(), goff.data_ptr(), G, HP, start, L, NGp,
        _build.stream_ptr(exmap))
    launches += 1
    _build.check(rc, "k2_compose")
    return entry, tot


def k2_compose_ref(exmap, start: int = 0):
    """Plain torch K2, in the kernel's three steps."""
    HP, G = exmap.shape
    L, NGp = groups(G)
    dev = exmap.device
    ex = torch.zeros((NE, G), dtype=torch.int64, device=dev)
    ex[:HP] = exmap.to(torch.int64)
    ex = ex.reshape(NE, NGp, L)
    grp = torch.arange(NGp, device=dev)

    def step(state, lane):
        """exmap[state, lane of each group]; 0 at or past the map rows."""
        inside = (state >= 0) & (state < HP)
        v = ex[state.clamp(0, NE - 1), grp[:, None] if state.dim() > 1
               else grp, lane]
        return torch.where(inside, v, 0)

    # (1) each group's composite map at every entry offset
    gmap = torch.arange(NE, device=dev).expand(NGp, NE).clone()
    for lane in range(L):
        gmap = step(gmap, lane)
    # (2) scan over the groups: the first lane's entry of every group for
    # lane 0 entering at each offset (column ``start`` is the one used)
    state = torch.arange(NE, device=dev)
    goff = torch.empty(NGp, dtype=torch.int64, device=dev)
    for g in range(NGp):
        goff[g] = state[start]
        state = gmap[g, state]
    tot = state
    # (3) each group applies its first lane's entry
    entry = torch.empty((NGp, L), dtype=torch.int64, device=dev)
    s = goff
    for lane in range(L):
        entry[:, lane] = s
        s = step(s, lane)
    return (entry.reshape(-1)[:G].to(torch.int32), tot.to(torch.uint8))
