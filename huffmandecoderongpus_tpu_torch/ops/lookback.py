"""The state of a decoupled look-back, held per device and stream: the
encoder's E1 and E2 (``csrc/lookback.cuh``) and K2 (``csrc/k2_compose.cu``).

E1 and E2 cut each tile of lanes into row blocks, and each block takes its
lanes' sums over the rows before it (E1's code bits, E2's valid flags) from
its predecessors' published sums; K2 chains its tiles' maps the same way.
A state is one int32 buffer for up to ``cap`` blocks: a 64-bit word of the
call's epoch and its tickets, a flag a block, then each kernel's published
values (E1 and E2: ``state_words``, an aggregate and an inclusive sum a
(block, lane); K2: ``k2_compose._state_words``).  Each call leaves its
tickets at 0 and the epoch one further, so the state is zeroed once, when
it is made.

A ``States`` holds one state per (device, stream), the MAX_STREAMS most
recently used.  A state dropped, for a larger one or for a stream used less
recently, goes back to the allocator on the stream it was made on, so a
call still running there keeps it until it ends.  While a CUDA graph is
being captured, a call gets a state of its own instead, its tickets and
flags zeroed in the graph (a fill before the launch): no eager call shares
it, and the graph's pool keeps it for every replay.
"""

from __future__ import annotations

import collections

import torch

#: lanes a block publishes (a warp's)
LANES = 32
#: blocks the first state of a stream holds
MIN_BLOCKS = 1024
#: streams whose state is kept, the most recently used
MAX_STREAMS = 8


def state_words(cap: int) -> int:
    """int32 words of a state for ``cap`` blocks: the epoch and ticket word
    (two), a flag a block, and two sums a (block, lane)."""
    return 2 + cap + 2 * LANES * cap


class States:
    """(device index, stream) -> (state, cap) of one kernel's look-back,
    ``words(cap)`` int32 words a state, at least ``min_blocks`` blocks."""

    def __init__(self, words=state_words, min_blocks: int = MIN_BLOCKS):
        self._words = words
        self._min_blocks = min_blocks
        self._states = collections.OrderedDict()

    def __len__(self) -> int:
        return len(self._states)

    def __contains__(self, key) -> bool:
        return key in self._states

    def get(self, dev, stream: int, blocks: int):
        """(state, cap) for ``blocks`` blocks on this device and stream:
        made zeroed the first time, and again, twice as large, when a call
        needs more blocks."""
        if dev.type == "cuda" and torch.cuda.is_current_stream_capturing():
            state = torch.empty(self._words(blocks), dtype=torch.int32,
                                device=dev)
            state[:2 + blocks].zero_()
            return state, blocks
        key = (dev.index, stream)
        st = self._states.pop(key, None)
        if st is None or st[1] < blocks:
            cap = max(self._min_blocks, 2 * blocks)
            st = (torch.zeros(self._words(cap), dtype=torch.int32,
                              device=dev), cap)
        self._states[key] = st
        while len(self._states) > MAX_STREAMS:
            self._states.popitem(last=False)
        return st
