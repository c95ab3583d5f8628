"""Registry entries for the wide-lane decoder and the lane-DFA decoders."""

from __future__ import annotations

import numpy as np

from huffmandecoderongpus_tpu_torch.models import register
from huffmandecoderongpus_tpu_torch.ops.lanedfa import EnvelopeError
from huffmandecoderongpus_tpu_torch.ops.lanedfa_decode import (
    decode_lanedfa,
    decode_lanedfa_indexed,
    decode_lanedfa_tiled,
)
from huffmandecoderongpus_tpu_torch.ops.lanedfa_sync import (
    decode_lanedfa_sync,
)
from huffmandecoderongpus_tpu_torch.ops.oneshot import decode_oneshot
from huffmandecoderongpus_tpu_torch.ops.widescan import decode_widescan


@register("lane_dfa", backend="cuda")
def lane_dfa(hf, param=None, *, device) -> np.ndarray:
    """Lane-parallel bit DFA (ops/lanedfa_decode.py, the JAX package's XLA
    geometry): through the `.huffidx` block index when the HuffFile carries
    one (one lane per block, no entry discovery), else with candidate
    discovery.  ``param`` optionally sets the discovery path's lane
    count."""
    index = getattr(hf, "index", None)
    if index is not None:
        offsets, k = index
        return decode_lanedfa_indexed(hf, offsets, k, device=device)
    return decode_lanedfa(hf, device=device, lanes=param)


@register("lane_dfa_sync", backend="cuda")
def lane_dfa_sync(hf, param=None, *, device) -> np.ndarray:
    """Lane DFA with self-synchronizing entry discovery
    (ops/lanedfa_sync.py, the JAX package's XLA geometry): the lane scan
    from offset 0, short candidate scans until every chain merges or
    exits, and a fix scan for the lanes entering elsewhere.  A `.huffidx`
    index is not used, as in the JAX package.  ``param`` optionally sets
    the lane count."""
    return decode_lanedfa_sync(hf, device=device, lanes=param)


@register("lane_dfa_pallas", backend="cuda")
def lane_dfa_pallas(hf, param=None, *, device) -> np.ndarray:
    """The lane-parallel bit DFA in the JAX package's Pallas geometry
    (whole 1024-lane tiles): the candidate and lane scan kernels."""
    return decode_lanedfa_tiled(hf, device=device, lanes=param)


@register("lane_wide", backend="cuda")
def lane_wide(hf, param=None, *, device) -> np.ndarray:
    """Wide-lane decode to dense bytes (ops/widescan.py): streams under
    ONESHOT_MAX_BITS inside the one-shot envelope in one launch
    (ops/oneshot.py), the others through the K1-K4 CUDA kernels (the 1-bit
    K1/K3 for min code length 1), and the lane-DFA chain for the streams
    outside their envelope; on the CPU the kernels' plain torch versions.
    A `.huffidx` index is not used, as in the JAX package
    (``decode_widescan_indexed`` takes it through the ops API).  ``param``
    optionally sets the lane count."""
    return decode_widescan(hf, device=device, lanes=param)


@register("lane_oneshot", backend="cuda")
def lane_oneshot(hf, param=None, *, device) -> np.ndarray:
    """The one-shot decode (ops/oneshot.py): the whole wide-lane program in
    one kernel launch, whatever the stream's size; ``lane_wide`` for a
    stream outside its envelope.  ``param`` optionally sets the lane
    count."""
    try:
        return decode_oneshot(hf, device=device, lanes=param)
    except EnvelopeError:
        return decode_widescan(hf, device=device, lanes=param)
