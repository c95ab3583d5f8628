"""Registry entries for the wide-lane decoder and the lane-DFA decoders."""

from __future__ import annotations

import numpy as np

from huffmandecoderongpus_tpu_torch.models import register
from huffmandecoderongpus_tpu_torch.ops.lanedfa import EnvelopeError
from huffmandecoderongpus_tpu_torch.ops.lanedfa_decode import (
    decode_lanedfa,
    decode_lanedfa_tiled,
)
from huffmandecoderongpus_tpu_torch.ops.widescan import decode_widescan


@register("lane_dfa", backend="cuda")
def lane_dfa(hf, param=None, *, device) -> np.ndarray:
    """Lane-parallel bit DFA with candidate discovery
    (ops/lanedfa_decode.py, the JAX package's XLA geometry).  ``param``
    optionally sets the lane count."""
    if getattr(hf, "index", None) is not None:
        raise EnvelopeError("a .huffidx sidecar needs the indexed path "
                            "(ROADMAP Queue 1 item 7)")
    return decode_lanedfa(hf, device=device, lanes=param)


@register("lane_dfa_pallas", backend="cuda")
def lane_dfa_pallas(hf, param=None, *, device) -> np.ndarray:
    """The lane-parallel bit DFA in the JAX package's Pallas geometry
    (whole 1024-lane tiles): the candidate and lane scan kernels."""
    return decode_lanedfa_tiled(hf, device=device, lanes=param)


@register("lane_wide", backend="cuda")
def lane_wide(hf, param=None, *, device) -> np.ndarray:
    """Wide-lane decode to dense bytes (ops/widescan.py): the K1-K4 CUDA
    kernels (the 1-bit K1/K3 for min code length 1) on a CUDA device,
    their plain torch versions on the CPU, and the lane-DFA chain for the
    streams outside their envelope.  ``param`` optionally sets the lane
    count."""
    return decode_widescan(hf, device=device, lanes=param)
