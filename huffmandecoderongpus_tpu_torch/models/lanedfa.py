"""Registry entry for the wide-lane decoder."""

from __future__ import annotations

import numpy as np

from huffmandecoderongpus_tpu_torch.models import register
from huffmandecoderongpus_tpu_torch.ops.widescan import decode_widescan


@register("lane_wide", backend="cuda")
def lane_wide(hf, param=None, *, device) -> np.ndarray:
    """Wide-lane decode to dense bytes (ops/widescan.py): the K1-K4 CUDA
    kernels on a CUDA device, their plain torch versions on the CPU.
    ``param`` optionally sets the lane count."""
    return decode_widescan(hf, device=device, lanes=param)
