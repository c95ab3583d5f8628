"""Registry entry for the one-thread device decode (ops/onethread.py): the
serial LUT walk in one CUDA thread, ``<<<1,1>>>`` as the reference's
onethread.cu, to measure one core's speed.  Deliberately slow."""

from __future__ import annotations

import numpy as np

from huffmandecoderongpus_tpu_torch.models import register
from huffmandecoderongpus_tpu_torch.ops.onethread import onethread
from huffmandecoderongpus_tpu_torch.ops.speculative import (
    decode_device_arrays,
)


@register("onethread_device", backend="cuda")
def onethread_device(hf, param=None, *, device) -> np.ndarray:
    plan, (words, lut_sym, lut_len) = decode_device_arrays(hf, device=device)
    out, n = onethread(words, lut_sym, lut_len, bits=plan.bits,
                       size=plan.size, height=plan.height)
    out = out.cpu().numpy()
    if int(n) != plan.size:
        raise RuntimeError(f"decoded {int(n)} symbols, header says "
                           f"{plan.size}")
    return out
