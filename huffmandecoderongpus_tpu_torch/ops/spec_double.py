"""S2: one pointer-doubling level of the speculative pipeline.

The port of ``double`` in ``huffmandecoderongpus_tpu/ops/speculative.py``
``speculative_decode_xla`` (:122-127), XLA ops there and no Pallas kernel:
s'[b] = s[b] + s[b + s[b]] where both spans are valid and the jump stays
inside the stream, else -1.  CUDA source: ``csrc/spec_double.cu``.  A level
is written once, in the type its spans fit (``level_dtype``); the JAX
pipeline keeps the even levels in that type (:129-135).  No decode
launches it: S2 makes the kept levels by ``spec_tile`` and ``spec_pair``,
and this one-level kernel is the yardstick the card tests and
``chip_smoke.py`` hold them against, level by level.
"""

from __future__ import annotations

import torch

from huffmandecoderongpus_tpu_torch.ops import _build
from huffmandecoderongpus_tpu_torch.utils import trace

_SIZES = {torch.int16: 2, torch.int32: 4}


def level_dtype(k: int, height: int) -> torch.dtype:
    """Type of doubling level ``k``: its spans cover 2^k codewords of at
    most ``height`` bits, so int16 where 2^k * height <= 32767 (the JAX
    rule for a kept level), else int32."""
    return torch.int16 if (1 << k) * height <= 32767 else torch.int32


def spec_double(s, *, bits: int, dtype: torch.dtype):
    """The next doubling level of ``s`` (bits,) int16 or int32, as
    ``dtype`` (int16 or int32, no narrower than ``s``).  CPU tensors run
    the plain version; CUDA tensors launch the kernel."""
    if s.dtype not in _SIZES or dtype not in _SIZES or (
            _SIZES[dtype] < _SIZES[s.dtype]) or s.numel() != bits or bits < 1:
        raise ValueError("spec_double: s is (bits,) int16 or int32, and the "
                         "output int16 or int32 no narrower")
    if s.is_cpu:
        return spec_double_ref(s, bits=bits, dtype=dtype)
    _build.require_cuda("spec_double", s)
    out = torch.empty(bits, dtype=dtype, device=s.device)
    rc = _build.get_lib().ws_spec_double(
        s.data_ptr(), out.data_ptr(), bits, _SIZES[s.dtype], _SIZES[dtype],
        _build.stream_ptr(s))
    trace.count("launch.spec_double")
    _build.check(rc, "spec_double")
    return out


def spec_double_ref(s, *, bits: int, dtype: torch.dtype):
    """Plain torch ``double`` with XLA's clip on the gather."""
    s = s.to(torch.int64)
    b = torch.arange(bits, dtype=torch.int64, device=s.device)
    t = b + s
    w = s[t.clamp(0, bits - 1)]
    ok = (s != -1) & (t < bits) & (w != -1) & (t + w <= bits)
    return torch.where(ok, s + w, -1).to(dtype)
