"""P2: the integer-latency probe, P dependent chains an element for S steps.

Replaces the arithmetic Pallas kernels of the hardware probes:
``scripts/probe_vpu2.py:62`` (``make_arith``, body ``xor3``),
``scripts/probe_vpu.py:48`` (``probe_arith``, body ``addxor``, int32 and
int16) and ``scripts/hw_dispatch.py:67`` (``med``, body ``mul3``).  CUDA
source: ``csrc/probe_arith.cu``.

  xor3    c_i = x + i (i < P), S steps of c = c + (c ^ 3); out = sum c_i
  addxor  a = x, b = x + 1, S steps of 4 x {a = a + b; b = b ^ a};
          out = a + b (P = 1; int32 or int16)
  mul3    S steps of a = a * 3 + step; out = a (P = 1)

Every op wraps at the element's width, as in JAX and torch.
"""

from __future__ import annotations

import torch

from huffmandecoderongpus_tpu_torch.ops import _build
from huffmandecoderongpus_tpu_torch.utils import trace

BODIES = {"xor3": 0, "addxor": 1, "mul3": 2}
#: integer instructions a step of one chain, the fewest that compute it:
#: xor3 an xor and an add, addxor four of each, mul3 one multiply-add
OPS_A_STEP = {"xor3": 2, "addxor": 8, "mul3": 1}
XOR3_CHAINS = (1, 4, 8)


def _check(x, body, P, S):
    if body not in BODIES:
        raise ValueError(f"probe_arith: unknown body {body!r}")
    if S < 0:
        raise ValueError("probe_arith: S must be >= 0")
    ok = {"xor3": P in XOR3_CHAINS and x.dtype == torch.int32,
          "addxor": P == 1 and x.dtype in (torch.int32, torch.int16),
          "mul3": P == 1 and x.dtype == torch.int32}[body]
    if not ok:
        raise ValueError(f"probe_arith: body {body} does not take P={P} on "
                         f"{x.dtype}")


def probe_arith(x, *, body, S, P=1):
    """The probe's output, of x's shape and type.  CPU tensors run the plain
    version; CUDA tensors launch the kernel."""
    _check(x, body, P, S)
    if x.device.type == "cpu":
        return probe_arith_ref(x, body=body, S=S, P=P)
    _build.require_cuda("probe_arith", x)
    out = torch.empty_like(x)
    rc = _build.get_lib().ws_probe_arith(
        x.data_ptr(), out.data_ptr(), x.numel(), S, BODIES[body], P,
        8 * x.element_size(), _build.stream_ptr(x))
    trace.count("launch.probe_arith")
    _build.check(rc, "probe_arith")
    return out


def _wrap(v, bits):
    """int64 values in [0, 2**bits) -> the signed int of that width."""
    return torch.where(v >= 1 << (bits - 1), v - (1 << bits), v)


def probe_arith_ref(x, *, body, S, P=1):
    """Plain torch probe: int64 chains cut to the element's width after
    every op; the P chains of ``xor3`` stacked on a leading axis."""
    _check(x, body, P, S)
    bits = 8 * x.element_size()
    M = (1 << bits) - 1
    x64 = x.to(torch.int64) & M
    if body == "xor3":
        c = (x64[None] + torch.arange(P, device=x.device).reshape(
            (P,) + (1,) * x.dim())) & M
        for _ in range(S):
            c = (c + (c ^ 3)) & M
        out = c.sum(0) & M
    elif body == "addxor":
        a, b = x64, (x64 + 1) & M
        for _ in range(S):
            for _ in range(4):
                a = (a + b) & M
                b = b ^ a
        out = (a + b) & M
    else:
        out = x64
        for i in range(S):
            out = (out * 3 + i) & M
    return _wrap(out, bits).to(x.dtype)
