"""Registry entries for the speculative pipeline (ops/speculative.py).

The reference writes this algorithm once a backend (pes, fastgpu,
fastgpuOpt1, opencl, pacc); here one pipeline runs its CUDA kernels on the
card and their plain versions on the CPU, and ``pes_numpy`` is the numpy
oracle."""

from __future__ import annotations

import numpy as np

from huffmandecoderongpus_tpu_torch.models import register
from huffmandecoderongpus_tpu_torch.ops.speculative import (
    decode_spec,
    speculative_decode_numpy,
)


@register("pes_numpy", backend="numpy")
def pes_numpy(hf, param=None, *, device) -> np.ndarray:
    """Vectorized host execution of the 6-stage pipeline (pes.c:106-209
    role); numpy on the host whatever the device."""
    return speculative_decode_numpy(hf)


#: a slow contrast row in the suites: a few seconds of timing, not the
#: harness's default budget (the JAX entry's cap)
@register("spec_xla", backend="cuda", suite_budget_s=5.0)
def spec_xla(hf, param=None, *, device) -> np.ndarray:
    """The pipeline on the decoder's device (fastgpu.cu role): S1, S2 a
    level and S3 on the card, their plain versions on the CPU.  A timed
    call includes the copies both ways, as the reference's whole-approach
    timing does."""
    return decode_spec(hf, device)


@register("spec_xla_cpu", backend="cpu")
def spec_xla_cpu(hf, param=None, *, device) -> np.ndarray:
    """The same pipeline pinned to the CPU whatever device the lookup names
    (the pes/pacc 'same algorithm, other backend' role)."""
    return decode_spec(hf, "cpu")
