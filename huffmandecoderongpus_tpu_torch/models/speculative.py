"""Registry entries for the speculative pipeline (ops/speculative.py).

The reference writes this algorithm once a backend (pes, fastgpu,
fastgpuOpt1, opencl, pacc); here one pipeline runs its CUDA kernels on the
card and their plain versions on the CPU, and ``pes_numpy`` is the numpy
oracle.  The sharded entries (``spec_sharded``, ``lane_sharded_wide``,
``lane_sharded``) run the multi-device layer (``parallel``) over the
lookup's device: its visible cards, or virtual shards on the CPU."""

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


def _mesh(param, device):
    """The mesh of a sharded entry on ``device``: the visible cards for
    CUDA (``param`` caps their number), ``param or 1`` virtual shards on
    the CPU."""
    from huffmandecoderongpus_tpu_torch.ops.lanedfa_decode import (
        require_device,
    )
    from huffmandecoderongpus_tpu_torch.parallel import make_mesh

    dev = require_device(device)
    if dev.type == "cuda":
        return make_mesh(int(param) if param else None)
    return make_mesh(devices=[dev] * int(param or 1))


@register("spec_sharded", backend="cuda-sharded")
def spec_sharded(hf, param=None, *, device) -> np.ndarray:
    """Block-parallel decode over a mesh (parallel/block_decode.py): each
    shard decodes its block of the stream, one gather of the blocks' exit
    maps stitches them.  ``param`` caps the shards."""
    from huffmandecoderongpus_tpu_torch.parallel import decode_sharded

    return decode_sharded(hf, mesh=_mesh(param, device))


@register("lane_sharded_wide", backend="cuda-sharded")
def lane_sharded_wide(hf, param=None, *, device) -> np.ndarray:
    """The four-kernel decode with its lanes sharded over a mesh
    (parallel/lane_sharded.py ``decode_lane_sharded_wide``): K1-K4 a shard,
    stitched by one gather of the shards' composite maps; the lane-DFA
    sharded decode outside its geometry.  ``param`` caps the shards."""
    from huffmandecoderongpus_tpu_torch.parallel import (
        decode_lane_sharded_wide,
    )

    return decode_lane_sharded_wide(hf, mesh=_mesh(param, device))


@register("lane_sharded", backend="cuda-sharded")
def lane_sharded(hf, param=None, *, device) -> np.ndarray:
    """The lane-DFA decode with its lanes sharded over a mesh
    (parallel/lane_sharded.py ``decode_lane_sharded``): the candidate and
    lane scans a shard, stitched by one gather of the shards' maps.
    ``param`` caps the shards."""
    from huffmandecoderongpus_tpu_torch.parallel import decode_lane_sharded

    return decode_lane_sharded(hf, mesh=_mesh(param, device))
