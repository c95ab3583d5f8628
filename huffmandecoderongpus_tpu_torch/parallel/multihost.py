"""Multi-process block-parallel decode.

The port of ``huffmandecoderongpus_tpu/parallel/multihost.py``: the block
decode of ``block_decode.py`` over the shards of every process of a
``torch.distributed`` job (``mesh.distributed_init``), with

  * the inputs (compressed words and the table) replicated: every process
    stages them from the same HuffFile;
  * each block's exit map gathered to every process for the D-step fold,
    and then the padded spans, counts and totals gathered in shard order
    (``mesh.all_gather_maps``, the counterpart of
    ``process_allgather(tiled=True)``), so every process returns the same
    bytes.

On one host each process may run several virtual shards, as
``tests/torch_multihost_runner.py`` does with two gloo processes.
"""

from __future__ import annotations

import numpy as np
import torch

from huffmandecoderongpus_tpu_torch.ops.lut import DecodeLUT
from huffmandecoderongpus_tpu_torch.parallel.block_decode import (
    decode_sharded_arrays,
    join_spans,
    stage_block,
)
from huffmandecoderongpus_tpu_torch.parallel.mesh import (
    Mesh,
    all_gather_maps,
)


def global_mesh(devices=None) -> Mesh:
    """The mesh of the ``torch.distributed`` job: this process's shards on
    ``devices`` (default: one, on the card of this rank's index modulo the
    visible cards), the lower ranks' before them.  Every process must run
    as many shards."""
    import torch.distributed as dist

    if not dist.is_initialized():
        raise RuntimeError("global_mesh: call distributed_init first")
    rank, world = dist.get_rank(), dist.get_world_size()
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("global_mesh: no CUDA card is visible; pass "
                               "devices= for CPU shards")
        devices = [torch.device("cuda", rank % torch.cuda.device_count())]
    devices = tuple(torch.device(d) for d in devices)
    return Mesh(devices=devices, group=dist.group.WORLD,
                size=len(devices) * world, first=rank * len(devices))


def decode_sharded_multihost(hf, mesh: Mesh | None = None,
                             lut: DecodeLUT | None = None,
                             check_size: bool = True) -> np.ndarray:
    """Decode across every process of the job; every process gets the
    whole output.  Raises RuntimeError when the decoded total is not the
    header's size."""
    if mesh is None:
        mesh = global_mesh()
    words, lut_sym, lut_len, height = stage_block(hf, lut)
    (spans, counts, totals, _entries), _S = decode_sharded_arrays(
        torch.from_numpy(words), torch.from_numpy(lut_sym),
        torch.from_numpy(lut_len), bits=hf.bits, size=hf.uncompressed_size,
        height=height, mesh=mesh)
    spans = all_gather_maps(mesh, list(spans))
    counts = all_gather_maps(mesh, list(counts))
    total = int(all_gather_maps(mesh, list(totals))[0])
    if check_size and total != hf.uncompressed_size:
        raise RuntimeError(
            f"decoded {total} symbols, header says {hf.uncompressed_size}")
    return join_spans(spans, counts)
