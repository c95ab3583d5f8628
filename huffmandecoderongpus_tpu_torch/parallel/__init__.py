"""Multi-device and multi-process layer: the shard mesh, the block-parallel
decode and the lane-sharded decodes.

The port of ``huffmandecoderongpus_tpu/parallel``: the JAX package's
``shard_map`` programs become torch on each shard's device, its
``all_gather`` the one ``mesh.all_gather_maps``, and its mesh a ``Mesh`` of
devices (a device may hold several virtual shards) with an optional
``torch.distributed`` group.
"""

from huffmandecoderongpus_tpu_torch.parallel.mesh import (  # noqa: F401
    BLOCK_AXIS,
    Mesh,
    all_gather_maps,
    distributed_init,
    make_mesh,
)
from huffmandecoderongpus_tpu_torch.parallel.block_decode import (  # noqa: F401
    decode_sharded,
    decode_sharded_arrays,
)
from huffmandecoderongpus_tpu_torch.parallel.lane_sharded import (  # noqa: F401
    decode_lane_sharded,
    decode_lane_sharded_indexed,
    decode_lane_sharded_wide,
    lane_sharded_indexed_runner,
    lane_sharded_runner,
    lane_sharded_wide_runner,
)
