"""The shard mesh of the multi-device layer, and process-group set-up.

The port of ``huffmandecoderongpus_tpu/parallel/mesh.py``.  The JAX package
lays a 1-D ``jax.sharding.Mesh`` over the axis ``"blocks"`` and runs its
shard bodies under ``shard_map``; here a ``Mesh`` names the devices of the
shards this process runs, the ``torch.distributed`` group that joins it to
the other processes (None in one process), the number of shards over all
processes and the global index of this process's first shard.  A shard body
is plain torch on its shard's device; shards on one device run one after
another on its current stream.

A device may stand in ``devices`` more than once: D *virtual shards* on one
card (or on the CPU), the counterpart of the JAX tests' 8 virtual CPU
devices.  On a host with one card they are the only way to run D > 1; they
measure what sharding costs, not how it scales.

``all_gather_maps`` is the one collective: the shards' small maps, stacked
in shard order (``jax.lax.all_gather``).
"""

from __future__ import annotations

import dataclasses
import os
import warnings

import torch

#: name of the shard axis (the JAX package's mesh axis)
BLOCK_AXIS = "blocks"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The shards this process runs, and how they join the others'."""

    devices: tuple  # torch.device of each local shard, in shard order
    group: object = None  # torch.distributed process group, or None
    size: int = 0  # shards over all processes
    first: int = 0  # global index of this process's first shard

    @property
    def shards(self) -> range:
        """Global indices of this process's shards."""
        return range(self.first, self.first + len(self.devices))


def make_mesh(n_devices: int | None = None, *, devices=None) -> Mesh:
    """A mesh of one process over ``devices`` (default: every visible CUDA
    card; raises RuntimeError without one, never falling back to the CPU),
    cut to its first ``n_devices``.  A device named more than once gives
    that many virtual shards on it.  Raises ValueError for ``n_devices``
    past the devices, as the JAX ``make_mesh`` does."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: no CUDA card is visible; pass "
                               "devices= for CPU shards")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    if not devices:
        raise ValueError("make_mesh: no devices")
    if n_devices is not None:
        if not 1 <= n_devices <= len(devices):
            raise ValueError(f"asked for {n_devices} devices, have "
                             f"{len(devices)}")
        devices = devices[:n_devices]
    return Mesh(devices=tuple(devices), group=None, size=len(devices),
                first=0)


def distributed_init(coordinator_address: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None):
    """Join a ``torch.distributed`` job and return its group, or None when
    running single-process (one process and no ``coordinator_address``).

    Arguments left out come from ``HUFF_NUM_PROCESSES``,
    ``HUFF_COORDINATOR`` and ``HUFF_PROCESS_ID``, as the JAX
    ``distributed_init`` honours its environment.  ``coordinator_address``
    is an ``init_method`` URL (``tcp://localhost:<port>`` or
    ``file://<path>``).  The backend is NCCL when every rank has a card of
    its own (this host shows at least as many cards as there are
    processes), else gloo."""
    import torch.distributed as dist

    num = num_processes if num_processes is not None else int(
        os.environ.get("HUFF_NUM_PROCESSES", "1"))
    addr = coordinator_address or os.environ.get("HUFF_COORDINATOR")
    if num <= 1 and addr is None:
        return None
    if addr is None:
        raise ValueError("distributed_init: a job of several processes "
                         "needs a coordinator address")
    rank = process_id if process_id is not None else int(
        os.environ.get("HUFF_PROCESS_ID", "0"))
    backend = ("nccl" if torch.cuda.is_available()
               and torch.cuda.device_count() >= num else "gloo")
    dist.init_process_group(backend, init_method=addr, world_size=num,
                            rank=rank)
    return dist.group.WORLD


def all_gather_maps(mesh: Mesh, local) -> torch.Tensor:
    """(mesh.size, ...) on the mesh's first device: the tensors ``local``
    (one a local shard, in shard order, each of one shape and type) of
    every process, in shard order.  In one process a stack; with a group,
    ``all_gather_into_tensor``: on the card for NCCL, on CPU copies for
    gloo (which gathers no CUDA tensor).  Every process must run as many
    shards."""
    dev = mesh.devices[0]
    mine = torch.stack([t.to(dev) for t in local])
    if mesh.group is None:
        return mine
    import torch.distributed as dist

    on_host = dist.get_backend(mesh.group) == "gloo"
    src = mine.cpu() if on_host else mine
    out = torch.empty((mesh.size, *mine.shape[1:]), dtype=mine.dtype,
                      device=src.device)
    with warnings.catch_warnings():
        # newer torch renames the call; the card host's keeps this name
        warnings.simplefilter("ignore", FutureWarning)
        dist.all_gather_into_tensor(out, src.contiguous(), group=mesh.group)
    return out.to(dev)

