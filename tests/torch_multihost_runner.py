"""Worker of the two-process decode test of the port.

Launched by tests/test_torch_multihost.py as:
    python tests/torch_multihost_runner.py <init-method> <num_procs> <pid>
        [shards] [device]

Each process joins the ``torch.distributed`` job (gloo: the processes share
the host's cards or have none), runs ``shards`` virtual shards (default 2) on
``device`` (default cpu) of a global mesh, decodes one seeded text stream
with ``decode_sharded_multihost`` and prints ``OK:<pid>:<sha256>`` of the
decoded bytes (``MISMATCH:...`` when they differ from the input).  Imports
only the port and numpy.
"""

import hashlib
import os
import sys

# Python puts this script's directory (tests/) on sys.path, not the repo
# root; make the package importable even when it isn't pip-installed.
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

#: the stream: text-like bytes (Zipf(1.1) over 84 symbols) from this seed
SEED, SIZE = 23, 20000


def main() -> None:
    init, num, pid = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
    shards = int(sys.argv[4]) if len(sys.argv) > 4 else 2
    device = sys.argv[5] if len(sys.argv) > 5 else "cpu"

    import numpy as np
    import torch.distributed as dist

    from huffmandecoderongpus_tpu_torch.huffio import encode_bytes
    from huffmandecoderongpus_tpu_torch.parallel.mesh import distributed_init
    from huffmandecoderongpus_tpu_torch.parallel.multihost import (
        decode_sharded_multihost,
        global_mesh,
    )
    from huffmandecoderongpus_tpu_torch.probes.streams import text_like

    distributed_init(init, num, pid)
    assert dist.get_backend() == "gloo"  # no process has a card of its own
    mesh = global_mesh(devices=[device] * shards)
    assert mesh.size == shards * num and mesh.first == pid * shards
    raw = text_like(np.random.default_rng(SEED), SIZE)
    out = decode_sharded_multihost(encode_bytes(raw), mesh=mesh)
    digest = hashlib.sha256(out.tobytes()).hexdigest()
    want = hashlib.sha256(raw.tobytes()).hexdigest()
    status = "OK" if digest == want else "MISMATCH"
    print(f"{status}:{pid}:{digest}", flush=True)
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
