"""Benchmark harness of the port: verify + min-of-N evaluation, the
truncation sweeps, timers, the stage profiler, and the command line.

Counterpart of the reference's decodeUtil/timing/mainrun layers
(decodeUtil.c, timing.c, mainrun.c), as the JAX package's ``harness``.
"""

from huffmandecoderongpus_tpu_torch.harness.evaluate import (  # noqa: F401
    REPEATS,
    DecodeMismatch,
    EvalResult,
    compare_uncompressed,
    evalandshow,
    evaluate,
)
from huffmandecoderongpus_tpu_torch.harness.timing import (  # noqa: F401
    Timer,
    gb_per_s,
    report_resolution,
)
from huffmandecoderongpus_tpu_torch.harness.truncate import (  # noqa: F401
    graph_rows,
    graphtest,
    set_target_sizes,
    truncate_test_data,
)
