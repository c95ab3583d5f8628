"""Run one cell of the codec's benchmark and print its result line.

    python3 codecbench/run.py --workload <cell> --seed <n> \
        --seconds <s> --trace <0|1>

from the root of a checkout that holds the port.  Needs a CUDA card
(exits 2 without one, or with fewer than the cell asks for) and exits 3
without a result if JAX or the JAX package was loaded by the time the
result would be printed.  The last line of
standard output is the result (``harness.run_cell``); the numbers the
check compared, each beside its limit, are the last lines of standard
error.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
# the checkout's root, not this directory, leads the import path: the
# harness imports itself as a package beside the port
sys.path[0] = str(ROOT)
# Python's bytecode of every module the run imports, torch's ~2,100 among
# them, is cached at a fixed path in the checkout, so that only the first
# run compiles it: where PYTHONDONTWRITEBYTECODE is set and the
# interpreter's own caches are absent, each run would compile torch from
# source again, 8-11 s of set-up
sys.pycache_prefix = str(ROOT / ".codecbench_cache" / "pyc")
sys.dont_write_bytecode = False


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from codecbench import harness
    from codecbench.spec import Spec

    spec = Spec()
    chips = int(spec.workload(args.workload)["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA device(s); this machine "
              f"has {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    result, lines = harness.run_cell(spec, args.workload, args.seed,
                                     args.seconds, bool(args.trace),
                                     device="cuda", t_start=T_START)
    print(f"card: {harness.card_limits()}", file=sys.stderr)
    return harness.emit(result, lines)


if __name__ == "__main__":
    sys.exit(main())
