"""Probe: where the PyTorch port's one-shot kernel spends its time on a GPU.

    python3 scripts/probe_oneshot_gpu.py

Needs one CUDA card and nvcc; imports nothing of JAX.  Draws the streams
(f)-(i) of ``chip_smoke.py`` the way it does (same seed, same order) and
prints for each, beside the card's name and power limit:

  oneshot    the fused kernel's time (CUDA events, median of 25 after 3
             warm-ups) and its split by phase (its timer stamps, median of 9)
  idle       the same launch with every lane's limit at 0, so that no lane
             decodes anything: what is left is the launch, the grid
             barriers, K2 and the per-lane epilogues
  k1_scan2   the four-kernel program's K1 alone on the same stream (CUDA
             events), on the word matrix the program builds, and idle the
             same way
"""

from __future__ import annotations

import pathlib
import statistics
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import chip_smoke as cs  # noqa: E402
from huffmandecoderongpus_tpu_torch.harness.timing import event_ms  # noqa: E402
from huffmandecoderongpus_tpu_torch.huffio import encode_bytes  # noqa: E402
from huffmandecoderongpus_tpu_torch.ops import k1_scan2, oneshot  # noqa: E402
from huffmandecoderongpus_tpu_torch.ops import widescan as ws  # noqa: E402

RUNS = 25
SPLITS = 9


def streams():
    """(name, raw) of chip_smoke.py's streams (f)-(i)."""
    rng = np.random.default_rng(cs.SEED)
    cs.text_like(rng, cs.KJV_BYTES)
    cs.full_alphabet(rng, cs.WIDE_BYTES)
    cs.dominant_byte(rng, cs.WIDE_BYTES)
    cs.text_like(rng, cs.KJV_BYTES)
    cs.text_like(rng, cs.TINY_BYTES)
    return [("f", cs.text_like(rng, cs.PAPER1_BYTES)),
            ("g", cs.text_like(rng, cs.NEWS_BYTES)),
            ("h", cs.full_alphabet(rng, cs.ALPHA_BYTES)),
            ("i", cs.uniform12(rng, cs.UNIFORM12_BYTES))]


def median_ms(fn):
    return statistics.median(event_ms(fn, cs.WARMUP + RUNS)[cs.WARMUP:])


def split(args, kw):
    runs = [oneshot.phase_ms(*args, **kw) for _ in range(SPLITS)]
    return {ph: statistics.median(r[ph] for r in runs)
            for ph in oneshot.PHASES}


def show(d):
    return "  ".join(f"{k} {v:.4f}" for k, v in d.items())


def main() -> int:
    if not torch.cuda.is_available():
        print("probe_oneshot_gpu: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    for name, raw in streams():
        st = ws.stage_widescan_inputs(encode_bytes(raw), device=dev)
        p = st["plan"]
        kw = oneshot.program_args(st)
        k1kw = dict(B=p["B"], H=st["H"], steps=p["steps"],
                    steps_p=p["steps_p"], SEG=p["SEG"], md=st["md"],
                    C0=st["C0"], C1=st["C1"], NS=st["NS"])
        wmat = ws.words_matrix(st["words"], -(-p["steps_p"] // 32))
        print(f"[probe] {name}: G={p['G']} B={p['B']} H={st['H']} "
              f"md={st['md']} NS={st['NS']} ORP={p['ORP']}; card {card}")
        for label, lim in (("busy", st["lim"]),
                           ("idle", torch.zeros_like(st["lim"]))):
            args = (st["words"], st["tab"], lim)
            ms = median_ms(lambda: oneshot.oneshot_program(*args, **kw))
            k1 = median_ms(lambda: k1_scan2.k1_scan2(wmat, st["tab"], lim,
                                                     **k1kw))
            print(f"[probe] {name} {label}: oneshot {ms:.4f} ms, phases "
                  f"{show(split(args, kw))}; k1_scan2 alone {k1:.4f} ms",
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
