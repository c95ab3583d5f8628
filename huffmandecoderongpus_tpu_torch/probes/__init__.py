"""The hardware probes of ``scripts/``, on the card.

Each module ports one script and prints the lines it prints, with what was
particular to the TPU replaced (``probes/_timing.py`` says how a time is
taken); its ``run(device, ...)`` raises if an output is wrong.  Their
kernels are ``ops/probe_inc.py``, ``probe_arith.py``, ``probe_gather.py``
and ``k4_stripped.py``.  ``python -m huffmandecoderongpus_tpu_torch probe
NAME`` runs one: on the card at its script's sizes, on the CPU (the plain
versions) at ``CPU_CUT``.
"""

from __future__ import annotations

import importlib

import torch

#: probe name -> (module, the script it ports)
PROBES = {
    "dispatch": ("hw_dispatch", "scripts/hw_dispatch.py"),
    "k1fixed": ("hw_k1fixed", "scripts/hw_k1fixed.py"),
    "k4": ("hw_k4probe", "scripts/hw_k4probe.py"),
    "gather": ("probe_gather", "scripts/probe_gather.py"),
    "vpu": ("probe_vpu", "scripts/probe_vpu.py"),
    "vpu2": ("probe_vpu2", "scripts/probe_vpu2.py"),
}
#: the sizes a run of the plain versions on the CPU takes: the chain
#: probes' steps and the bytes of the k1fixed and k4 streams
CPU_CUT = dict(steps=16, nbytes=20_000)


def run(name: str, device="cuda", **kw):
    """Run probe ``name`` on ``device``, on the CPU at ``CPU_CUT`` unless
    ``kw`` says otherwise; returns what its ``run`` returns."""
    if name not in PROBES:
        raise ValueError(f"unknown probe {name!r}; one of {sorted(PROBES)}")
    mod = importlib.import_module(
        f"huffmandecoderongpus_tpu_torch.probes.{PROBES[name][0]}")
    if torch.device(device).type == "cpu":
        kw = {**CPU_CUT, **kw}
    return mod.run(device, **kw)
