"""Scaling sweep: decode throughput against the number of shards.

The port of ``huffmandecoderongpus_tpu/harness/scaling.py``: times a
sharded decode on meshes of growing size and reports efficiency =
speedup(n) / n.  ``path="lane"`` (default) times the lane-DFA sharded
program (``lane_sharded_runner``'s ``run``), ``"wide"`` the four-kernel
one (``lane_sharded_wide_runner``), each without its host staging and
compaction; ``"block"`` the whole block-parallel decode
(``decode_sharded``).  ``devices`` is handed to ``make_mesh``: naming one
card several times runs virtual shards on it, which measures what sharding
costs on that card, not how the decode scales over cards.  A time is the
host clock around the call and a ``torch.cuda.synchronize`` on a card.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class ScalePoint:
    devices: int
    min_seconds: float
    gb_per_s: float
    speedup: float
    efficiency: float


def scaling_sweep(hf, ucd: np.ndarray | None = None, sizes=None,
                  repeats: int = 5, path: str = "lane", *,
                  devices=None) -> list[ScalePoint]:
    """Time the sharded decode at each mesh size of ``sizes`` (default 1,
    2, 4, ... up to the devices: ``devices``, or the visible cards), each
    checked first against the header's size and ``ucd``; raises
    RuntimeError for a wrong decode, ValueError for an unknown path."""
    from huffmandecoderongpus_tpu_torch.parallel import (
        decode_sharded,
        lane_sharded_runner,
        lane_sharded_wide_runner,
        make_mesh,
    )

    if path not in ("lane", "wide", "block"):
        raise ValueError(f"unknown path {path!r}: lane, wide or block")
    n_dev = len(make_mesh(devices=devices).devices)
    if sizes is None:
        sizes = [s for s in (1, 2, 4, 8, 16, 32) if s <= n_dev]
    points = []
    base = None
    for n in sizes:
        mesh = make_mesh(n, devices=devices)
        cuda = mesh.devices[0].type == "cuda"
        if path in ("lane", "wide"):
            runner = (lane_sharded_wide_runner if path == "wide"
                      else lane_sharded_runner)
            run, materialize = runner(hf, mesh=mesh)
            out, total = materialize(run())  # warm up and check
            if total != hf.uncompressed_size:
                raise RuntimeError(f"wrong size at {n} devices: {total}")
            timed_once = run
        else:
            out = decode_sharded(hf, mesh=mesh)

            def timed_once(mesh=mesh):
                decode_sharded(hf, mesh=mesh, check_size=False)
        if ucd is not None and not np.array_equal(out, ucd):
            raise RuntimeError(f"sharded decode wrong at {n} devices")
        ts = []
        for _ in range(repeats):
            t0 = time.perf_counter()
            timed_once()
            if cuda:
                torch.cuda.synchronize()
            ts.append(time.perf_counter() - t0)
        sec = min(ts)
        if base is None:
            base = sec
        speedup = base / sec
        points.append(ScalePoint(
            devices=n, min_seconds=sec,
            gb_per_s=hf.uncompressed_size / sec / 1e9,
            speedup=speedup, efficiency=speedup / (n / sizes[0])))
    return points


def format_sweep(points: list[ScalePoint]) -> str:
    lines = ["devices   min_s      GB/s   speedup   efficiency"]
    for p in points:
        lines.append(f"{p.devices:7d} {p.min_seconds:8.4f} {p.gb_per_s:9.4f} "
                     f"{p.speedup:9.2f} {p.efficiency:11.2%}")
    return "\n".join(lines)
