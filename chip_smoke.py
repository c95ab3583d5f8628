"""GPU smoke run of the PyTorch/CUDA wide-lane decoder.

    python3 chip_smoke.py

Needs one CUDA card, the CUDA toolkit (nvcc) and this repository.  Phases,
each printing its own lines; any failure raises and exits non-zero:

  1. device   the card's name and power limit (nvidia-smi)
  2. build    the K1-K4 kernels from csrc/ with nvcc, and the build time
  3. kernels  each of K1-K4 against its plain torch version on the same
              CUDA inputs, at the shapes the slice gives it for streams (a)
              and (b) below: bit-exact (tolerance 0), with both times from
              CUDA events
  4. slice    get_decoder("lane_wide", device="cuda") on (a) a seeded
              kjv-sized text-like stream and (b) a seeded 8 MiB stream over
              all 256 symbols: bytes equal to the input, every kernel
              launched; then the device
              program's median time over 25 runs (CUDA events), the decode
              wall time (host clock) and the program's device time by
              kernel (torch.profiler)
  5. result   one JSON line for the kernels, the card, then the last line
              {"ok": true, "device": {...}}
"""

from __future__ import annotations

import json
import pathlib
import statistics
import subprocess
import sys
import time

import numpy as np

SEED = 0
#: a kjv-sized stream: the size of kjv.txt, Zipf(1.1) over 84 symbols,
#: which gives kjv's tree shape (min code length 2, height 9, 83 states)
KJV_BYTES = 5_504_597
TEXT_SYMBOLS = 84
WIDE_BYTES = 8 << 20
TIMED_RUNS = 25
WARMUP = 3
WALL_RUNS = 10

DEVICE = "cuda"

KERNELS = {  # name -> (CUDA source, the TPU kernel it replaces)
    "k1_scan2": ("huffmandecoderongpus_tpu_torch/csrc/k1_scan2.cu",
                 "huffmandecoderongpus_tpu/ops/pallas_widescan.py:769"),
    "k2_compose": ("huffmandecoderongpus_tpu_torch/csrc/k2_compose.cu",
                   "huffmandecoderongpus_tpu/ops/pallas_widescan.py:1254"),
    "k3_fix2": ("huffmandecoderongpus_tpu_torch/csrc/k3_fix2.cu",
                "huffmandecoderongpus_tpu/ops/pallas_widescan.py:1456"),
    "k4_compact": ("huffmandecoderongpus_tpu_torch/csrc/k4_compact.cu",
                   "huffmandecoderongpus_tpu/ops/pallas_widescan.py:1617"),
}

#: device function names of each kernel (K2 is three launches)
DEVICE_SYMBOLS = {"k1_scan2": ("k1_scan2_kernel",),
                  "k2_compose": ("k2_groups", "k2_scan", "k2_apply"),
                  "k3_fix2": ("k3_fix2_kernel",),
                  "k4_compact": ("k4_compact_kernel",)}


def text_like(rng, n):
    z = 1.0 / np.arange(1, TEXT_SYMBOLS + 1) ** 1.1
    return rng.choice(np.arange(32, 32 + TEXT_SYMBOLS, dtype=np.uint8),
                      size=n, p=z / z.sum()).astype(np.uint8)


def full_alphabet(rng, n):
    w = rng.random(256) ** 3 + 1e-4
    return rng.choice(np.arange(256, dtype=np.uint8), size=n,
                      p=w / w.sum()).astype(np.uint8)


def cuda_ms(torch, fn, runs):
    """Per-run device times (ms) of ``fn`` from CUDA events."""
    out = []
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        out.append(a.elapsed_time(b))
    return out


def max_abs_err(torch, got, want) -> int:
    err = 0
    for g, w in zip(got, want):
        if g.shape != w.shape or g.dtype != w.dtype:
            raise AssertionError(f"shape/dtype {g.shape} {g.dtype} vs "
                                 f"{w.shape} {w.dtype}")
        d = (g.to(torch.int64) - w.to(torch.int64)).abs()
        err = max(err, int(d.max()) if d.numel() else 0)
    return err


def check_kernels(torch, name, raw, hf, dev):
    """Phase 3 on one stream: K1-K4 against their plain versions on the
    inputs the slice gives them.  Returns {kernel: (max_abs_err, kernel
    ms, plain ms)} and raises on any difference."""
    from huffmandecoderongpus_tpu_torch.ops import (
        k1_scan2,
        k2_compose,
        k3_fix2,
        k4_compact,
    )
    from huffmandecoderongpus_tpu_torch.ops import widescan as ws

    st = ws.stage_widescan_inputs(hf, device=dev)
    p = st["plan"]
    print(f"[kernels] {name}: {hf.bits} bits, G={p['G']} B={p['B']} "
          f"H={st['H']} md={st['md']} NS={st['NS']}", flush=True)
    wmat = ws.words_matrix(st["words"], -(-p["steps_p"] // 32))
    kw = dict(steps_p=p["steps_p"], SEG=p["SEG"], md=st["md"], C0=st["C0"],
              C1=st["C1"], NS=st["NS"])
    k1a = dict(B=p["B"], H=st["H"], steps=p["steps"], **kw)
    rows = {}

    def compare(kname, kernel, plain):
        got = kernel()
        torch.cuda.synchronize()
        want = plain()
        torch.cuda.synchronize()
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        err = max_abs_err(torch, got, want)
        ms = statistics.median(cuda_ms(torch, kernel, 20))
        plain_ms = statistics.median(cuda_ms(torch, plain, 2))
        rows[kname] = (err, ms, plain_ms)
        print(f"[kernels] {name}: {kname} max_abs_err {err} (tolerance 0) "
              f" kernel {ms:.4f} ms  plain {plain_ms:.4f} ms", flush=True)
        if err:
            raise AssertionError(f"{kname} differs from its plain version")
        return got

    sym, val, cntmap, exmap, mrowmap = compare(
        "k1_scan2",
        lambda: k1_scan2.k1_scan2(wmat, st["tab"], st["lim"], **k1a),
        lambda: k1_scan2.k1_scan2_ref(wmat, st["tab"], st["lim"], **k1a))
    entry, _tot = compare("k2_compose",
                          lambda: k2_compose.k2_compose(exmap, 0),
                          lambda: k2_compose.k2_compose_ref(exmap, 0))
    cut, cut_slot = ws.fix_rows(entry, mrowmap, st["lim"], st["H"], st["md"])
    # K3 splices in place and is idempotent on its own output, so repeated
    # timing runs on one copy do the same work
    s_k, v_k = sym.clone(), val.clone()
    s_p, v_p = sym.clone(), val.clone()
    msym, mval = compare(
        "k3_fix2",
        lambda: k3_fix2.k3_fix2(wmat, st["tab"], entry, cut, cut_slot, s_k,
                                v_k, **kw),
        lambda: k3_fix2.k3_fix2_ref(wmat, st["tab"], entry, cut, cut_slot,
                                    s_p, v_p, **kw))
    (denseT,) = compare("k4_compact",
                        lambda: k4_compact.k4_compact(msym, mval, ORP=p["ORP"]),
                        lambda: k4_compact.k4_compact_ref(msym, mval,
                                                          ORP=p["ORP"]))
    n = ws.select_h(cntmap, entry, st["H"])
    mask = torch.arange(p["ORP"], device=dev)[None, :] < n[:, None]
    if not np.array_equal(denseT[mask].cpu().numpy(), raw):
        raise AssertionError(f"{name}: the kernels' stages decoded wrong")
    print(f"[kernels] {name}: all four bit-exact; stream decoded", flush=True)
    return rows


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    # the port under test is the one beside this script, never an installed
    # copy: its kernels are built from this checkout's csrc/
    csrc = pathlib.Path(__file__).resolve().parent / (
        "huffmandecoderongpus_tpu_torch/csrc")
    if not csrc.is_dir():
        print(f"chip_smoke: no {csrc} beside this script", file=sys.stderr)
        return 1
    from huffmandecoderongpus_tpu_torch.huffio import encode_bytes
    from huffmandecoderongpus_tpu_torch.models import get_decoder
    from huffmandecoderongpus_tpu_torch.ops import (
        _build,
        k1_scan2,
        k2_compose,
        k3_fix2,
        k4_compact,
    )
    from huffmandecoderongpus_tpu_torch.ops import widescan as ws

    mods = {"k1_scan2": k1_scan2, "k2_compose": k2_compose,
            "k3_fix2": k3_fix2, "k4_compact": k4_compact}
    dev = torch.device(DEVICE)

    # ---- 1. device ----------------------------------------------------------
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"[device] {card}")
    print(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
          f"devices {torch.cuda.device_count()}", flush=True)

    # ---- 2. build -----------------------------------------------------------
    t0 = time.perf_counter()
    _build.get_lib()
    print(f"[build] {_build.lib_path().name} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    log = (_build.BUILD_DIR / "build.log")
    if log.exists():
        for line in log.read_text().splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {line.strip()}")

    # ---- 3. kernels against their plain versions ---------------------------
    rng = np.random.default_rng(SEED)
    streams = [("a kjv-sized text", text_like(rng, KJV_BYTES)),
               ("b 8MiB full-alphabet", full_alphabet(rng, WIDE_BYTES))]
    hfs = [(name, r, encode_bytes(r)) for name, r in streams]
    checked = [check_kernels(torch, name, r, h, dev) for name, r, h in hfs]

    # ---- 4. the slice through the registry ----------------------------------
    dec = get_decoder("lane_wide", device=DEVICE)
    for m in mods.values():
        m.launches = 0
    outs = []
    for name, r, h in hfs:
        t0 = time.perf_counter()
        out = dec(h)
        torch.cuda.synchronize()
        outs.append((out, time.perf_counter() - t0))
    launches = {k: m.launches for k, m in mods.items()}
    print(f"[slice] launches on the decode path: {launches}", flush=True)
    for (name, r, h), (out, wall) in zip(hfs, outs):
        ok = np.array_equal(out, r)
        print(f"[slice] {name}: {r.size} bytes, {h.bits} bits, first decode "
              f"{wall:.3f} s wall, equal to the input: {ok}", flush=True)
        if not ok:
            raise AssertionError(f"{name}: decoded bytes differ")
    if min(launches.values()) < 1:
        raise AssertionError(f"a kernel was not launched: {launches}")

    for name, r, h in hfs:
        s2 = ws.stage_widescan_inputs(h, device=dev)
        args = ws.program_args(s2)

        def program():
            return ws.wide_decode_program(s2["words"], s2["tab"], s2["lim"],
                                          **args)

        ts = cuda_ms(torch, program, WARMUP + TIMED_RUNS)
        med = statistics.median(ts[WARMUP:])
        q = s2["plan"]
        print(f"[slice] {name}: device program median {med:.4f} ms over "
              f"{TIMED_RUNS} runs (min {min(ts[WARMUP:]):.4f}), "
              f"{r.size / med / 1e6:.3f} GB/s decoded; G={q['G']} "
              f"B={q['B']} H={s2['H']} md={s2['md']} NS={s2['NS']}; "
              f"card {card}", flush=True)
        walls = []
        for _ in range(WALL_RUNS):
            t0 = time.perf_counter()
            dec(h)
            walls.append((time.perf_counter() - t0) * 1e3)
        print(f"[slice] {name}: decode wall median {statistics.median(walls):.4f}"
              f" ms over {WALL_RUNS} runs (min {min(walls):.4f}), staging to "
              f"host bytes; card {card}", flush=True)
        split = device_breakdown(torch, program)
        print(f"[slice] {name}: device ms per program (profiler) "
              + "  ".join(f"{k} {v:.4f}" for k, v in split.items()),
              flush=True)

    # ---- 5. result ----------------------------------------------------------
    # times from stream (a), the kjv-sized one; the error over both streams
    print(json.dumps({"kernels": [
        dict(name=k, route="cuda", source=KERNELS[k][0],
             replaces=KERNELS[k][1], launches=launches[k],
             max_abs_err=max(c[k][0] for c in checked),
             ms=checked[0][k][1], plain_ms=checked[0][k][2])
        for k in KERNELS]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def device_breakdown(torch, fn, runs=5):
    """Device time per call of ``fn`` (ms) by kernel, from torch.profiler:
    K1-K4 by name, everything else (the torch ops around them) together."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    out = dict.fromkeys(list(KERNELS) + ["torch ops"], 0.0)
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        key = next((k for k, syms in DEVICE_SYMBOLS.items()
                    if any(sym in e.key for sym in syms)), "torch ops")
        out[key] += e.self_device_time_total / runs / 1e3
    return out


if __name__ == "__main__":
    sys.exit(main())
