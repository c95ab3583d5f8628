"""Where K1's fixed cost on a small stream comes from.

Port of ``scripts/hw_k1fixed.py``.  The time a launch (CUDA events over
many back-to-back launches) of

  1. the trivial kernel: ``probe_inc`` on an (8, 128) int32 tile
  2. five of them chained (five launches)
  3. the gridded kernel with scratch (``probe_grid``): four (32, 128)
     blocks, each zeroing its scratch (``csrc/probe_inc.cu`` says how it
     is laid out) before adding s1[0, 0]
  4. K1 on one staging of stream (f), paper1-sized text, and of (a),
     kjv-sized text: with discovery (``k1_scan2``) and without
     (``k1_main``, the main scan alone, the JAX ``discover=False``)

The script loads paper1 from a corpus mount the port does not have; the
streams are seeded text of the same sizes (``probes.streams``).  Unlike the
script, the word matrix is built once, outside the timed launches, so that
the two K1 lines time K1 alone.  The trivial and gridded outputs are held
against their plain versions on the host.
"""

from __future__ import annotations

import torch

from huffmandecoderongpus_tpu_torch.ops import widescan as ws
from huffmandecoderongpus_tpu_torch.ops.k1_main import k1_main
from huffmandecoderongpus_tpu_torch.ops.k1_scan2 import k1_scan2
from huffmandecoderongpus_tpu_torch.ops.lanedfa_decode import require_device
from huffmandecoderongpus_tpu_torch.ops.probe_inc import (
    probe_grid,
    probe_grid_ref,
    probe_inc,
    probe_inc_ref,
)
from huffmandecoderongpus_tpu_torch.probes import streams as st_
from huffmandecoderongpus_tpu_torch.probes._timing import (
    card,
    raise_if_wrong,
    time_ms,
    verdict,
)

#: the streams K1 runs on, in order
K1_STREAMS = ("f", "a")


def run(device="cuda", *, streams=None, nbytes=None, **_):
    """Print the probe's lines; returns their times.  ``streams`` maps "f"
    and "a" to (name, raw, HuffFile); by default they are drawn
    (``nbytes`` long if given).  Raises if an output differs from its
    plain version."""
    dev = require_device(device)
    x = torch.zeros((8, 128), dtype=torch.int32, device=dev)
    xg = torch.zeros((4, 32, 128), dtype=torch.int32, device=dev)

    def triv5():
        y = x
        for _ in range(5):
            y = probe_inc(y)
        return y

    ms = {"trivial": time_ms(lambda: probe_inc(x), dev),
          "5 chained": time_ms(triv5, dev),
          "gridded": time_ms(lambda: probe_grid(xg), dev)}
    print(f"trivial kernel: {ms['trivial'] * 1e3:.3f} us", flush=True)
    print(f"5 chained trivial kernels: {ms['5 chained'] * 1e3:.3f} us",
          flush=True)
    print(f"gridded kernel w/ scratch: {ms['gridded'] * 1e3:.3f} us",
          flush=True)
    wrong, want = [], x.cpu()
    for _ in range(5):
        want = probe_inc_ref(want)
    print(verdict("trivial and 5 chained against the plain version on the "
                  "host", torch.equal(triv5().cpu(), want), wrong), flush=True)
    got, want = probe_grid(xg), probe_grid_ref(xg.cpu())
    print(verdict("gridded against the plain version on the host", all(
        torch.equal(g.cpu(), w) for g, w in zip(got, want)), wrong),
          flush=True)
    for key in K1_STREAMS:
        name, _raw, hf = (streams[key] if streams else
                          st_.stream(key, nbytes))
        st = ws.stage_widescan_inputs(hf, device=dev)
        p = st["plan"]
        wmat = ws.words_matrix(st["words"], -(-p["steps_p"] // 32))
        kw = dict(steps_p=p["steps_p"], md=st["md"], C0=st["C0"],
                  C1=st["C1"], NS=st["NS"])
        ms[key, True] = time_ms(lambda: k1_scan2(
            wmat, st["tab"], st["lim"], B=p["B"], H=st["H"], steps=p["steps"],
            SEG=p["SEG"], **kw), dev)
        ms[key, False] = time_ms(lambda: k1_main(wmat, st["tab"], st["lim"],
                                                 **kw), dev)
        print(f"{name} (G={p['G']} B={p['B']} steps_p={p['steps_p']}) "
              f"K1 discover=True : {ms[key, True] * 1e3:.3f} us", flush=True)
        print(f"{name} K1 discover=False: {ms[key, False] * 1e3:.3f} us",
              flush=True)
    print(f"card: {card(dev)}", flush=True)
    raise_if_wrong(wrong)
    return dict(ms=ms)
