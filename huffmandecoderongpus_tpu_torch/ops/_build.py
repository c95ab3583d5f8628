"""Build and load the CUDA kernels from ``csrc/``.

Every kernel source compiles with its own ``nvcc`` for ``sm_90a``, all
started together, and the objects link into one shared library with a plain
C interface, loaded with ``ctypes`` (no PyTorch headers, so a build takes
seconds).  The library lands in ``_build/`` beside the package, named by a
digest of its sources and flags, so an edited source is always rebuilt.
Building happens at first use, never at import.

Every launcher returns ``cudaGetLastError()`` after its launch; ``check``
turns a nonzero code into a ``RuntimeError``.

The launch path, shared by every wrapper, makes no Python object a launch:
``get_lib`` takes a lock only until the library has loaded (its launchers
are typed once then), the wrappers hand ``ctypes`` each pointer as
``data_ptr()`` and ``stream_ptr`` the stream as plain ints (``argtypes``
makes them ``c_void_p``), the stream is read on every call from ``torch._C._cuda_getCurrentRawStream``
where this torch has it (no ``torch.cuda.Stream`` is made), and
``require_cuda`` asks each tensor ``is_contiguous``, ``is_cuda`` and
``get_device`` (no ``torch.device`` is made).  ``probe dispatch`` prints
what each part costs the host.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading

import torch

_PKG = pathlib.Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("k1_scan2.cu", "k2_compose.cu", "k3_fix2.cu", "k4_compact.cu",
           "k1_scan.cu", "k3_fix.cu", "candidate_scan.cu", "lane_scan.cu",
           "oneshot.cu", "e1_pack.cu", "e2_compact.cu", "e3_place.cu",
           "k1_main.cu", "lane_scan_indexed.cu", "k1_scan2_c01.cu",
           "k3_fix2_c01.cu", "short_candidate_scan.cu",
           "lane_decode_dense.cu", "compact.cu", "probe_inc.cu",
           "probe_arith.cu", "probe_gather.cu", "k4_stripped.cu")
HEADERS = ("widescan.cuh", "lookback.cuh")
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")
#: most int32 words of the padded fused table the lane-DFA kernels stage
#: in shared memory: 1023 states, two entries each
LANEDFA_TAB_WORDS = 2048

#: the card the launch plans assume for CPU tensors (H100 SXM): SMs, and an
#: SM's shared memory, threads and registers (NVIDIA's Hopper tuning guide);
#: a plan for CUDA tensors takes its device's own SM count (``sm_count``)
SM_COUNT = 132
SM_SHARED = 228 * 1024
SM_THREADS = 2048
SM_REGISTERS = 65536
#: shared memory a block may take (dynamic and static), and the bytes the
#: card reserves beside each block
BLOCK_SHARED_MAX = 227 * 1024
BLOCK_RESERVED = 1024

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_SIGNATURES = {
    # wmat, tab, lim, sym, val, cntmap, exmap, mrowmap,
    # G, steps_w, B, H, steps, steps_p, SEG, md, C0, C1, NS, T, shared,
    # stream
    "ws_k1_scan2": [_P] * 8 + [_I] * 13 + [_P],
    # exmap, entry, tot, state, cap, G, HP, start, TL, SL, threads, shared,
    # stream
    "ws_k2_compose": [_P] * 4 + [_I] * 8 + [_P],
    # wmat, tab, ent, cut, cutsl, sym, val,
    # G, steps_w, steps_p, SEG, md, C0, C1, NS, stream
    "ws_k3_fix2": [_P] * 7 + [_I] * 8 + [_P],
    # sym, val, out, G, cells_p, ORP, lanes, vec, chunks, window, threads,
    # shared, stream
    "ws_k4_compact": [_P] * 3 + [_I] * 9 + [_P],
    # wmat, tab, lim, sym, val, cntmap, exmap, mrowmap,
    # G, steps_w, B, H, steps, steps_p, NS, T, shared, stream
    "ws_k1_scan": [_P] * 8 + [_I] * 9 + [_P],
    # wmat, tab, ent, cut, cutsl, sym, val, G, steps_w, steps_p, NS, stream
    "ws_k3_fix": [_P] * 7 + [_I] * 4 + [_P],
    # bits, tab, cnt, ex, G, B, H, N, tab_words, L, R, vec, shared, stream
    "ws_candidate_scan": [_P] * 4 + [_I] * 9 + [_P],
    # bits, tab, start, sym, valid, G, B, rows, N, tab_words,
    # L, R, vec, shared, stream
    "ws_lane_scan": [_P] * 5 + [_I] * 9 + [_P],
    # words, tab, lim, out, n, total, scratch, offsets, scratch bytes,
    # stamps, G, BW, B, H, steps, steps_p, SEG, md, C0, C1, NS, ORP, L, NGp,
    # T, K4's lanes, vec, chunks and window, shared, stream
    "ws_oneshot": [_P] * 8 + [_LL, _P] + [_I] * 20 + [_P],
    # data, lo, hi, nval, gran, gval, cnt, bits, state, cap, K, G, lanes,
    # vec, chunks, rows, row blocks, threads, shared, blocks, stream
    "ws_e1_pack": [_P] * 9 + [_I] * 11 + [_P],
    # gran, gval, out, state, cap, rows, G, ORP, lanes, vec, chunks, block
    # rows, row blocks, window, threads, shared, blocks, stream
    "ws_e2_compact": [_P] * 4 + [_I] * 13 + [_P],
    # shifted, word_off, occ, out, G, ORP, n_out, stream
    "ws_e3_place": [_P] * 4 + [_I] * 2 + [_LL, _P],
    # wmat, tab, lim, sym, val, G, steps_w, steps_p, md, C0, C1, NS,
    # threads, shared, stream
    "ws_k1_main": [_P] * 5 + [_I] * 9 + [_P],
    # bits, tab, lane_len, sym, valid, G, B, tab_words, stream
    "ws_lane_scan_indexed": [_P] * 5 + [_I] * 3 + [_P],
    # wmat, tabs, lim, c01, bstream, sym, val, cntmap, exmap, mrowmap,
    # G, steps_w, B, H, steps, steps_p, SEG, md, T, shared, stream
    "ws_k1_scan2_c01": [_P] * 10 + [_I] * 10 + [_P],
    # wmat, tabs, ent, cut, cutsl, c01, bstream, sym, val,
    # G, steps_w, steps_p, SEG, md, stream
    "ws_k3_fix2_c01": [_P] * 9 + [_I] * 5 + [_P],
    # bits, tab, valid0, merged, exited, mrow, cnt, ex,
    # G, B, H, N, W, tab_words, stream
    "ws_short_candidate_scan": [_P] * 8 + [_I] * 6 + [_P],
    # bits, tab, start, dense, counts, G, B, H, N, out_rows, tab_words, stream
    "ws_lane_decode_dense": [_P] * 5 + [_I] * 6 + [_P],
    # cum, sym, out, steps, G, out_rows, stream
    "ws_compact": [_P] * 3 + [_I] * 3 + [_P],
    # x, out, n, stream
    "ws_probe_inc": [_P] * 2 + [_LL, _P],
    # x, out, work, steps, block_words, work_words, stream
    "ws_probe_grid": [_P] * 3 + [_I] * 2 + [_LL, _P],
    # x, out, n, S, body, P, bits, stream
    "ws_probe_arith": [_P] * 2 + [_I] * 5 + [_P],
    # tab, idx, out, R, W, Rt, Wt, axis, elem, index type, stream
    "ws_probe_gather": [_P] * 3 + [_I] * 7 + [_P],
    # x, out, R, W, axis, elem, shift, stream
    "ws_probe_roll": [_P] * 2 + [_I] * 5 + [_P],
    # tab, init, out, R, C, P, S, broadcast, stream
    "ws_probe_gather_chain": [_P] * 3 + [_I] * 5 + [_P],
    # sym, nib, out, G, cells_p, ORP, prefix, stream
    "ws_k4_stripped": [_P] * 3 + [_I] * 4 + [_P],
}

_lock = threading.Lock()
_lib = None
#: device index -> the raw pointer of its current stream
_current_raw_stream = getattr(
    torch._C, "_cuda_getCurrentRawStream",
    lambda index: torch.cuda.current_stream(index).cuda_stream)


def nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin/nvcc``, then ``PATH``, then
    ``/usr/local/cuda/bin/nvcc``.  Raises if none exists."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    cands = [pathlib.Path(home) / "bin" / "nvcc"] if home else []
    found = shutil.which("nvcc")
    if found:
        cands.append(pathlib.Path(found))
    cands.append(pathlib.Path("/usr/local/cuda/bin/nvcc"))
    for c in cands:
        if c.exists():
            return str(c)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def lib_path() -> pathlib.Path:
    return BUILD_DIR / f"libwidescan_{_digest()}.so"


def build() -> pathlib.Path:
    """Compile the kernels unless this digest is already built: one
    ``nvcc -c`` per source, all running at once, then one link.  The
    compilers' output (``-Xptxas -v``: registers, spills) goes to
    ``_build/build.log``."""
    out = lib_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{out.stem}.{os.getpid()}"
    exe = nvcc()
    jobs = []
    for src in SOURCES:
        obj = BUILD_DIR / f"{pathlib.Path(src).stem}.{tag}.o"
        cmd = [exe, *NVCC_FLAGS, "-I", str(CSRC), "-c", "-o", str(obj),
               str(CSRC / src)]
        jobs.append((cmd, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    log, failed = [], []
    for cmd, _obj, proc in jobs:  # wait for every compiler, failed or not
        log.append(" ".join(cmd) + "\n" + proc.communicate()[0])
        if proc.returncode != 0:
            failed.append(log[-1])
    tmp = out.with_suffix(f".so.{os.getpid()}.tmp")
    if not failed:
        cmd = [exe, *ARCH, "-shared", "-o", str(tmp),
               *(str(obj) for _cmd, obj, _proc in jobs)]
        res = subprocess.run(cmd, capture_output=True, text=True)
        log.append(" ".join(cmd) + "\n" + res.stdout + res.stderr)
        if res.returncode != 0:
            failed.append(log[-1])
    for _cmd, obj, _proc in jobs:
        obj.unlink(missing_ok=True)
    (BUILD_DIR / "build.log").write_text("\n".join(log))
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed)[-4000:])
    tmp.replace(out)
    return out


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)  # kept in the library's __dict__
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.ws_error_string.argtypes = [ctypes.c_int]
            lib.ws_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib


def get_lib() -> ctypes.CDLL:
    """The kernel library, built and loaded at the first call.  Its
    launchers are looked up and typed once, when it loads; after that this
    takes no lock."""
    lib = _lib
    return _load() if lib is None else lib


def check(rc: int, what: str, error=RuntimeError) -> None:
    """Raise ``error`` if a launcher reported a CUDA error."""
    if rc != 0:
        msg = get_lib().ws_error_string(rc).decode(errors="replace")
        raise error(f"{what}: CUDA error {rc} ({msg})")


def stream_ptr(t) -> int:
    """The current CUDA stream of ``t``'s device as an int (``ctypes``
    makes it the launcher's pointer), read afresh on every call: a caller
    may switch streams or capture a graph."""
    return _current_raw_stream(t.get_device())


def sm_count(device) -> int:
    """SMs a launch plan for tensors on ``device`` assumes: a CUDA
    device's own count, else ``SM_COUNT``."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return SM_COUNT
    return _sms(torch.cuda.current_device() if dev.index is None
                else dev.index)


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def require_cuda(what: str, *tensors) -> None:
    """Check that the kernel can take these tensors: contiguous, CUDA, on
    one device.  Raises ``ValueError``; nothing falls back."""
    dev = tensors[0].get_device()
    for t in tensors:
        if not t.is_contiguous():
            raise ValueError(f"{what}: tensors must be contiguous")
        if not t.is_cuda or t.get_device() != dev:
            raise ValueError(f"{what}: all tensors must be on one CUDA device")
