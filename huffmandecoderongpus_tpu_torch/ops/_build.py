"""Build and load the CUDA kernels (K1-K4) from ``csrc/``.

All kernel sources compile with ``nvcc`` for ``sm_90a`` into one shared
library with a plain C interface, loaded with ``ctypes`` (no PyTorch headers,
so a build takes seconds).  The library lands in ``_build/`` beside the
package, named by a digest of its sources and flags, so an edited source is
always rebuilt.  Building happens at first use, never at import.

Every launcher returns ``cudaGetLastError()`` after its launch; ``check``
turns a nonzero code into a ``RuntimeError``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading

_PKG = pathlib.Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("k1_scan2.cu", "k2_compose.cu", "k3_fix2.cu", "k4_compact.cu")
HEADERS = ("widescan.cuh",)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    # wmat, tab, lim, sym, val, cntmap, exmap, mrowmap,
    # G, steps_w, B, H, steps, steps_p, SEG, md, C0, C1, NS, stream
    "ws_k1_scan2": [_P] * 8 + [_I] * 11 + [_P],
    # exmap, entry, tot, gmap, goff, G, HP, start, L, NGp, stream
    "ws_k2_compose": [_P] * 5 + [_I] * 5 + [_P],
    # wmat, tab, ent, cut, cutsl, sym, val,
    # G, steps_w, steps_p, SEG, md, C0, C1, NS, stream
    "ws_k3_fix2": [_P] * 7 + [_I] * 8 + [_P],
    # sym, val, out, G, cells_p, ORP, stream
    "ws_k4_compact": [_P] * 3 + [_I] * 3 + [_P],
}

_lock = threading.Lock()
_lib = None


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
    """Compile the kernels unless this digest is already built.  The
    compiler's output (``-Xptxas -v``: registers, spills) goes to
    ``_build/build.log``."""
    out = lib_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".so.{os.getpid()}.tmp")
    cmd = [nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
           *(str(CSRC / s) for s in SOURCES)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    (BUILD_DIR / "build.log").write_text(
        " ".join(cmd) + "\n" + res.stdout + res.stderr)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stderr[-4000:]}")
    tmp.replace(out)
    return out


def get_lib() -> ctypes.CDLL:
    """Load (building if needed) the kernel library."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.ws_error_string.argtypes = [ctypes.c_int]
            lib.ws_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib


def check(rc: int, what: str) -> None:
    """Raise if a launcher reported a CUDA error."""
    if rc != 0:
        msg = get_lib().ws_error_string(rc).decode(errors="replace")
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")


def stream_ptr(t) -> ctypes.c_void_p:
    """The current CUDA stream of ``t``'s device, as a ctypes pointer."""
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def require_cuda(what: str, *tensors) -> None:
    """Check that the kernel can take these tensors: CUDA, contiguous, on
    one device."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev or t.device.type != "cuda":
            raise ValueError(f"{what}: all tensors must be on one CUDA device")
        if not t.is_contiguous():
            raise ValueError(f"{what}: tensors must be contiguous")
