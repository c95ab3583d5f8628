"""ctypes bindings for the port's C++ host runtime (``huffc.cpp``).

The port's own copy of the JAX package's ``native`` module: the serial
decoders, the table builder, the truncation scan and the encoder's
bit-packer, with the same entry points and wrappers.  The library is
compiled at first use (never at import) with the host's ``g++ -O3
-march=native`` into ``_build/`` beside the package, named by a digest of
the source, the compiler's path, the flags and the target the compiler
resolves ``-march=native`` to, so a library built for another CPU or from
another source is never loaded.  Each build writes a per-process temporary
file and renames it into place, so concurrent processes never load a
half-written library.  A failed build raises: there is no numpy fallback,
since the serial oracles must be trustworthy and fast enough to decode
multi-MB ground truth.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading

import numpy as np

_HERE = pathlib.Path(__file__).resolve().parent
SOURCE = _HERE / "huffc.cpp"
BUILD_DIR = _HERE.parent / "_build"
CXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17")
_lock = threading.Lock()
_lib = None

_i64 = ctypes.c_int64
_i32 = ctypes.c_int32
_p_u8 = np.ctypeslib.ndpointer(dtype=np.uint8, flags="C_CONTIGUOUS")
_p_i32 = np.ctypeslib.ndpointer(dtype=np.int32, flags="C_CONTIGUOUS")
_p_u32 = np.ctypeslib.ndpointer(dtype=np.uint32, flags="C_CONTIGUOUS")
_p_u16 = np.ctypeslib.ndpointer(dtype=np.uint16, flags="C_CONTIGUOUS")
_p_i64 = np.ctypeslib.ndpointer(dtype=np.int64, flags="C_CONTIGUOUS")

SIGNATURES = {
    "huffc_simple_decode": ([_p_i32, _i64, _p_u8, _i64, _p_u8, _i64], _i64),
    "huffc_simple_decode_rp": ([_p_i32, _i64, _p_u8, _i64, _p_u8, _i64], _i64),
    "huffc_bigtable_decode_packed": ([_p_u16, _i32, _p_u8, _i64, _p_u8, _i64], _i64),
    "huffc_build_lut": ([_p_i32, _i64, _i32, _p_u8, _p_i32], _i64),
    "huffc_bigtable_decode": ([_p_u8, _p_i32, _i32, _p_u8, _i64, _p_u8, _i64], _i64),
    "huffc_multisym_decode": (
        [_p_u8, _p_u8, _p_i32, _i32, _i32, _p_u8, _i64, _p_u8, _i64, _p_i64],
        _i64,
    ),
    "huffc_dfa_decode": (
        [_p_u8, _p_u8, _p_i32, _i32, _i32, _p_u8, _i64, _p_u8, _i64, _p_i64, _p_i64],
        _i64,
    ),
    "huffc_dfa_decode_k8": (
        [_p_u8, _p_u8, _p_i32, _i32, _p_u8, _i64, _p_u8, _i64, _p_i64, _p_i64],
        _i64,
    ),
    "huffc_vdfa_decode": (
        [_p_u8, _p_u8, _p_i32, _p_i32, _p_i32, _i32, _p_u8, _i64, _p_u8, _i64, _p_i64, _p_i64],
        _i64,
    ),
    "huffc_tail_decode": ([_p_i32, _i64, _i64, _p_u8, _i64, _i64, _p_u8, _i64], _i64),
    "huffc_pack_codes": ([_p_u8, _i64, _p_u32, _p_i32, _p_u8], _i64),
    "huffc_sum_bytes": ([_p_u8, _i64], _i64),
    "huffc_truncate_scan": ([_p_i32, _i64, _p_u8, _i64, _p_i64], _i64),
}


def compiler() -> str:
    """Path of the C++ compiler (``$CXX``, default ``g++``); raises if it
    is not on ``PATH``."""
    cxx = os.environ.get("CXX", "g++")
    path = shutil.which(cxx)
    if path is None:
        raise RuntimeError(f"C++ compiler {cxx!r} not found: the host "
                           "runtime needs one")
    return path


def _digest(cxx: str) -> str:
    # -march=native names a different target on another CPU: the target
    # options the compiler resolves it to go into the digest
    target = subprocess.run([cxx, "-march=native", "-Q", "--help=target"],
                            capture_output=True, text=True)
    h = hashlib.sha256(SOURCE.read_bytes())
    for part in (cxx, *CXX_FLAGS, target.stdout, target.stderr):
        h.update(part.encode())
        h.update(b"\0")
    return h.hexdigest()[:16]


def lib_path() -> pathlib.Path:
    return BUILD_DIR / f"libhuffc_{_digest(compiler())}.so"


def build() -> pathlib.Path:
    """Compile the library unless this digest is already built; raises
    RuntimeError with the compiler's output when the build fails."""
    out = lib_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".so.{os.getpid()}.tmp")
    cmd = [compiler(), *CXX_FLAGS, str(SOURCE), "-o", str(tmp)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{' '.join(cmd)} failed:\n"
                           f"{(res.stdout + res.stderr)[-4000:]}")
    os.replace(tmp, out)
    return out


def get_lib() -> ctypes.CDLL:
    """The library, built and loaded at the first call."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, (argtypes, restype) in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = restype
            _lib = lib
    return _lib


def _check(ret: int, what: str) -> int:
    if ret < 0:
        raise RuntimeError(f"{what} failed with native error {ret}")
    return ret


# ---------------------------------------------------------------------------
# Wrappers over HuffFile


def simple_decode(hf) -> np.ndarray:
    """Serial bit-at-a-time oracle (semantics of mainrun.c:38-55)."""
    lib = get_lib()
    out = np.empty(hf.uncompressed_size + 8, dtype=np.uint8)
    n = _check(
        lib.huffc_simple_decode(
            hf.tree, hf.nodes, hf.payload_padded(), hf.bits, out, out.size
        ),
        "simple_decode",
    )
    return out[:n]


def simple_decode_rp(hf) -> np.ndarray:
    """Register-cached serial oracle (simpleDecodeRP semantics, mainrun.c:76-117)."""
    lib = get_lib()
    out = np.empty(hf.uncompressed_size + 8, dtype=np.uint8)
    n = _check(
        lib.huffc_simple_decode_rp(
            hf.tree, hf.nodes, hf.payload_padded(), hf.bits, out, out.size
        ),
        "simple_decode_rp",
    )
    return out[:n]


def bigtable_decode_packed(hf, lut_packed: np.ndarray, height: int) -> np.ndarray:
    """Packed-u16-entry LUT serial decode (decodeBigtableV1, mainrun.c:142-195)."""
    lib = get_lib()
    out = np.empty(hf.uncompressed_size + 8, dtype=np.uint8)
    n = _check(
        lib.huffc_bigtable_decode_packed(
            lut_packed, int(height), hf.payload_padded(4), hf.bits, out, out.size
        ),
        "bigtable_decode_packed",
    )
    return out[:n]


def build_lut(tree: np.ndarray, height: int):
    """Full-height (sym, len) lookup table over h-bit LSB-first windows."""
    lib = get_lib()
    size = 1 << height
    lut_sym = np.empty(size, dtype=np.uint8)
    lut_len = np.empty(size, dtype=np.int32)
    tree = np.ascontiguousarray(tree, dtype=np.int32)
    _check(lib.huffc_build_lut(tree, tree.shape[0], height, lut_sym, lut_len), "build_lut")
    return lut_sym, lut_len


def bigtable_decode(hf, lut_sym=None, lut_len=None, height=None) -> np.ndarray:
    """Serial full-height-LUT decode (decodeBigtableV1 semantics)."""
    from huffmandecoderongpus_tpu_torch.huffio import table_height

    lib = get_lib()
    if lut_sym is None:
        height = table_height(hf.tree) if height is None else height
        lut_sym, lut_len = build_lut(hf.tree, height)
    out = np.empty(hf.uncompressed_size + 8, dtype=np.uint8)
    n = _check(
        lib.huffc_bigtable_decode(
            lut_sym, lut_len, int(height), hf.payload_padded(4), hf.bits, out, out.size
        ),
        "bigtable_decode",
    )
    return out[:n]


def tail_decode(tree: np.ndarray, node: int, data_padded: np.ndarray, pos: int,
                bits: int, capacity: int) -> np.ndarray:
    """Finish a decode bit by bit from bit ``pos``, starting mid-walk at
    tree node ``node`` (0 at a codeword boundary)."""
    lib = get_lib()
    tree = np.ascontiguousarray(tree, dtype=np.int32)
    out = np.empty(capacity + 8, dtype=np.uint8)
    n = _check(
        lib.huffc_tail_decode(tree, tree.shape[0], node, data_padded, pos, bits, out, out.size),
        "tail_decode",
    )
    return out[:n]


def pack_codes(data: np.ndarray, code: np.ndarray, length: np.ndarray):
    """Native encoder bit-packer: returns (payload_bytes, total_bits)."""
    lib = get_lib()
    data = np.ascontiguousarray(data, dtype=np.uint8)
    code = np.ascontiguousarray(code, dtype=np.uint32)
    length = np.ascontiguousarray(length, dtype=np.int32)
    total = int(length[data].astype(np.int64).sum())
    payload = np.zeros((total + 7) // 8 + 8, dtype=np.uint8)
    bits = _check(lib.huffc_pack_codes(data, data.size, code, length, payload), "pack_codes")
    if bits != total:
        raise RuntimeError(f"pack_codes wrote {bits} bits, expected {total}")
    return payload[: (total + 7) // 8], total


def multisym_decode_raw(ms_syms, ms_count, ms_consumed, maxsym, h, data_padded, bits, capacity):
    """Multi-symbol LUT main loop; returns (decoded_prefix, next_bit_pos)."""
    lib = get_lib()
    out = np.empty(capacity + 8, dtype=np.uint8)
    pos = np.zeros(1, dtype=np.int64)
    n = _check(
        lib.huffc_multisym_decode(
            ms_syms, ms_count, ms_consumed, maxsym, h, data_padded, bits, out, out.size, pos
        ),
        "multisym_decode",
    )
    return out[:n], int(pos[0])


def dfa_decode_raw(dfa_syms, dfa_count, dfa_next, maxsym, k, data_padded, bits, capacity):
    """DFA main loop; returns (decoded_prefix, next_bit_pos, final_state).
    Dispatches to the byte-aligned fast path when k == 8."""
    lib = get_lib()
    out = np.empty(capacity + 8, dtype=np.uint8)
    pos = np.zeros(1, dtype=np.int64)
    state = np.zeros(1, dtype=np.int64)
    if k == 8:
        n = lib.huffc_dfa_decode_k8(
            dfa_syms, dfa_count, dfa_next, maxsym, data_padded, bits, out, out.size, pos, state
        )
    else:
        n = lib.huffc_dfa_decode(
            dfa_syms, dfa_count, dfa_next, maxsym, k, data_padded, bits, out, out.size, pos, state
        )
    _check(n, "dfa_decode")
    return out[:n], int(pos[0]), int(state[0])


def vdfa_decode_raw(syms, count, nxt, base, width, maxsym, data_padded, bits, capacity):
    """Variable-width DFA main loop (lin approach); returns
    (decoded_prefix, next_bit_pos, final_state)."""
    lib = get_lib()
    out = np.empty(capacity + 8, dtype=np.uint8)
    pos = np.zeros(1, dtype=np.int64)
    state = np.zeros(1, dtype=np.int64)
    n = _check(
        lib.huffc_vdfa_decode(
            syms, count, nxt, base, width, maxsym, data_padded, bits, out, out.size, pos, state
        ),
        "vdfa_decode",
    )
    return out[:n], int(pos[0]), int(state[0])


def truncate_scan(tree: np.ndarray, data_padded: np.ndarray, target_bits: int):
    """Find the last symbol boundary <= target_bits (setTargetSizes semantics,
    mainrun.c:361-385).  Returns (exact_bits, completed_symbols)."""
    lib = get_lib()
    tree = np.ascontiguousarray(tree, dtype=np.int32)
    vals = np.zeros(2, dtype=np.int64)
    _check(
        lib.huffc_truncate_scan(tree, tree.shape[0], data_padded, target_bits, vals),
        "truncate_scan",
    )
    return int(vals[0]), int(vals[1])


def sum_bytes(data: np.ndarray) -> int:
    """Sum of all bytes: the justreaddata bandwidth floor (mainrun.c:28-36)."""
    lib = get_lib()
    data = np.ascontiguousarray(data, dtype=np.uint8)
    return int(lib.huffc_sum_bytes(data, data.size))
