"""The ctypes signatures of the kernels' launchers against their C
declarations, on the CPU.

``ops/_build.py`` types every launcher of the kernel library once
(``_SIGNATURES``: a pointer, ``int`` or ``long long`` an argument); a
launcher whose C declaration (``extern "C" int ws_...(...)`` in
``csrc/*.cu``) takes other arguments would get them cut or shifted on the
card.  Here each declaration is parsed and held against its entry.
"""

import ctypes
import re

import pytest

from huffmandecoderongpus_tpu_torch.ops import _build

DECL = re.compile(r'extern "C" int (ws_\w+)\(([^)]*)\)', re.S)


def _declarations():
    out = {}
    for src in _build.SOURCES:
        text = (_build.CSRC / src).read_text()
        for name, params in DECL.findall(text):
            out[name] = [p.strip() for p in params.split(",")]
    return out


def _kind(param: str):
    if "*" in param or param.startswith("cudaStream_t"):
        return ctypes.c_void_p
    if param.startswith("long long"):
        return ctypes.c_longlong
    if param.startswith("int "):
        return ctypes.c_int
    raise AssertionError(f"unexpected parameter {param!r}")


DECLS = _declarations()


def test_every_launcher_is_typed():
    assert set(DECLS) == set(_build._SIGNATURES)


@pytest.mark.parametrize("name", sorted(DECLS))
def test_launcher_signature_matches_source(name):
    assert [_kind(p) for p in DECLS[name]] == _build._SIGNATURES[name]
