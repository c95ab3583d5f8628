"""The SASS of each kernel in two builds of the port's kernel library, side
by side.

    python3 huffmandecoderongpus_tpu_torch/harness/sass_diff.py LIB_A LIB_B

Runs ``cuobjdump -sass`` (the CUDA toolkit's, beside ``nvcc``) on both
shared libraries (``_build/libwidescan_*.so`` of two trees), cuts each
listing into its functions, and prints one line a function: ``same`` where
its instructions are the same in both, ``differs`` (with the instruction
counts) where they are not, ``only in A``/``only in B`` where one build
lacks it.  A function's name is compared without the anonymous
namespace's hash, which changes with the source file's path and digest.
The last line is a JSON object {function: status}.  Needs the CUDA
toolkit; no card.
"""

from __future__ import annotations

import json
import pathlib
import re
import subprocess
import sys

#: the checkout this file is in, whose ``_build.nvcc`` finds the toolkit
HERE = pathlib.Path(__file__).resolve().parents[2]
#: the hashed anonymous-namespace part of a mangled name
_ANON = re.compile(r"\d+_GLOBAL__N__[0-9a-f]{8}_\d+_\w+?_cu_[0-9a-f]{8}")
_FUNC = re.compile(r"^\s*Function : (\S+)")
_INSN = re.compile(r"/\*[0-9a-f]{4,}\*/\s*(.*?)\s*;")


def functions(lib: str) -> dict[str, list[str]]:
    """{normalized function name: its instructions} of ``lib``'s SASS."""
    if str(HERE) not in sys.path:
        sys.path.insert(0, str(HERE))
    from huffmandecoderongpus_tpu_torch.ops import _build

    tool = pathlib.Path(_build.nvcc()).with_name("cuobjdump")
    text = subprocess.run([str(tool), "-sass", lib], capture_output=True,
                          text=True, check=True).stdout
    out, cur = {}, None
    for line in text.splitlines():
        m = _FUNC.match(line)
        if m:
            cur = _ANON.sub("ANON", m.group(1))
            out[cur] = []
            continue
        m = _INSN.search(line)
        if cur is not None and m:
            out[cur].append(m.group(1))
    return out


def main(argv=None) -> int:
    args = sys.argv[1:] if argv is None else argv
    if len(args) != 2:
        print(__doc__.split("\n\n")[1], file=sys.stderr)
        return 2
    a, b = (functions(x) for x in args)
    status = {}
    for name in sorted(set(a) | set(b)):
        if name not in b:
            status[name] = "only in A"
        elif name not in a:
            status[name] = "only in B"
        elif a[name] == b[name]:
            status[name] = "same"
        else:
            status[name] = (f"differs ({len(a[name])} and {len(b[name])} "
                            "instructions)")
        print(f"[sass] {name}: {status[name]}")
    print(json.dumps(status))
    return 0


if __name__ == "__main__":
    sys.exit(main())
