"""Count the SASS instructions of the port's kernels by opcode, for the
``learningorchestra_tpu_torch`` package under a given root, so that two
versions of a kernel source can be compared on the machine that has nvcc.

    python3 scripts/torch_sass_counts.py [PACKAGE_ROOT] [LABEL] [SOURCE]

PACKAGE_ROOT (default: this repository) holds the package; SOURCE (default
``quant``) names ``csrc/<SOURCE>.cu``, which is built there by the
package's own ``kernels/build.py``.  ``cuobjdump -sass`` disassembles the
library; the script prints one JSON line: per kernel, the static count of
all instructions and of the opcodes that say where the time goes (global
loads and stores by width, calls to subroutines such as the integer and
float division slow paths, conversions, shuffles, barriers).  Static counts
are a reading of the code, not of a run: an instruction inside a loop
counts once.
"""

from __future__ import annotations

import collections
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent

# Opcode prefixes worth a column of their own.
WATCH = ("LDG", "STG", "LDS", "STS", "LDC", "CALL", "RET", "BRA", "I2F",
         "F2I", "MUFU", "SHFL", "BAR", "IMAD", "FFMA", "FMUL", "FCHK",
         "FRND", "IADD3", "LOP3", "SHF", "PRMT", "ISETP", "FSETP", "SEL")


def cuobjdump() -> str:
    for cand in ("/usr/local/cuda/bin/cuobjdump", shutil.which("cuobjdump")):
        if cand and Path(cand).is_file():
            return cand
    raise SystemExit("cuobjdump not found")


def count(sass: str) -> dict:
    kernels: dict = {}
    name = None
    for line in sass.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m.group(1)
            kernels[name] = collections.Counter()
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)",
                     line)
        if m and name:
            kernels[name][m.group(2)] += 1
    out = {}
    for name, ops in kernels.items():
        total = sum(ops.values())
        entry = {"total": total}
        for prefix in WATCH:
            n = sum(v for k, v in ops.items() if k.split(".")[0] == prefix)
            if n:
                entry[prefix] = n
        # Memory instructions by their full opcode (width and cache hints).
        entry["memory"] = {k: v for k, v in sorted(ops.items())
                           if k.split(".")[0] in ("LDG", "STG")}
        out[name] = entry
    return out


def main() -> int:
    root = Path(sys.argv[1]).resolve() if len(sys.argv) > 1 else REPO
    label = sys.argv[2] if len(sys.argv) > 2 else root.name
    source = sys.argv[3] if len(sys.argv) > 3 else "quant"
    sys.path.insert(0, str(root))
    from learningorchestra_tpu_torch.kernels import build

    build.build((source,))
    lib = build.library_path(source)
    sass = subprocess.run([cuobjdump(), "-sass", str(lib)],
                          capture_output=True, text=True, check=True).stdout
    print(json.dumps({"label": label, "source": f"csrc/{source}.cu",
                      "kernels": count(sass)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
