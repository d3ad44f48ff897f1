"""Count the machine instructions of the port's kernels and device functions
by kind, from `cuobjdump -sass` of the libraries the port built (beside
the FP32 operations chip_smoke.py counts from the sources).

    python tools/sass_ops.py [--lib pairs|fused_shade|...] [--match NAME]

For every kernel whose mangled name holds `--match` (default: all) it
prints the instruction count and the FP32 ones (FADD, FMUL, FFMA, FMNMX,
FSETP, FSEL, MUFU, FCHK) by opcode. The count is of the kernel's code,
every branch once (device functions inlined or not), not of what one
element runs. Needs the CUDA toolkit's cuobjdump and a built library under
build/torch_kernels/ (any chip_smoke.py or test run builds them).
"""
from __future__ import annotations

import argparse
import re
import shutil
import subprocess
import sys
from collections import Counter
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
FP32 = ("FADD", "FMUL", "FFMA", "FMNMX", "FSETP", "FSEL", "MUFU", "FCHK")


def cuobjdump() -> str:
    for cand in (shutil.which("cuobjdump"), "/usr/local/cuda/bin/cuobjdump"):
        if cand and Path(cand).is_file():
            return cand
    raise SystemExit("cuobjdump not found")


def functions(sass: str) -> dict:
    """{mangled name: Counter of opcodes} of a cuobjdump -sass listing."""
    out, name = {}, None
    for line in sass.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m.group(1)
            out[name] = Counter()
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)", line)
        if name and m and m.group(1) != "NOP":
            out[name][m.group(1)] += 1
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--lib", default="pairs", help="library stem under build/torch_kernels/")
    ap.add_argument("--match", default="")
    args = ap.parse_args()
    libs = sorted((ROOT / "build" / "torch_kernels").glob(f"{args.lib}_*.so"),
                  key=lambda p: p.stat().st_mtime)
    if not libs:
        sys.exit(f"no build/torch_kernels/{args.lib}_*.so: build it first")
    sass = subprocess.run([cuobjdump(), "-sass", str(libs[-1])], capture_output=True, text=True,
                          check=True).stdout
    for name, ops in functions(sass).items():
        if args.match not in name:
            continue
        fp = {k: v for k, v in ops.items() if k.split(".")[0] in FP32}
        print(f"{name}: {sum(ops.values())} instructions, FP32 {sum(fp.values())} "
              f"({', '.join(f'{k} {v}' for k, v in sorted(fp.items()))})")


if __name__ == "__main__":
    main()
