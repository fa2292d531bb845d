#!/usr/bin/env python3
"""Count the SASS instructions of the port's kernels, and of one Fq / Fr
Montgomery product.

    python3 tools/sass_count.py [--lib marlin_tpu_torch/build/<curve>/libmarlin_cuda.so] [--out PATH]

Disassembles the kernel library with `cuobjdump -sass` (CUDA toolkit) and
counts, per kernel: all instructions, and the integer multiplies (IMAD and
IMUL forms that multiply; the IMAD.MOV / .SHL / .IADD forms that the
compiler uses as moves, shifts and adds are counted apart).  One product's
count is the binop kernel's mul instance less its add instance (the same
loads, stores and indexing around one field op), for Fq (12 limbs; 8 for
BN254) and Fr (8 limbs; 24 for test_wide750) of the library's curve: the
direct body (`binop_kernel`), whose loop holds one product; the staged
body (`binop_staged_kernel`) and the grouped NTT stages
(`cross_stages_kernel`, the kernel of the earlier one-stage
`cross_stage_kernel`) are counted as kernels.  Kernel names are matched in
either template form the library has used: `binop_kernel<FqTraits, 0>`
and the older `binop_kernel<12, 0>`.

Prints one JSON object (and writes it to `--out`).  Needs `cuobjdump`; runs
no kernel and needs no GPU.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import re
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFAULT_LIB = os.path.join(ROOT, "marlin_tpu_torch", "build", "bls12_381", "libmarlin_cuda.so")

# (field, op) -> mangled-name fragments of binop_kernel's instance, new and old form
_BINOP = {
    ("fq", "mul"): ("binop_kernelI8FqTraitsLi0E", "binop_kernelILi12ELi0E"),
    ("fq", "add"): ("binop_kernelI8FqTraitsLi1E", "binop_kernelILi12ELi1E"),
    ("fr", "mul"): ("binop_kernelI8FrTraitsLi0E", "binop_kernelILi8ELi0E"),
    ("fr", "add"): ("binop_kernelI8FrTraitsLi1E", "binop_kernelILi8ELi1E"),
}
# kernel label -> mangled-name fragment
_KERNELS = {
    "g1_add": "add_kernel",
    "g1_double": "double_kernel",
    "g1_scalar_mul": "scalar_mul_kernel",
    "bucket_fold (fast)": "fold_kernelILb0E",
    "bucket_fold (exact)": "fold_kernelILb1E",
    "combine_windows": "combine_kernel",
    "imad_rate (4 rows)": "imad_rate_kernelILi4E",
    "imad_rate (8 rows)": "imad_rate_kernelILi8E",
    "field_inv (fr)": ("inv_kernelI8FrTraitsE", "inv_kernelILi8EE"),
    "field_inv (fq)": ("inv_kernelI8FqTraitsE", "inv_kernelILi12EE"),
    "ntt_block_stages": "block_stages_kernel",
    "ntt_cross_stages": ("cross_stages_kernel", "cross_stage_kernel"),
    "field_binop (fr mul)": "binop_kernelI8FrTraitsLi0E",
    "field_binop staged (fr mul)": "binop_staged_kernelI8FrTraitsLi0E",
    "field_binop (fq mul)": "binop_kernelI8FqTraitsLi0E",
    "field_binop staged (fq mul)": "binop_staged_kernelI8FqTraitsLi0E",
}
_INSN = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)")
_NOT_MUL = (".MOV", ".SHL", ".IADD")


def cuobjdump() -> str:
    for cand in (shutil.which("cuobjdump"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("cuobjdump not found")


def functions(lib: str) -> dict:
    """mangled function name -> list of SASS opcodes (with modifiers)."""
    text = subprocess.run([cuobjdump(), "-sass", lib], capture_output=True, text=True,
                          check=True).stdout
    out: dict = {}
    name = None
    for line in text.splitlines():
        s = line.strip()
        if s.startswith("Function :"):
            name = s.split(":", 1)[1].strip()
            out[name] = []
        elif name is not None:
            m = _INSN.search(line)
            if m:
                out[name].append(m.group(1))
    return out


def is_multiply(op: str) -> bool:
    return (op.startswith("IMAD") and not any(t in op for t in _NOT_MUL)) or op.startswith("IMUL")


def summary(ops: list) -> dict:
    kinds = collections.Counter(op.split(".")[0] for op in ops)
    return {
        "instructions": len(ops),
        "multiplies": sum(is_multiply(op) for op in ops),
        "imad_other": sum(op.startswith("IMAD") and not is_multiply(op) for op in ops),
        "top_opcodes": dict(kinds.most_common(8)),
    }


def find(fns: dict, fragments) -> list | None:
    if isinstance(fragments, str):
        fragments = (fragments,)
    for name, ops in fns.items():
        if any(f in name for f in fragments):
            return ops
    return None


def count(lib: str) -> dict:
    fns = functions(lib)
    rec = {"lib": os.path.relpath(lib, ROOT), "kernels": {}, "product": {}}
    for label, frag in _KERNELS.items():
        ops = find(fns, frag)
        if ops is not None:
            rec["kernels"][label] = summary(ops)
    for field in ("fq", "fr"):
        mul, add = find(fns, _BINOP[(field, "mul")]), find(fns, _BINOP[(field, "add")])
        if mul is None or add is None:
            continue
        sm, sa = summary(mul), summary(add)
        rec["product"][field] = {
            "instructions": sm["instructions"] - sa["instructions"],
            "multiplies": sm["multiplies"] - sa["multiplies"],
            "binop_mul_kernel": sm,
        }
    return rec


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--lib", default=DEFAULT_LIB)
    ap.add_argument("--out")
    args = ap.parse_args()
    rec = count(os.path.abspath(args.lib))
    print(json.dumps(rec))
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(rec, f, indent=1)
    return 0 if rec["product"] else 1


if __name__ == "__main__":
    sys.exit(main())
