#!/usr/bin/env python3
"""Read the apply kernel's compiled code (SASS) instruction by instruction.

Run from the root of a checkout, on a machine with the CUDA toolkit
(``nvcc`` and ``cuobjdump``):

    python3 scripts/apply_sass.py [--against DIR] [--out DIR]

Builds ``src/repro_torch/csrc/sweep_apply.cu`` with the port's nvcc
flags (and, with ``--against``, the ``sweep_apply.cu`` of another
checkout's ``src/repro_torch/csrc`` beside it), dumps each of the six
instantiations ``sweep_apply_kernel<float|__nv_bfloat16, 0|1|2>`` with
``cuobjdump -sass`` into ``--out`` (default ``build/sass``) and
prints one JSON line per instantiation: its instructions by class, and
an output's share of the item loop that runs the 13-point star
(``item_mix``).  The compiled operator shapes are unrolled, so a shape's
taps are one straight-line block whose ``FMUL`` count is its taps times
the outputs an item computes (13 x 4 = 52 in the element loop, 13 x 8 =
104 in the bf16 pair loop); the item's index work and stores are the
rest of the item loop.  With ``--against``, a last line says for each
instantiation whether the two builds' SASS is the same instruction for
instruction.
"""

from __future__ import annotations

import argparse
import json
import re
import shutil
import subprocess
import sys
from collections import Counter
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))

KERNEL = re.compile(r"sweep_apply_kernelI(f|13__nv_bfloat16)Li(\d)E")
INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
TARGET = re.compile(r"\b(0x[0-9a-f]+)\b")
# Opcode (its base, before the first '.') -> class.
CLASSES = {
    "LDS": "shared_load", "LDSM": "shared_load",
    "FMUL": "fp", "FADD": "fp", "FFMA": "fp",
    "F2F": "convert", "F2FP": "convert", "PRMT": "convert",
    "STG": "global_store", "LDG": "global_load", "STS": "shared_store",
    "LDGSTS": "async_copy", "LDGDEPBAR": "async_copy", "DEPBAR": "async_copy",
    "LDC": "constant", "ULDC": "constant",
    "BRA": "control", "BSSY": "control", "BSYNC": "control", "EXIT": "control",
    "BAR": "control", "WARPSYNC": "control", "RET": "control",
    "CALL": "control", "NOP": "nop",
}
# The 13-point star's taps, whose unrolled block the mix is read from.
STAR13_TAPS = 13


def opcode(text: str) -> str:
    """The base opcode of one SASS instruction (predicate dropped)."""
    words = text.split()
    if words and words[0].startswith("@"):
        words = words[1:]
    return words[0].split(".")[0] if words else ""


def classify(text: str) -> str:
    op = opcode(text)
    if op in CLASSES:
        return CLASSES[op]
    # A bf16 unpacks to f32 by a 16-bit shift or a mask of its top half.
    if (op in ("SHF", "IMAD", "LOP3")
            and ("0x10000" in text or "0xffff0000" in text)):
        return "convert"
    if op.startswith("U"):
        return "uniform"
    return "integer"


def functions(sass: str) -> dict[str, list[tuple[int, str]]]:
    """Each instantiation's instructions (address within the function,
    text), by name."""
    out: dict[str, list[tuple[int, str]]] = {}
    cur = None
    for line in sass.splitlines():
        if "Function :" in line:
            m = KERNEL.search(line)
            cur = (f"{'float' if m.group(1) == 'f' else 'bf16'}_sweep"
                   f"{m.group(2)}") if m else None
            if cur:
                out[cur] = []
            continue
        ins = INSN.search(line) if cur else None
        if ins:
            out[cur].append((int(ins.group(1), 16), ins.group(2)))
    return out


def blocks(insns: list[tuple[int, str]]) -> dict[int, list[str]]:
    """Basic blocks by start address: a block starts at a branch target
    and after each branch, call, return or exit."""
    leaders = {insns[0][0]} if insns else set()
    for i, (_, text) in enumerate(insns):
        op = opcode(text)
        if op in ("BRA", "BRX", "CALL", "RET", "EXIT"):
            if op == "BRA":
                leaders.update(int(t, 16) for t in TARGET.findall(text))
            if i + 1 < len(insns):
                leaders.add(insns[i + 1][0])
    out: dict[int, list[str]] = {}
    cur = None
    for addr, text in insns:
        if addr in leaders:
            cur = addr
            out[cur] = []
        out[cur].append(text)
    return out


def loops(insns: list[tuple[int, str]]) -> list[tuple[int, int]]:
    """Every loop as the span (target, address) of a backward branch."""
    return sorted({(int(t, 16), addr) for addr, text in insns
                   if opcode(text) == "BRA"
                   for t in TARGET.findall(text) if int(t, 16) <= addr})


def item_mix(insns: list[tuple[int, str]], outputs: int) -> dict | None:
    """Instructions an output of the item loop whose 13-point-star block
    (STAR13_TAPS x ``outputs`` FMUL, straight-line) computes ``outputs``
    outputs: that block's mix, and the rest of the item loop's body (the
    loop enclosing the RHS loop around the block) outside every block
    that multiplies and every nested loop that holds one (the other
    shapes' and the table-driven taps), counted once on every branch (so
    an upper bound on what one item issues there).  None where the
    function has no such block."""
    bl = blocks(insns)
    fmul = {a: sum(opcode(t) == "FMUL" for t in body)
            for a, body in bl.items()}
    star = [a for a, n in fmul.items() if n == STAR13_TAPS * outputs]
    if len(star) != 1:
        return None
    (a0,) = star
    spans = [(lo, hi) for lo, hi in loops(insns) if lo <= a0 <= hi]
    if len(spans) < 2:
        return None
    spans.sort(key=lambda s: s[1] - s[0])
    rhs = spans[0]
    item = next(s for s in spans[1:]
                if s[0] <= rhs[0] and rhs[1] <= s[1] and s != rhs)
    hot = [s for s in loops(insns)
           if item[0] <= s[0] and s[1] <= item[1] and s != item
           and s != rhs and any(s[0] <= a <= s[1] and fmul[a]
                                for a in bl)]
    rest = Counter()
    for a, body in bl.items():
        if not item[0] <= a <= item[1] or fmul[a]:
            continue
        if any(lo <= a <= hi for lo, hi in hot):
            continue
        rest.update(classify(t) for t in body)
    star_mix = Counter(classify(t) for t in bl[a0])

    def per(c):
        return {k: round(v / outputs, 2) for k, v in sorted(c.items())}

    return {"outputs_per_item": outputs,
            "star13_block": {"insns": round(len(bl[a0]) / outputs, 2),
                             **per(star_mix)},
            "rest_of_item": {"insns": round(sum(rest.values()) / outputs, 2),
                             **per(rest)}}


def compare_key(insns: list[tuple[int, str]] | None) -> list[str] | None:
    """The instruction texts, for comparing two builds (branch targets are
    addresses within the function, so equal code reads equal)."""
    return None if insns is None else [t for _, t in insns]


def build(csrc: Path, tag: str, out_dir: Path) -> Path:
    from repro_torch.kernels import _build

    so = out_dir / f"sweep_apply_{tag}.so"
    proc = subprocess.run(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(csrc), "-o", str(so),
         str(csrc / "sweep_apply.cu")], capture_output=True, text=True)
    if proc.returncode != 0:
        raise SystemExit(f"nvcc failed for {tag}:\n{proc.stdout}"
                         f"{proc.stderr}")
    for ln in _build._ptxas_lines(proc.stdout + proc.stderr):
        if "Used" in ln or "spill" in ln:
            print(json.dumps({"build": tag, "ptxas": ln}), flush=True)
    return so


def cuobjdump() -> str:
    from repro_torch.kernels import _build

    found = shutil.which("cuobjdump") or str(
        Path(_build._nvcc()).parent / "cuobjdump")
    if not Path(found).exists():
        raise SystemExit("cuobjdump not found beside nvcc")
    return found


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--against", type=Path, default=None,
                    help="another checkout whose sweep_apply.cu is compared")
    ap.add_argument("--out", type=Path, default=ROOT / "build" / "sass")
    args = ap.parse_args()
    args.out.mkdir(parents=True, exist_ok=True)
    tool = cuobjdump()
    builds = {"this": ROOT / "src" / "repro_torch" / "csrc"}
    if args.against is not None:
        builds["against"] = args.against / "src" / "repro_torch" / "csrc"
    code = {}
    for tag, csrc in builds.items():
        so = build(csrc, tag, args.out)
        sass = subprocess.run([tool, "-sass", str(so)], capture_output=True,
                              text=True, check=True).stdout
        (args.out / f"sweep_apply_{tag}.sass").write_text(sass)
        code[tag] = functions(sass)
        for name, insns in sorted(code[tag].items()):
            print(json.dumps({
                "build": tag, "kernel": name, "insns": len(insns),
                "mix": dict(Counter(classify(t) for _, t in insns)),
                "element_loop": item_mix(insns, 4),
                "pair_loop": item_mix(insns, 8),
            }), flush=True)
    if "against" in code:
        same = {name: compare_key(code["this"].get(name))
                == compare_key(code["against"].get(name))
                for name in sorted(set(code["this"]) | set(code["against"]))}
        print(json.dumps({"same_sass": same}), flush=True)


if __name__ == "__main__":
    main()
