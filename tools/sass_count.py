"""Instruction counts of a kernel's loops, from the SASS of a built library.

    from tools.sass_count import kernel_loops
    loops = kernel_loops("pysp_tpu_torch/_build/libpysp_kernels_<hash>.so", "decision_kernel")

``cuobjdump -sass`` (next to ``nvcc``) disassembles the library; the function
whose name holds the given part is cut out and split into instructions. A loop
is a branch back to a lower address; ``kernel_loops`` returns the innermost
ones (no other back edge inside them) in address order. For each it counts
the instructions from its head to its back edge three ways: ``count``, all of
them, as if every branch inside ran both of its sides; ``shortest`` and
``longest``, along the path through the body with the fewest and with the most
instructions. A path ends at a call (the IEEE division's slow path, which nvcc
places after the kernel's exit and reaches by a call, is not taken) and at a
branch out of the loop's address range. ``ops`` counts the body's
instructions by opcode (``LDG.E`` is ``LDG``).
"""
from __future__ import annotations

import re
import shutil
import subprocess
from collections import Counter
from pathlib import Path

_LINE = re.compile(
    r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_.]*)([^;]*);")
_TARGET = re.compile(r"0x([0-9a-f]+)")


def _cuobjdump() -> str:
    from pysp_tpu_torch.ops import cuda_kernels as K

    found = Path(K._nvcc()).with_name("cuobjdump")
    if found.exists():
        return str(found)
    which = shutil.which("cuobjdump")
    if which is None:
        raise RuntimeError("cuobjdump not found next to nvcc or on PATH")
    return which


def kernel_sass(library: str | Path, name_part: str) -> list[tuple[int, str, str, str]]:
    """(address, predicate, opcode, operands) of every instruction but NOP of
    the one function of ``library`` whose name holds ``name_part``."""
    text = subprocess.run([_cuobjdump(), "-sass", str(library)], check=True,
                          capture_output=True, text=True).stdout
    bodies = [b for b in text.split("Function : ")[1:] if name_part in b.split("\n", 1)[0]]
    if len(bodies) != 1:
        raise ValueError(f"{len(bodies)} functions of {library} hold {name_part!r}")
    out = []
    for m in _LINE.finditer(bodies[0]):
        if m.group(3) != "NOP":
            out.append((int(m.group(1), 16), (m.group(2) or "").strip(), m.group(3),
                        m.group(4).strip()))
    return out


def _target(op: str, rest: str):
    if not op.startswith("BRA"):
        return None
    t = _TARGET.search(rest)
    return int(t.group(1), 16) if t else None


def innermost_loops(instrs) -> list[dict]:
    """The innermost loops of a function's instructions, in address order:
    ``start`` and ``end`` (the head's and the back edge's addresses),
    ``count``, ``shortest`` and ``longest`` (see the module's docstring)."""
    edges = []
    for addr, _, op, rest in instrs:
        t = _target(op, rest)
        if t is not None and t < addr:
            edges.append((t, addr))
    loops = []
    for start, end in sorted(set(edges)):
        if any(s >= start and e <= end and (s, e) != (start, end) for s, e in edges):
            continue
        body = [i for i in instrs if start <= i[0] <= end]
        index = {a: k for k, (a, _, _, _) in enumerate(body)}
        # Paths from the head: instructions issued up to and including each one.
        inf = float("inf")
        short = [inf] * len(body)
        long = [-inf] * len(body)
        short[0] = long[0] = 1
        for k, (addr, pred, op, rest) in enumerate(body):
            if short[k] == inf or k == len(body) - 1:
                continue
            succ = []
            t = _target(op, rest)
            always = pred in ("", "@PT")
            if (op.startswith("EXIT") or op.startswith("CALL")) and always:
                pass
            elif t is not None:
                if t in index and t > addr:
                    succ.append(index[t])
                if not always:
                    succ.append(k + 1)
            else:
                succ.append(k + 1)
            for j in succ:
                short[j] = min(short[j], short[k] + 1)
                long[j] = max(long[j], long[k] + 1)
        loops.append({"start": start, "end": end, "count": len(body),
                      "shortest": short[-1], "longest": long[-1],
                      "ops": Counter(op.split(".")[0] for _, _, op, _ in body)})
    return loops


def kernel_loops(library: str | Path, name_part: str) -> list[dict]:
    return innermost_loops(kernel_sass(library, name_part))
