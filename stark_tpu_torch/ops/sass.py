"""Instruction counts of the kernel library, read from its SASS.

The least time an operation-bound kernel can take on the card is set by
the instructions it issues.  ``cuobjdump -sass`` lists them for every
kernel of the built library; :func:`functions` splits that listing by
kernel, :func:`straight_line` counts a kernel that runs its whole body
once per thread, and :func:`loops` counts the bodies of the innermost
loops of the others, so the caller can multiply each body by the
iterations its inputs need, and :func:`enclosing` the loop around one of
them.  :func:`local_accesses` counts a kernel's loads and stores of local
memory (spilled or run-time indexed arrays).

Counts are in warp instructions, split by the pipe that executes them on
sm_90 (Hopper): every instruction is issued, one a clock by each of an
SM's 4 schedulers; integer adds, logic, shifts, compares, selects and
byte permutes run on the ALU pipe and the integer multiply-adds (``IMAD``
in all its forms) on the FMA-heavy pipe, each 64 lanes, so two warp
instructions a clock per SM (CUDA C++ Programming Guide, arithmetic
instruction throughput for compute capability 9.0).  Instructions of
other pipes (loads, stores, barriers, moves, conversions) count towards
the issue limit only, so the bound these counts give is a lower one.
"""

from __future__ import annotations

import os
import re
import subprocess
from collections import Counter
from typing import Dict, List, NamedTuple

#: warp instructions an SM issues in a clock, and those its ALU and
#: FMA-heavy pipes each retire in a clock
ISSUE_PER_CLOCK = 4
ALU_PER_CLOCK = 2
FMA_PER_CLOCK = 2
ALU_OPS = frozenset({"IADD3", "LOP3", "SHF", "ISETP", "SEL", "PRMT", "LEA", "IMNMX", "IABS"})
FMA_OPS = frozenset({"IMAD", "IMUL"})

_FUNCTION = re.compile(r"Function : (\S+)")
_INSTRUCTION = re.compile(r"^\s+/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
_BRANCH_TARGET = re.compile(r"\bBRA\b.*?(0x[0-9a-f]+)")


class Counts(NamedTuple):
    """Warp instructions: all of them (issue), and those of the ALU and
    FMA-heavy pipes."""

    issue: float = 0.0
    alu: float = 0.0
    fma: float = 0.0

    def __add__(self, other: "Counts") -> "Counts":
        return Counts(*(a + b for a, b in zip(self, other)))

    def __mul__(self, k: float) -> "Counts":
        return Counts(*(a * k for a in self))

    def seconds(self, sms: int, clock_hz: float) -> float:
        """Least time the card's ``sms`` SMs at ``clock_hz`` take to issue
        and execute these instructions."""
        return max(self.issue / ISSUE_PER_CLOCK, self.alu / ALU_PER_CLOCK, self.fma / FMA_PER_CLOCK) / (sms * clock_hz)


class Loop(NamedTuple):
    counts: Counts          # one pass through the body
    opcodes: Counter        # opcode -> instructions in the body
    branch_free: bool       # no branch or exit inside but the back edge


def opcode(instruction: str) -> str:
    """``@!P0 IMAD.WIDE.U32 R2, ...`` -> ``IMAD``."""
    if instruction.startswith("@"):
        instruction = instruction.split(None, 1)[1]
    return instruction.split(None, 1)[0].split(".", 1)[0]


def disassemble(library: str, nvcc: str) -> str:
    """``cuobjdump -sass`` of ``library``, with the cuobjdump beside ``nvcc``."""
    cuobjdump = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    return subprocess.run([cuobjdump, "-sass", library], capture_output=True, text=True, check=True).stdout


def functions(sass: str) -> Dict[str, List[tuple]]:
    """Mangled kernel name -> its (address, instruction) list."""
    out: Dict[str, List[tuple]] = {}
    current = None
    for line in sass.splitlines():
        m = _FUNCTION.search(line)
        if m:
            current = out.setdefault(m.group(1), [])
            continue
        m = _INSTRUCTION.match(line)
        if m and current is not None:
            current.append((int(m.group(1), 16), m.group(2)))
    return out


def find(funcs: Dict[str, List[tuple]], part: str) -> List[tuple]:
    """The one kernel whose mangled name contains ``part``."""
    hits = [name for name in funcs if part in name]
    if len(hits) != 1:
        raise LookupError(f"{len(hits)} kernels in the SASS match {part!r}: {hits}")
    return funcs[hits[0]]


def count(instructions) -> Counts:
    """Counts of the instructions a warp runs once each."""
    ops = [opcode(i) for _, i in instructions if opcode(i) != "NOP"]
    return Counts(len(ops), sum(o in ALU_OPS for o in ops), sum(o in FMA_OPS for o in ops))


def local_accesses(instructions) -> Dict[str, int]:
    """Local-memory loads (``LDL``) and stores (``STL``) of a kernel."""
    ops = Counter(opcode(i) for _, i in instructions)
    return {"LDL": ops["LDL"], "STL": ops["STL"]}


def _target(instruction: str):
    m = _BRANCH_TARGET.search(instruction)
    return int(m.group(1), 16) if m else None


def straight_line(instructions) -> Counts:
    """Counts of a kernel without branches, whose threads run its body
    once: every instruction but the padding (``NOP``) and the closing
    self-branch.  Raises if the kernel branches anywhere else."""
    body = [(a, i) for a, i in instructions if opcode(i) != "NOP"]
    if body and opcode(body[-1][1]) == "BRA" and _target(body[-1][1]) == body[-1][0]:
        body = body[:-1]
    branches = [i for _, i in body if opcode(i) == "BRA"]
    if branches:
        raise ValueError(f"not a straight-line kernel: {branches[:3]}")
    return count(body)


def _spans(instructions) -> List[tuple]:
    """(first, last) index of every loop: a backward branch and its target."""
    index = {addr: k for k, (addr, _) in enumerate(instructions)}
    spans = []
    for k, (addr, ins) in enumerate(instructions):
        target = _target(ins) if opcode(ins) == "BRA" else None
        if target is not None and target < addr:
            spans.append((index[target], k))
    return spans


def _loop(instructions, first: int, last: int) -> Loop:
    body = instructions[first : last + 1]
    ops = Counter(opcode(i) for _, i in body if opcode(i) != "NOP")
    branch_free = all(opcode(i) not in ("BRA", "EXIT") for _, i in body[:-1])
    return Loop(count(body), ops, branch_free)


def _innermost(spans) -> List[tuple]:
    return sorted((a, b) for a, b in spans if not any(a <= c and d <= b and (c, d) != (a, b) for c, d in spans))


def loops(instructions) -> List[Loop]:
    """The innermost loops (a backward branch whose body holds no other
    backward branch), in address order, without the closing self-branch."""
    return [_loop(instructions, a, b) for a, b in _innermost(_spans(instructions))]


def enclosing(instructions, k: int = 0) -> Loop:
    """The loop that most tightly encloses the k-th innermost loop (address
    order), its whole body counted once, the inner loop's among it."""
    spans = _spans(instructions)
    a, b = _innermost(spans)[k]
    outer = [(c, d) for c, d in spans if c <= a and b <= d and (c, d) != (a, b)]
    if not outer:
        raise LookupError(f"innermost loop {k} is not inside another loop")
    c, d = min(outer, key=lambda s: s[1] - s[0])
    return _loop(instructions, c, d)
