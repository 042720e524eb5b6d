"""Findings — the port's copy of ``raft_tla_tpu/analysis/report.py``, the
one result type of the five analysis passes.

A finding is a *claim about the model or its sources*, not a runtime
event: severity ``error`` means the pass could not prove the property it
exists to prove (a width-safety hole, an unresolvable cfg name), severity
``warning`` means a hazard that does not by itself unsound the checker
(a tracer-hostile idiom, a vacuous invariant).  Exit-code policy follows
the split: errors always fail, warnings only under ``--strict`` — so
the width pass exits 0 on a healthy tree
while still printing what it noticed.
"""

from __future__ import annotations

import ast
import dataclasses
import functools

ERROR = "error"
WARNING = "warning"

# Pass identifiers (the `pass_` field); stable for waiver lists and tests.
WIDTH = "width"      # Pass 1: interval width-safety
CFG = "cfg"          # Pass 2: spec/config lint
JIT = "jit"          # Pass 3: tracer-hazard AST lint
THREAD = "thread"    # Pass 4: static race detector (host threading seams)
CONTRACT = "contract"  # Pass 5: runtime-contract lint (gates, obs schema)


@dataclasses.dataclass(frozen=True)
class Finding:
    """One diagnostic: which pass, how bad, and where.

    ``transition``/``field``/``interval``/``width`` carry Pass 1's proof
    obligation (the acceptance contract: every overflow is reported with
    all four); ``file``/``line`` locate Pass 2/3 findings in sources.
    """

    pass_: str                      # WIDTH | CFG | JIT | THREAD | CONTRACT
    severity: str                   # ERROR | WARNING
    code: str                       # stable kebab-case id, e.g. "width-overflow"
    message: str
    transition: str | None = None   # action family (Pass 1)
    field: str | None = None        # struct field / packed subfield
    interval: tuple | None = None   # (lo, hi) derived value interval
    width: int | None = None        # allotted bits
    file: str | None = None         # source path (Pass 3) / cfg path (Pass 2)
    line: int | None = None

    def format(self) -> str:
        loc = ""
        if self.file:
            loc = f"{self.file}:{self.line}: " if self.line else f"{self.file}: "
        ctx = []
        if self.transition:
            ctx.append(f"transition={self.transition}")
        if self.field:
            ctx.append(f"field={self.field}")
        if self.interval is not None:
            ctx.append(f"interval=[{self.interval[0]}, {self.interval[1]}]")
        if self.width is not None:
            ctx.append(f"width={self.width}")
        ctx_txt = f" ({', '.join(ctx)})" if ctx else ""
        return f"{loc}{self.severity}[{self.code}]: {self.message}{ctx_txt}"


def has_errors(findings) -> bool:
    return any(f.severity == ERROR for f in findings)


def render(findings, header: str | None = None) -> str:
    lines = [header] if header else []
    lines += [f.format() for f in findings]
    n_err = sum(1 for f in findings if f.severity == ERROR)
    n_warn = len(findings) - n_err
    lines.append(f"{n_err} error(s), {n_warn} warning(s)")
    return "\n".join(lines)


def exit_code(findings, strict: bool = False) -> int:
    if has_errors(findings):
        return 1
    if strict and findings:
        return 1
    return 0


@functools.lru_cache(maxsize=1024)
def parse(src: str, path: str = "<string>") -> ast.Module:
    """``ast.parse`` shared by passes 3-5, which read the same sources:
    one parse a file per process.  The trees are read, never changed."""
    return ast.parse(src, filename=path)
