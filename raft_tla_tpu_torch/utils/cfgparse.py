"""Parser for TLC model config files — the port's copy of
``raft_tla_tpu/utils/cfgparse.py``.

Understands ``SPECIFICATION``, ``INIT``/``NEXT``, ``INVARIANT(S)``,
``CONSTANT(S)``, ``CONSTRAINT(S)``, ``PROPERTY``/``PROPERTIES``, ``SYMMETRY``
and ``VIEW`` with TLC's comment syntax, and records the source line of every
name it reads so that errors point at it.  The stanzas the port cannot
check (a VIEW other than ParityView, any VIEW with ``--faithful``,
PROPERTY, expression invariants) are parsed here and refused in
``check.resolve_check_config``.
"""

from __future__ import annotations

import dataclasses
import difflib
import re

_IDENT = re.compile(r"[A-Za-z_]\w*\Z")


def is_expression(text: str) -> bool:
    """A bare identifier is a registered-invariant NAME; anything else is
    a predicate expression (the reference's frontend/predicate.py)."""
    return _IDENT.match(text.strip()) is None

_STANZAS = (
    "SPECIFICATION",
    "INVARIANTS",
    "INVARIANT",
    "CONSTANTS",
    "CONSTANT",
    "CONSTRAINTS",
    "CONSTRAINT",
    "PROPERTIES",
    "PROPERTY",
    "INIT",
    "NEXT",
    "SYMMETRY",
    "VIEW",
)


@dataclasses.dataclass
class TLCConfig:
    specification: str | None = None
    init: str | None = None
    next: str | None = None
    invariants: list[str] = dataclasses.field(default_factory=list)
    properties: list[str] = dataclasses.field(default_factory=list)
    constraints: list[str] = dataclasses.field(default_factory=list)
    # Name -> python value: list[str] for set bindings, str for model values.
    constants: dict = dataclasses.field(default_factory=dict)
    symmetry: list[str] = dataclasses.field(default_factory=list)
    view: str | None = None
    # (kind, name) -> 1-based source line, e.g. ("invariant", "NoTwoLeaders")
    # -> 3.  Kinds: invariant, property, constraint, constant, symmetry,
    # view, specification, init, next.  Diagnostics only; equality and the
    # model mapping ignore it.
    lines: dict = dataclasses.field(default_factory=dict, compare=False)

    def server_names(self) -> list[str]:
        v = self.constants.get("Server")
        if not isinstance(v, list):
            raise ValueError("cfg does not bind Server to a finite set")
        return v

    def value_names(self) -> list[str]:
        v = self.constants.get("Value")
        if not isinstance(v, list):
            raise ValueError("cfg does not bind Value to a finite set")
        return v

    def line_of(self, kind: str, name: str) -> int | None:
        return self.lines.get((kind, name))


def _strip_comment(line: str) -> str:
    # TLA+ end-of-line comment: \* ... (also tolerate (* ... *) on one line)
    line = re.sub(r"\(\*.*?\*\)", " ", line)
    idx = line.find("\\*")
    if idx >= 0:
        line = line[:idx]
    return line.strip()


def _parse_set(text: str) -> list[str]:
    inner = text.strip()
    if not (inner.startswith("{") and inner.endswith("}")):
        raise ValueError(f"not a set literal: {text!r}")
    body = inner[1:-1].strip()
    if not body:
        return []
    toks = [tok.strip() for tok in body.split(",")]
    if any(not t for t in toks):
        raise ValueError(f"empty element in set literal: {text!r}")
    return toks


def parse_cfg(text: str) -> TLCConfig:
    cfg = TLCConfig()
    mode: str | None = None
    for lineno, raw in enumerate(text.splitlines(), start=1):
        line = _strip_comment(raw)
        if not line:
            continue
        # A stanza keyword may start the line, optionally with an inline value
        # (separated by any whitespace — stock TLC accepts tabs too).
        parts = line.split(None, 1)
        if parts[0] in _STANZAS:
            mode = parts[0]
            line = parts[1].strip() if len(parts) > 1 else ""
            if not line:
                continue
        if mode in ("SPECIFICATION",):
            cfg.specification = line
            cfg.lines[("specification", line)] = lineno
        elif mode == "INIT":
            cfg.init = line
            cfg.lines[("init", line)] = lineno
        elif mode == "NEXT":
            cfg.next = line
            cfg.lines[("next", line)] = lineno
        elif mode in ("INVARIANT", "INVARIANTS"):
            # Bare registry names may share a line like stock TLC; any
            # line that is NOT all bare identifiers is one whole-line
            # predicate EXPRESSION (frontend/predicate.py grammar).
            names = line.split()
            if any(is_expression(nm) for nm in names):
                text = " ".join(names)
                cfg.invariants.append(text)
                cfg.lines[("invariant", text)] = lineno
            else:
                for name in names:
                    cfg.invariants.append(name)
                    cfg.lines[("invariant", name)] = lineno
        elif mode in ("PROPERTY", "PROPERTIES"):
            # temporal FORMULAS (<>P, []<>P, P ~> Q) are one property
            # per line; bare names may share a line like INVARIANTS
            if "<>" in line or "~>" in line:
                formula = " ".join(line.split())
                cfg.properties.append(formula)
                cfg.lines[("property", formula)] = lineno
            else:
                for name in line.split():
                    cfg.properties.append(name)
                    cfg.lines[("property", name)] = lineno
        elif mode in ("CONSTRAINT", "CONSTRAINTS"):
            for name in line.split():
                cfg.constraints.append(name)
                cfg.lines[("constraint", name)] = lineno
        elif mode == "SYMMETRY":
            for name in line.split():
                cfg.symmetry.append(name)
                cfg.lines[("symmetry", name)] = lineno
        elif mode == "VIEW":
            cfg.view = line
            cfg.lines[("view", line)] = lineno
        elif mode in ("CONSTANT", "CONSTANTS"):
            if "=" not in line:
                raise ValueError(
                    f"line {lineno}: bad CONSTANTS binding: {raw!r}")
            name, _, val = line.partition("=")
            name, val = name.strip(), val.strip()
            # "<-" substitutions are not supported (not used by the reference).
            if val.startswith("{"):
                cfg.constants[name] = _parse_set(val)
            else:
                cfg.constants[name] = val.strip('"')
            cfg.lines[("constant", name)] = lineno
        else:
            raise ValueError(
                f"line {lineno}: line outside any stanza: {raw!r} "
                f"(known stanzas: {', '.join(_STANZAS)})")
    return cfg


def suggest(name: str, known) -> list[str]:
    """Did-you-mean candidates for an unknown cfg name."""
    return difflib.get_close_matches(name, sorted(known), n=3, cutoff=0.5)


def unknown_names(names, known) -> list[tuple[str, list[str]]]:
    """The subset of ``names`` not in ``known``, each with suggestions.
    Non-raising — analysis/cfglint turns these into findings."""
    known = set(known)
    return [(n, suggest(n, known)) for n in names if n not in known]


def resolve_names(names, known, kind: str, *, cfg: TLCConfig | None = None,
                  path: str | None = None) -> list[str]:
    """Validate cfg names against a registry, raising on the first unknown
    with the offending source line, a did-you-mean, and the full registry
    (shared by check.py config resolution and the Pass 2 lint)."""
    bad = unknown_names(names, known)
    if not bad:
        return list(names)
    name, hints = bad[0]
    where = ""
    if cfg is not None:
        lineno = cfg.line_of(kind, name)
        if lineno is not None:
            where = f"{path or 'cfg'} line {lineno}: "
    hint_txt = f" (did you mean: {', '.join(hints)}?)" if hints else ""
    raise ValueError(
        f"{where}unknown {kind} {name!r}{hint_txt}; "
        f"known: {', '.join(sorted(known))}")


def load_cfg(path: str) -> TLCConfig:
    with open(path, "r", encoding="utf-8") as f:
        return parse_cfg(f.read())
