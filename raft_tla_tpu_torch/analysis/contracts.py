"""Pass 5 — runtime-contract lint: gates, obs schema, waiver audit.

The port's copy of ``raft_tla_tpu/analysis/contracts.py``: the same
rules and finding codes, over the port's own tree — the sources of
``raft_tla_tpu_torch/``, the schema of ``raft_tla_tpu_torch/obs/events.py``,
the identity digest ``raft_tla_tpu_torch/utils/ckpt.config_digest`` and
the README.  The gate contract's *smoke* leg is the port's own: the
reference reads ``tools/lint.sh``, which runs the JAX package; the port's
smoke runs are ``chip_smoke.py`` and the ``tools/*_run.py`` drivers, so
their text is what a gate or its flag must appear in (``Inputs.lint_sh``
keeps the reference's field name).  The waiver audit relints with the
port's Pass 3 (:mod:`.jitlint`, host syncs) and Pass 4
(:mod:`.threadlint`).

The repo carries two families of cross-file contracts that no runtime
test can see end to end:

- **Gates.**  Every ``RAFT_TLA_*`` environment variable is a promise:
  a CLI flag sets it, exactly one resolution helper reads it, a
  smoke run exercises it, the README documents it,
  and it never leaks into the checkpoint identity digest (gates toggle
  *how* a state space is explored, never *which* state space — a gate
  in the digest would make checkpoints unresumable across gate
  settings).  Each leg of that promise lives in a different file, so a
  new gate can silently ship half-wired.  This pass discovers every
  gate name in the sources (string constants merge across implicit
  concatenation, so split help-text literals still count) and checks
  all five legs, with did-you-mean on names that appear exactly once
  within edit distance 2 of an established gate.

- **Obs schema.**  ``obs/events.py`` declares a versioned field set
  per event type; consumers (the campaign supervisor, Perfetto export,
  RESULTS.md tooling) parse by that declaration.  Every emission
  site's *literal* field set must be a subset of the declared fields
  for its event type — a new field can never ship without a schema
  bump.  ``**fields`` splats are invisible to this pass; they are
  covered at runtime by ``validate_event``.

- **Waivers.**  ``# lint: jit-ok`` / ``# lint: thread-ok`` comments
  suppress findings forever, so each must still be *earning* its keep:
  a jit waiver is stale when stripping it and re-linting the file
  produces no finding on that line; a thread waiver is stale when the
  race detector no longer needs it.  Stale waivers are errors — they
  read as "this line is dangerous" over code that no longer is, and
  they would silently mask a *future* regression of a different kind.
"""

from __future__ import annotations

import ast
import dataclasses
import glob
import io
import os
import re
import tokenize

from raft_tla_tpu_torch.analysis import jitlint, report, threadlint
from raft_tla_tpu_torch.analysis.report import CONTRACT, ERROR, Finding

GATE_RE = re.compile(r"\bRAFT_TLA_[A-Z0-9][A-Z0-9_]*\b")

WAIVER_KINDS = ("jit-ok", "thread-ok")

_SCHEMA_PATH = "raft_tla_tpu_torch/obs/events.py"
_DIGEST_PATH = "raft_tla_tpu_torch/utils/ckpt.py"
_DIGEST_FUNC = "config_digest"
# The smoke leg: the port's chip smoke and its chip drivers.
SMOKE_PATHS = ("chip_smoke.py", os.path.join("tools", "*_run.py"))


@dataclasses.dataclass
class Inputs:
    """Everything the contract lint cross-checks, injectable for tests."""
    sources: dict                       # {relpath: python source}
    readme: str = ""
    lint_sh: str = ""                   # the smoke text (SMOKE_PATHS)
    schema_path: str = _SCHEMA_PATH
    digest_path: str = _DIGEST_PATH


def _edit_distance(a: str, b: str) -> int:
    if abs(len(a) - len(b)) > 2:
        return 3                        # caller only cares about <= 2
    prev = list(range(len(b) + 1))
    for i, ca in enumerate(a, 1):
        cur = [i]
        for j, cb in enumerate(b, 1):
            cur.append(min(prev[j] + 1, cur[-1] + 1,
                           prev[j - 1] + (ca != cb)))
        prev = cur
    return prev[-1]


def _flag_text(gate: str) -> str:
    """``RAFT_TLA_PHASE_TIMERS`` -> ``--phase-timers`` (fallback guess;
    the authoritative flag comes from the parser's add_argument call)."""
    return "--" + gate[len("RAFT_TLA_"):].lower().replace("_", "-")


def _mentions(text: str, gate: str, flags: set) -> bool:
    if re.search(re.escape(gate) + r"\b", text):
        return True
    for fl in flags | {_flag_text(gate)}:
        if re.search(re.escape(fl) + r"(?![a-z0-9-])", text):
            return True
    return False


# --------------------------------------------------------------------------
# gate contract


class _GateScan(ast.NodeVisitor):
    """Per-file AST facts: env-var aliases, environ reads, argparse
    flags, and which gates each ``add_argument`` call mentions."""

    def __init__(self, path: str, aliases: dict):
        self.path = path
        self.aliases = aliases          # shared: ENV_X name -> gate
        self.reads: list = []           # (gate, line)
        self.flag_gates: dict = {}      # gate -> set of option strings

    def visit_Assign(self, node: ast.Assign):
        if isinstance(node.value, ast.Constant) and \
                isinstance(node.value.value, str) and \
                GATE_RE.fullmatch(node.value.value):
            for t in node.targets:
                if isinstance(t, ast.Name):
                    self.aliases[t.id] = node.value.value
        self.generic_visit(node)

    def _gate_of(self, node: ast.AST) -> str | None:
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            m = GATE_RE.fullmatch(node.value)
            return m.group(0) if m else None
        if isinstance(node, ast.Name):
            return self.aliases.get(node.id)
        if isinstance(node, ast.Attribute):   # events.ENV_EVENTS
            return self.aliases.get(node.attr)
        return None

    @staticmethod
    def _is_environ(node: ast.AST) -> bool:
        return isinstance(node, ast.Attribute) and node.attr == "environ"

    def visit_Call(self, node: ast.Call):
        f = node.func
        # os.environ.get(GATE, ...)
        if isinstance(f, ast.Attribute) and f.attr == "get" and \
                self._is_environ(f.value) and node.args:
            g = self._gate_of(node.args[0])
            if g:
                self.reads.append((g, node.lineno))
        # p.add_argument("--flag", ..., help="... names the gate ...")
        if isinstance(f, ast.Attribute) and f.attr == "add_argument":
            opts = {a.value for a in node.args
                    if isinstance(a, ast.Constant)
                    and isinstance(a.value, str)
                    and a.value.startswith("--")}
            gates = set()
            for sub in ast.walk(node):
                if isinstance(sub, ast.Constant) and \
                        isinstance(sub.value, str):
                    gates.update(GATE_RE.findall(sub.value))
            for g in gates:
                self.flag_gates.setdefault(g, set()).update(opts)
        self.generic_visit(node)

    def visit_Subscript(self, node: ast.Subscript):
        # os.environ[GATE] in Load position only (writes are the CLI
        # side of the contract, not a resolver)
        if self._is_environ(node.value) and \
                isinstance(node.ctx, ast.Load):
            g = self._gate_of(node.slice)
            if g:
                self.reads.append((g, node.lineno))
        self.generic_visit(node)


def _gate_contract(inp: Inputs, trees: dict) -> list:
    findings = []
    # occurrence census over raw text (docstrings, comments, literals)
    occ: dict = {}
    for path in sorted(inp.sources):
        for i, line in enumerate(inp.sources[path].splitlines(), 1):
            for g in GATE_RE.findall(line):
                occ.setdefault(g, []).append((path, i))

    aliases: dict = {}
    scans = []
    for path in sorted(trees):
        sc = _GateScan(path, aliases)
        scans.append(sc)
    for sc in scans:                    # aliases first, then reads/flags
        sc.visit(trees[sc.path])
    for sc in scans:
        sc.reads = []
        sc.flag_gates = {}
        sc.visit(trees[sc.path])

    established = {g for g, sites in occ.items() if len(sites) >= 2}
    gates = []
    for g in sorted(occ):
        if len(occ[g]) == 1:
            near = sorted(e for e in established
                          if 0 < _edit_distance(g, e) <= 2)
            if near:
                path, line = occ[g][0]
                findings.append(Finding(
                    CONTRACT, ERROR, "gate-near-miss",
                    f"{g} appears exactly once and is within edit "
                    f"distance 2 of {near[0]} — did you mean "
                    f"{near[0]}? (a typo'd gate name reads the wrong "
                    "env var and silently never fires)",
                    field=g, file=path, line=line))
                continue
        gates.append(g)

    reads: dict = {}
    flags: dict = {}
    for sc in scans:
        for g, line in sc.reads:
            reads.setdefault(g, []).append((sc.path, line))
        for g, opts in sc.flag_gates.items():
            flags.setdefault(g, set()).update(opts)

    digest_src = _function_source(inp, inp.digest_path, _DIGEST_FUNC)

    for g in gates:
        path, line = occ[g][0]
        r = reads.get(g, [])
        if not r:
            findings.append(Finding(
                CONTRACT, ERROR, "gate-no-resolver",
                f"{g} has no resolution helper — nothing reads it from "
                "os.environ, so setting it does nothing",
                field=g, file=path, line=line))
        elif len(r) > 1:
            sites = ", ".join(f"{p}:{ln}" for p, ln in sorted(r))
            findings.append(Finding(
                CONTRACT, ERROR, "gate-multiple-resolvers",
                f"{g} is resolved in {len(r)} places ({sites}) — "
                "precedence can fork; route every consumer through one "
                "helper",
                field=g, file=r[0][0], line=r[0][1]))
        if g not in flags:
            findings.append(Finding(
                CONTRACT, ERROR, "gate-no-cli-flag",
                f"{g} has no CLI flag — no add_argument call mentions "
                "it, so the gate is env-only and invisible to --help",
                field=g, file=path, line=line))
        gate_flags = flags.get(g, set())
        if not _mentions(inp.lint_sh, g, gate_flags):
            findings.append(Finding(
                CONTRACT, ERROR, "gate-no-smoke",
                f"{g} has no smoke run — neither the gate nor its flag "
                f"({', '.join(sorted(gate_flags)) or _flag_text(g)}) "
                "appears in chip_smoke.py or tools/*_run.py, so a "
                "regression behind the gate ships unexercised",
                field=g, file=path, line=line))
        if not _mentions(inp.readme, g, gate_flags):
            findings.append(Finding(
                CONTRACT, ERROR, "gate-no-readme",
                f"{g} is not documented in the README (neither the "
                "gate name nor its flag appears)",
                field=g, file=path, line=line))
        if digest_src and re.search(re.escape(g) + r"\b", digest_src):
            findings.append(Finding(
                CONTRACT, ERROR, "gate-in-digest",
                f"{g} appears in {inp.digest_path}:{_DIGEST_FUNC} — "
                "gates toggle how a space is explored, never which "
                "space; a gate in the identity digest makes every "
                "checkpoint unresumable across gate settings",
                field=g, file=inp.digest_path))
    return findings


def _function_source(inp: Inputs, path: str, func: str) -> str:
    src = inp.sources.get(path)
    if src is None:
        return ""
    try:
        tree = ast.parse(src)
    except SyntaxError:
        return ""
    for node in tree.body:
        if isinstance(node, ast.FunctionDef) and node.name == func:
            return ast.get_source_segment(src, node) or ""
    return ""


# --------------------------------------------------------------------------
# obs-schema contract


def _dict_keys(node: ast.AST, named: dict) -> set | None:
    if isinstance(node, ast.Name):
        return named.get(node.id)
    if not isinstance(node, ast.Dict):
        return None
    out = set()
    for k in node.keys:
        if isinstance(k, ast.Constant) and isinstance(k.value, str):
            out.add(k.value)
    return out


def parse_schema(schema_src: str) -> tuple:
    """``(allowed, events)`` from obs/events.py's declaration tables:
    ``allowed[event] = _BASE ∪ _REQUIRED[event] ∪ _OPTIONAL[event]``."""
    tree = ast.parse(schema_src)
    named: dict = {}
    req: dict = {}
    opt: dict = {}
    base: set = set()
    for node in tree.body:
        if not (isinstance(node, ast.Assign) and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)):
            continue
        name = node.targets[0].id
        if isinstance(node.value, ast.Dict):
            keys = _dict_keys(node.value, named)
            named[name] = keys
            if name == "_BASE":
                base = keys or set()
            elif name in ("_REQUIRED", "_OPTIONAL"):
                table = req if name == "_REQUIRED" else opt
                for k, v in zip(node.value.keys, node.value.values):
                    if isinstance(k, ast.Constant):
                        table[k.value] = _dict_keys(v, named) or set()
    events = set(req) | set(opt)
    allowed = {ev: base | req.get(ev, set()) | opt.get(ev, set())
               for ev in events}
    return allowed, events


def _obs_contract(inp: Inputs, trees: dict) -> list:
    schema_src = inp.sources.get(inp.schema_path)
    if schema_src is None:
        return []
    allowed, events = parse_schema(schema_src)
    findings = []
    for path in sorted(trees):
        for node in ast.walk(trees[path]):
            if not isinstance(node, ast.Call):
                continue
            f = node.func
            ev_arg = None
            if isinstance(f, ast.Name) and f.id == "append_event" and \
                    len(node.args) >= 2:
                ev_arg = node.args[1]
            elif isinstance(f, ast.Attribute) and \
                    f.attr in ("emit", "_emit") and node.args:
                ev_arg = node.args[0]
            if not (isinstance(ev_arg, ast.Constant) and
                    isinstance(ev_arg.value, str)):
                continue
            ev = ev_arg.value
            if ev not in events:
                findings.append(Finding(
                    CONTRACT, ERROR, "obs-unknown-event",
                    f'emission of undeclared event type "{ev}" — not '
                    "in obs/events.py's _REQUIRED/_OPTIONAL tables; "
                    "declare it (with a schema bump if it is new)",
                    field=ev, file=path, line=node.lineno))
                continue
            for kw in node.keywords:
                if kw.arg is None:       # **fields: runtime's job
                    continue
                if kw.arg not in allowed[ev]:
                    findings.append(Finding(
                        CONTRACT, ERROR, "obs-undeclared-field",
                        f'field "{kw.arg}" of event "{ev}" is not in '
                        "the declared schema — a new field must land "
                        "in obs/events.py's tables with a "
                        "SCHEMA_VERSION bump before any site emits it",
                        field=f"{ev}.{kw.arg}", file=path,
                        line=node.lineno))
    return findings


# --------------------------------------------------------------------------
# waiver audit


def _comment_waivers(src: str, path: str) -> list:
    """``(line, kind, comment_text)`` for every ``# lint:`` comment.
    Tokenize-based: strings that merely *mention* a waiver (docstrings,
    the lint passes themselves) are not waivers."""
    out = []
    try:
        toks = tokenize.generate_tokens(io.StringIO(src).readline)
        for tok in toks:
            if tok.type != tokenize.COMMENT or "lint:" not in tok.string:
                continue
            tail = tok.string.split("lint:", 1)[1].strip()
            kind = tail.split()[0].rstrip(":,—-") if tail else ""
            out.append((tok.start[0], kind, tok.string))
    except (tokenize.TokenError, IndentationError, SyntaxError):
        pass
    return out


def waivers(sources: dict) -> list:
    """``(path, line, kind)`` for every ``# lint:`` comment of the
    sources (what the audit below checks)."""
    return [(path, line, kind) for path in sorted(sources)
            for line, kind, _text in _comment_waivers(sources[path], path)]


def _strip_comments(src: str, lines) -> str:
    out = src.splitlines(True)
    for line in lines:
        i = line - 1
        if 0 <= i < len(out):
            out[i] = out[i].split("#", 1)[0].rstrip() + "\n"
    return "".join(out)


def _waiver_audit(inp: Inputs) -> list:
    findings = []
    thread_used = threadlint.analyze(inp.sources).used_waivers
    for path in sorted(inp.sources):
        src = inp.sources[path]
        waivers = _comment_waivers(src, path)
        # A finding of Pass 3 depends on its own line's text alone, so
        # one relint with every jit waiver of the file stripped answers
        # for each waiver what relinting without it alone would.
        jit_lines = [ln for ln, kind, _t in waivers if kind == "jit-ok"]
        jit_live = {f.line for f in jitlint.lint_source(
            _strip_comments(src, jit_lines), path)} if jit_lines else set()
        for line, kind, _text in waivers:
            if kind not in WAIVER_KINDS:
                findings.append(Finding(
                    CONTRACT, ERROR, "waiver-unknown-kind",
                    f'unknown waiver kind "lint: {kind}" — known kinds '
                    f"are {', '.join(WAIVER_KINDS)}; a misspelled "
                    "waiver suppresses nothing while looking like it "
                    "does",
                    field=kind, file=path, line=line))
                continue
            if kind == "jit-ok":
                if line not in jit_live:
                    findings.append(Finding(
                        CONTRACT, ERROR, "stale-waiver",
                        "`# lint: jit-ok` no longer suppresses "
                        "anything — relinting without it produces no "
                        "finding on this line; remove the waiver",
                        field=kind, file=path, line=line))
            elif kind == "thread-ok":
                if (path, line) not in thread_used:
                    findings.append(Finding(
                        CONTRACT, ERROR, "stale-waiver",
                        "`# lint: thread-ok` no longer suppresses "
                        "anything — the race detector has no finding "
                        "on this line; remove the waiver",
                        field=kind, file=path, line=line))
    return findings


# --------------------------------------------------------------------------
# entry points


def lint_inputs(inp: Inputs) -> list:
    # The lint passes themselves are out of scope for the gate and obs
    # contracts: they *talk about* gates and events (docstring examples,
    # finding codes through their own `_emit` helpers) without producing
    # either.  The waiver audit still covers them.
    scan = Inputs(
        sources={p: s for p, s in inp.sources.items()
                 if not p.startswith("raft_tla_tpu_torch/analysis/")},
        readme=inp.readme, lint_sh=inp.lint_sh,
        schema_path=inp.schema_path, digest_path=inp.digest_path)
    trees = {}
    for path in sorted(scan.sources):
        try:
            trees[path] = report.parse(scan.sources[path], path)
        except SyntaxError:
            continue                    # pass 3 reports parse errors
    findings = _gate_contract(scan, trees)
    findings += _obs_contract(scan, trees)
    findings += _waiver_audit(inp)
    return findings


def lint_paths(root: str | None = None) -> list:
    if root is None:
        root = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))

    def _read(rel: str) -> str:
        p = os.path.join(root, rel)
        if not os.path.exists(p):
            return ""
        with open(p, "r", encoding="utf-8") as fh:
            return fh.read()

    smoke = [rel for pat in SMOKE_PATHS
             for rel in sorted(os.path.relpath(p, root) for p in
                               glob.glob(os.path.join(root, pat)))]
    return lint_inputs(Inputs(
        sources=threadlint.package_sources(root),
        readme=_read("README.md"),
        lint_sh="".join(_read(rel) for rel in smoke)))
