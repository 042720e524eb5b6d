"""Pass 2 — spec/config lint: TLCConfig diagnostics against the model; the
port's copy of ``raft_tla_tpu/analysis/cfglint.py``, run over the port's
own tables (``models/invariants.READS``, ``models/views``, the width
pass's transfer twins).

The classic TLC footgun this pass exists for: a typo'd ``INVARIANT``
name, or an invariant that nothing in the chosen spec subset can ever
falsify, silently checks *nothing* while the run prints OK.  Every
diagnostic here is a claim about the cfg/model pairing:

- **Unknown names** (error): INVARIANT / PROPERTY / SYMMETRY / VIEW
  entries that resolve against no registry, each with a did-you-mean
  (``utils.cfgparse.suggest``) and the offending cfg line.
- **Mode mismatches** (error): history invariants under parity bounds
  (their READS fields do not exist in the parity layout), VIEW vs
  faithful fingerprints.
- **Constant bindings inconsistent with Bounds** (error/warning):
  Server/Value sets out of the supported ranges, bound-constants
  (MaxTerm &c.) that contradict the Bounds in force.
- **Vacuous invariants** (warning): the invariant holds on Init and
  reads only fields no transition in the active spec subset writes
  (``ops/kernels.TRANSFER_WRITES``) — statically true, checking nothing.
- **Symmetry/view compatibility** (error/warning): SYMMETRY on an axis
  the view is not equivariant to (orbit-dependent fingerprints: unsound
  dedup), and invariants reading fields the view rewrites (checked only
  up to the view).
"""

from __future__ import annotations

from raft_tla_tpu_torch.analysis.report import CFG, ERROR, WARNING, Finding
from raft_tla_tpu_torch.config import Bounds, _MAX_SERVERS, _MAX_VALUES
from raft_tla_tpu_torch.utils import cfgparse

_SYM_NAMES = ("Server", "SymServer", "Value", "SymValue", "SymServerValue")
# The built-in parity view: history-stripping only; equivariant to every
# permutation axis and rewrites no parity-layout field.
_BUILTIN_VIEWS = ("ParityView",)

# cfg constant name -> Bounds attribute, for binding-consistency checks.
_BOUND_CONSTANTS = {
    "MaxTerm": "max_term",
    "MaxLog": "max_log",
    "MaxMsgs": "max_msgs",
    "MaxDup": "max_dup",
    "MaxElections": "max_elections",
}


def _unknown(kind, names, known, cfg, path) -> list:
    findings = []
    for name, hints in cfgparse.unknown_names(names, known):
        hint = f"; did you mean: {', '.join(hints)}?" if hints else ""
        findings.append(Finding(
            CFG, ERROR, f"unknown-{kind}",
            f"unknown {kind} {name!r} (known: {', '.join(sorted(known))})"
            f"{hint}", field=name, file=path,
            line=cfg.line_of(kind, name)))
    return findings


def lint_cfg(cfg: cfgparse.TLCConfig, bounds: Bounds, *,
             spec: str = "full", view: str | None = None,
             path: str | None = None) -> list:
    """Run every Pass 2 diagnostic for one parsed cfg + Bounds pairing.

    ``view`` is the CLI-selected state view (views.REGISTRY name), if
    any; the cfg's own VIEW stanza is validated separately (it can only
    name the built-in ParityView).
    """
    from raft_tla_tpu_torch.models import invariants as inv_mod
    from raft_tla_tpu_torch.models import liveness as live_mod
    from raft_tla_tpu_torch.models import spec as SP
    from raft_tla_tpu_torch.models import views as views_mod

    findings = []

    # -- unknown names --------------------------------------------------------
    # Whole-line predicate EXPRESSIONS (frontend grammar) are not registry
    # names: parse-check them instead of spell-checking them.
    from raft_tla_tpu_torch.utils.cfgparse import is_expression
    inv_names = [nm for nm in cfg.invariants if not is_expression(nm)]
    inv_exprs = [nm for nm in cfg.invariants if is_expression(nm)]
    findings += _unknown("invariant", inv_names, inv_mod.REGISTRY,
                         cfg, path)
    for text in inv_exprs:
        try:
            inv_mod._expression(text)
        except ValueError as e:
            findings.append(Finding(
                CFG, ERROR, "invariant-parse-error",
                f"invariant expression {text!r} does not parse: {e}",
                field=text, file=path,
                line=cfg.line_of("invariant", text)))
    for text in cfg.properties:
        try:
            live_mod.parse_property(text)
        except ValueError as e:
            findings.append(Finding(
                CFG, ERROR, "unknown-property", str(e), field=text,
                file=path, line=cfg.line_of("property", text)))
    findings += _unknown("symmetry", cfg.symmetry, _SYM_NAMES, cfg, path)
    if cfg.view is not None:
        findings += _unknown(
            "view", [cfg.view],
            set(_BUILTIN_VIEWS) | set(views_mod.REGISTRY), cfg, path)

    # -- constant bindings vs Bounds ------------------------------------------
    for axis, cap, n in (("Server", _MAX_SERVERS, bounds.n_servers),
                         ("Value", _MAX_VALUES, bounds.n_values)):
        names = cfg.constants.get(axis)
        if names is None:
            findings.append(Finding(
                CFG, ERROR, "constant-missing",
                f"cfg does not bind {axis} to a finite set (the model "
                "takes its cardinality from this binding)", field=axis,
                file=path))
            continue
        if not isinstance(names, list):
            findings.append(Finding(
                CFG, ERROR, "constant-not-set",
                f"{axis} must be bound to a finite set, got {names!r}",
                field=axis, file=path,
                line=cfg.line_of("constant", axis)))
            continue
        if not 1 <= len(names) <= cap:
            findings.append(Finding(
                CFG, ERROR, "constant-out-of-range",
                f"{axis} has {len(names)} elements; the packed encodings "
                f"support 1..{cap}", field=axis, file=path,
                line=cfg.line_of("constant", axis)))
        if len(names) != n:
            findings.append(Finding(
                CFG, ERROR, "constant-bounds-mismatch",
                f"cfg binds {len(names)} {axis} elements but Bounds has "
                f"{n} — the cfg and the bounds in force disagree",
                field=axis, file=path, line=cfg.line_of("constant", axis)))
    for cname, attr in _BOUND_CONSTANTS.items():
        bound_val = cfg.constants.get(cname)
        if bound_val is None or isinstance(bound_val, list):
            continue
        try:
            bound_int = int(bound_val)
        except ValueError:
            continue                      # model value, not a bound
        have = getattr(bounds, attr)
        if bound_int != have:
            findings.append(Finding(
                CFG, WARNING, "constant-bounds-mismatch",
                f"cfg binds {cname} = {bound_int} but the bounds in force "
                f"use {attr} = {have} (cfg bound constants are "
                "informational; --max-* flags win)", field=cname,
                file=path, line=cfg.line_of("constant", cname)))

    # -- mode mismatches ------------------------------------------------------
    for name in cfg.invariants:
        if name in inv_mod.HISTORY_REGISTRY and not bounds.history:
            findings.append(Finding(
                CFG, ERROR, "invariant-needs-history",
                f"invariant {name} reads history variables "
                f"({', '.join(inv_mod.READS[name])}) that the parity "
                "layout does not carry; run with --faithful", field=name,
                file=path, line=cfg.line_of("invariant", name)))
    if bounds.history and cfg.view is not None:
        findings.append(Finding(
            CFG, ERROR, "view-vs-faithful",
            f"VIEW {cfg.view} contradicts faithful mode: faithful "
            "fingerprints full states (no view)", field=cfg.view,
            file=path, line=cfg.line_of("view", cfg.view)))

    # -- vacuous invariants ---------------------------------------------------
    findings += _vacuity(cfg, bounds, spec, path)

    # -- symmetry / view compatibility ----------------------------------------
    axes = set()
    for s in cfg.symmetry:
        if s == "SymServerValue":
            axes |= {"Server", "Value"}
        elif s in _SYM_NAMES:
            axes.add(s.removeprefix("Sym"))
    if view is not None and view in views_mod.REGISTRY:
        equivariant = set(views_mod.EQUIVARIANT_AXES.get(view, ()))
        for ax in sorted(axes - equivariant):
            findings.append(Finding(
                CFG, ERROR, "view-symmetry-incompatible",
                f"SYMMETRY {ax} with view {view!r}: the view is not "
                f"declared equivariant to {ax} permutations, so "
                "view-fingerprints would be orbit-dependent (unsound "
                "dedup)", field=view, file=path))
        written = set(views_mod.VIEW_WRITES.get(view, ()))
        for name in cfg.invariants:
            reads = set(inv_mod.READS.get(name, ()))
            hit = sorted(reads & written)
            if hit:
                findings.append(Finding(
                    CFG, WARNING, "invariant-under-view",
                    f"invariant {name} reads {', '.join(hit)} which view "
                    f"{view!r} rewrites before fingerprinting: it is "
                    "checked only up to the view", field=name, file=path,
                    line=cfg.line_of("invariant", name)))
    return findings


def _vacuity(cfg, bounds, spec, path) -> list:
    """An invariant is vacuous when (a) its predicate holds on Init and
    (b) it reads only fields no transition in the active spec subset
    writes — then no reachable state can falsify it and the run checks
    nothing.  The write-sets are the *reachability-refined* ones from the
    Pass 1 transfer twins (with the spec-restricted message envelope):
    in the election subset, Receive never carries an AppendEntries
    record, so it never writes the log — the static
    ``kernels.TRANSFER_WRITES`` superset would miss that vacuity.  Plus
    one host evaluation on the unique Init state."""
    from raft_tla_tpu_torch.analysis import intervals as iv
    from raft_tla_tpu_torch.analysis import widthcheck as wc
    from raft_tla_tpu_torch.models import interp
    from raft_tla_tpu_torch.models import invariants as inv_mod
    from raft_tla_tpu_torch.models import spec as SP
    from raft_tla_tpu_torch.ops import kernels

    findings = []
    try:
        fams = {a.family for a in SP.action_table(bounds, spec)}
    except (KeyError, ValueError):
        return findings                   # bad spec name, reported upstream
    written = set(kernels.POSTLUDE_WRITES) if bounds.history else set()
    env = iv.expansion_envelope(bounds)
    active = {f: wc.TRANSFERS[f] for f in fams if f in wc.TRANSFERS}
    menv = wc.message_envelope(bounds, env, active)
    for t in active.values():
        written |= set(t(bounds, env, menv).writes)
    from raft_tla_tpu_torch.utils.cfgparse import is_expression
    init = interp.init_state(bounds)
    for name in cfg.invariants:
        if name in inv_mod.REGISTRY:
            if name not in inv_mod.READS:
                continue
            if name in inv_mod.HISTORY_REGISTRY and not bounds.history:
                continue                  # already an error above
            reads = set(inv_mod.READS[name])
        elif is_expression(name):
            # compiled expressions carry their own read-set
            try:
                reads = set(inv_mod._expression(name).reads)
            except ValueError:
                continue                  # parse error, reported upstream
        else:
            continue                      # unknown name, reported upstream
        if reads & written:
            continue
        try:
            holds = inv_mod.py_invariant(name)(init, bounds)
        except Exception:
            continue
        if holds:
            findings.append(Finding(
                CFG, WARNING, "invariant-vacuous",
                f"invariant {name} reads only "
                f"{', '.join(sorted(reads))}, which no transition of "
                f"spec {spec!r} writes, and it holds on Init — it is "
                "statically true and checks nothing", field=name,
                file=path, line=cfg.line_of("invariant", name)))
    return findings
