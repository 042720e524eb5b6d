"""speclint CLI — run the five analysis passes over a model config and
the port's own tree (the port of ``raft_tla_tpu/analysis/__main__.py``).

::

    python -m raft_tla_tpu_torch.lint runs/MC3s2v.cfg           # both modes
    python -m raft_tla_tpu_torch.lint runs/MC3s2v.cfg --strict  # warnings fail
    python -m raft_tla_tpu_torch.lint --mode faithful --spec election cfg
    python -m raft_tla_tpu_torch.lint              # no cfg: passes 1+3+4+5

(``python -m raft_tla_tpu_torch.analysis`` is the same program.)

Passes 1 and 2 run per mode on the cfg's bounds (:mod:`.widthcheck`,
:mod:`.cfglint`); passes 3-5 (:mod:`.jitlint`, :mod:`.threadlint`,
:mod:`.contracts`) run once over ``raft_tla_tpu_torch/``.  The width
pass goes through the spec's model adapter (``frontend/registry``), as
``check.py --lint`` does: a Raft spec's width proof, or a schema spec's
validity check.  A non-Raft spec (``twophase``) maps its cfg itself, as
admission does (``serve/jobs.admit``), and has no faithful mode, so
``--mode`` does not apply to it.

Exit code: 0 when every pass proves its property (warnings allowed),
1 on any error finding — or on any finding at all under ``--strict``.
"""

from __future__ import annotations

import argparse
import sys

from raft_tla_tpu_torch.analysis import report
from raft_tla_tpu_torch.analysis.report import Finding


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="raft-tla-lint-torch",
        description="static width-safety and spec-consistency analyzer: "
                    "proves the packed encodings cannot silently truncate "
                    "(Pass 1), lints the cfg against the model registries "
                    "(Pass 2), flags host syncs and narrowing casts in the "
                    "port's sources (Pass 3), detects unguarded "
                    "shared state across thread entry points (Pass 4), "
                    "and cross-checks the gate/obs-schema/waiver "
                    "contracts (Pass 5)")
    p.add_argument("cfg", nargs="?", default=None,
                   help="TLC model config (.cfg); omit to run only the "
                        "width and jit passes on default bounds")
    p.add_argument("--mode", choices=("parity", "faithful", "both"),
                   default="both",
                   help="which encoding mode(s) to prove (default: both)")
    p.add_argument("--spec", default="full",
                   help="action-family subset, as in check.py (default: "
                        "full)")
    p.add_argument("--view", default=None,
                   help="CLI state view name (models/views registry) to "
                        "check symmetry/invariant compatibility against")
    p.add_argument("--strict", action="store_true",
                   help="exit 1 on warnings too")
    p.add_argument("--max-term", type=int, default=None, metavar="N")
    p.add_argument("--max-log", type=int, default=None, metavar="N")
    p.add_argument("--max-msgs", type=int, default=None, metavar="N")
    p.add_argument("--max-dup", type=int, default=None, metavar="N")
    p.add_argument("--skip", action="append", default=[],
                   choices=("width", "cfg", "jit", "thread", "contract"),
                   help="skip a pass (repeatable)")
    return p


def _bounds_for(args, cfg, history: bool):
    from raft_tla_tpu_torch.config import Bounds
    kw = {"history": history}
    if cfg is not None:
        kw["n_servers"] = len(cfg.server_names())
        kw["n_values"] = len(cfg.value_names())
    for flag in ("max_term", "max_log", "max_msgs", "max_dup"):
        v = getattr(args, flag)
        if v is not None:
            kw[flag] = v
    return Bounds(**kw)


def run_lint(args) -> tuple[list, int]:
    """All requested passes; returns (findings, exit_code)."""
    from raft_tla_tpu_torch.analysis import contracts, jitlint, threadlint
    from raft_tla_tpu_torch.frontend.registry import resolve_model
    from raft_tla_tpu_torch.utils.cfgparse import load_cfg

    cfg = None
    if args.cfg is not None:
        try:
            cfg = load_cfg(args.cfg)
        except (OSError, ValueError) as e:
            f = Finding(report.CFG, report.ERROR, "cfg-unreadable", str(e),
                        file=args.cfg)
            return [f], 1
    try:
        model = resolve_model(args.spec)
    except ValueError as e:
        f = Finding(report.CFG, report.ERROR, "spec-unknown", str(e),
                    field=args.spec)
        return [f], 1

    findings = (_raft_lint(args, cfg, model) if model.is_raft
                else _schema_lint(args, cfg, model))
    if "jit" not in args.skip:
        findings += jitlint.lint_paths()
    if "thread" not in args.skip:
        findings += threadlint.lint_paths()
    if "contract" not in args.skip:
        findings += contracts.lint_paths()
    return findings, report.exit_code(findings, strict=args.strict)


def _raft_lint(args, cfg, model) -> list:
    """Passes 1-2 for a Raft spec, once per encoding mode."""
    from raft_tla_tpu_torch.analysis import cfglint
    modes = {"parity": (False,), "faithful": (True,),
             "both": (False, True)}[args.mode]
    findings: list = []
    for history in modes:
        tag = "faithful" if history else "parity"
        try:
            bounds = _bounds_for(args, cfg, history)
        except ValueError as e:
            findings.append(Finding(
                report.WIDTH, report.ERROR, "bounds-invalid",
                f"[{tag}] {e}", file=args.cfg))
            continue
        if "width" not in args.skip:
            for f in model.check_widths(bounds):
                findings.append(_tagged(f, tag))
        if cfg is not None and "cfg" not in args.skip:
            for f in cfglint.lint_cfg(cfg, bounds, spec=model.sub,
                                      view=args.view, path=args.cfg):
                findings.append(_tagged(f, tag))
    return findings


def _schema_lint(args, cfg, model) -> list:
    """Passes 1-2 for a non-Raft spec: the model maps the cfg (its errors
    are the cfg pass's findings) and its schema check is the width pass,
    on the cfg's bounds (else the default bounds and the flags)."""
    from raft_tla_tpu_torch.serve.jobs import JobOptions
    findings = []
    if cfg is None:
        try:
            bounds = _bounds_for(args, None, False)
        except ValueError as e:
            return [Finding(report.WIDTH, report.ERROR, "bounds-invalid",
                            f"[{model.name}] {e}")]
    else:
        try:
            config, _ = model.resolve_check_config(
                cfg, JobOptions(spec=args.spec, view=args.view),
                path=args.cfg)
        except ValueError as e:
            if "cfg" not in args.skip:
                findings.append(Finding(report.CFG, report.ERROR,
                                        "resolve-failed", str(e),
                                        file=args.cfg))
            return findings
        bounds = config.bounds
    if "width" not in args.skip:
        findings += [_tagged(f, model.name)
                     for f in model.check_widths(bounds)]
    return findings


def _tagged(f: Finding, tag: str) -> Finding:
    return Finding(f.pass_, f.severity, f.code, f"[{tag}] {f.message}",
                   transition=f.transition, field=f.field,
                   interval=f.interval, width=f.width, file=f.file,
                   line=f.line)


def main(argv=None) -> int:
    args = build_argparser().parse_args(argv)
    findings, code = run_lint(args)
    target = args.cfg or "(no cfg)"
    print(report.render(
        findings, header=f"speclint: {target} mode={args.mode} "
                         f"spec={args.spec}"))
    return code


if __name__ == "__main__":
    sys.exit(main())
