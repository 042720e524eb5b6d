"""Job model + admission — the part of ``raft_tla_tpu/serve/jobs.py``
the campaign supervisor needs (its admission gate).

A :class:`CheckJob` is one bounded check: a TLC model config (text or
path) plus the engine options the check CLI would take as flags,
normalised into :class:`JobOptions`.  :func:`admit` is the speclint gate:
parse, build :class:`Bounds`, run the width pass and the cfg lint
(analysis/widthcheck, analysis/cfglint), and reject width-unsafe or
vacuous configs *with the lint findings as the error payload* — all
before any step build, so a rejected job costs zero device time.
Resolution is the CLI's own (``check.resolve_check_config``) for a Raft
spec; a non-Raft spec (``twophase``) maps its cfg through its model
adapter (frontend/registry.py), whose schema check plays the width pass's
role.  The rest of ``serve/`` (the executor, scheduler, pool and daemon)
is ROADMAP.md queue A item 12.
"""

from __future__ import annotations

import dataclasses

from raft_tla_tpu_torch.analysis import report as _report
from raft_tla_tpu_torch.config import Bounds, CheckConfig
from raft_tla_tpu_torch.utils import cfgparse
from raft_tla_tpu_torch.utils.cfgparse import TLCConfig


@dataclasses.dataclass(frozen=True)
class JobOptions:
    """The engine-facing options of one check — the check.py flags that
    shape the compiled model, minus anything about *where* it runs.
    Field names match the CLI flags (``--max-term`` → ``max_term``)."""

    spec: str = "full"
    max_term: int = 3
    max_log: int = 2
    max_msgs: int = 4
    max_dup: int = 1
    faithful: bool = False
    max_elections: int = 6
    chunk: int = 1024
    symmetry: bool = False          # --symmetry: force the Server axis
    view: str | None = None         # --view: registered exact view
    deadlock: bool = False
    properties: tuple = ()          # --property additions (cfg's also read)
    wall_s: float | None = None     # per-job wall budget: the lane is
    #                                 stopped losslessly at the first
    #                                 level boundary past this many
    #                                 seconds (budget-exceeded record)


def resolve_check_config(cfg: TLCConfig, opts: JobOptions,
                         path: str | None = None):
    """cfg + options -> ``(CheckConfig, properties)``; raises ValueError
    (an unknown spec name with the registry's did-you-mean).  The one code
    path is the CLI's (``check.resolve_check_config`` and
    ``check.properties_of``); a non-Raft model maps the cfg itself."""
    from raft_tla_tpu_torch import check
    from raft_tla_tpu_torch.frontend.registry import resolve_model
    model = resolve_model(opts.spec)
    if not model.is_raft:
        return model.resolve_check_config(cfg, opts, path)
    config = check.resolve_check_config(
        cfg, spec=opts.spec, max_term=opts.max_term,
        max_log=opts.max_log, max_msgs=opts.max_msgs,
        max_dup=opts.max_dup, chunk=opts.chunk, deadlock=opts.deadlock,
        symmetry=opts.symmetry, view=opts.view, path=path,
        faithful=opts.faithful, max_elections=opts.max_elections)
    return config, check.properties_of(cfg, opts.properties)


# --------------------------------------------------------------------------
# jobs


# JobOptions fields a manifest/queue entry may set (everything except the
# tuple-typed properties, which JSON lists map onto).
_OPTION_KEYS = tuple(f.name for f in dataclasses.fields(JobOptions))


@dataclasses.dataclass(frozen=True)
class CheckJob:
    """One tenant's bounded check: identity + cfg + options.

    ``cfg_text`` wins over ``cfg_path`` when both are set (a queue entry
    may inline the config so the job file is self-contained).  The
    reference's content digest and ``to_dict`` serve the service and its
    pool (ROADMAP.md queue A item 12).
    """

    job_id: str
    options: JobOptions = JobOptions()
    cfg_path: str | None = None
    cfg_text: str | None = None

    def read_cfg_text(self) -> str:
        if self.cfg_text is not None:
            return self.cfg_text
        if self.cfg_path is None:
            raise ValueError(f"job {self.job_id!r} has neither cfg_text "
                             "nor cfg_path")
        with open(self.cfg_path, "r", encoding="utf-8") as f:
            return f.read()

    @classmethod
    def from_dict(cls, d: dict, job_id: str | None = None) -> "CheckJob":
        """Build from one manifest/queue JSON object.  Unknown keys are
        a hard error — a typo'd option silently running default bounds
        is the cfg-footgun all over again."""
        d = dict(d)
        jid = d.pop("id", None) or job_id
        if not jid:
            raise ValueError(f"job entry has no 'id': {sorted(d)}")
        cfg_path = d.pop("cfg", None)
        cfg_text = d.pop("cfg_text", None)
        props = d.pop("properties", ())
        unknown = set(d) - set(_OPTION_KEYS)
        if unknown:
            raise ValueError(
                f"job {jid!r}: unknown option(s) {sorted(unknown)} "
                f"(known: id, cfg, cfg_text, {', '.join(_OPTION_KEYS)})")
        opts = JobOptions(properties=tuple(props), **d)
        return cls(job_id=str(jid), options=opts,
                   cfg_path=cfg_path, cfg_text=cfg_text)


# --------------------------------------------------------------------------
# admission


@dataclasses.dataclass
class Admission:
    """The speclint verdict for one job, findings attached either way.

    ``admitted`` jobs carry the resolved ``config``/``properties`` the
    executor runs; rejected jobs carry ``reason`` (stable kebab-case)
    and the findings that justify it — the error payload the service
    returns to the tenant.
    """

    job: CheckJob
    admitted: bool
    findings: list                       # analysis/report.Finding
    config: CheckConfig | None = None
    properties: tuple = ()
    reason: str | None = None

    def findings_text(self) -> list:
        return [f.format() for f in self.findings]


def admit(job: CheckJob) -> Admission:
    """Gate one job through speclint — host-only, zero device time.

    Reject paths, in order: unreadable/unparseable cfg; Bounds the
    packed encodings cannot represent (width-unsafe by construction);
    Pass 1 width-proof failures; Pass 2 cfg-lint errors (unknown names,
    mode mismatches, constant/bounds conflicts); *vacuous invariants*
    (a warning for the CLI, but a service must not bill device time for
    a check that statically checks nothing); and any residual
    resolve-time error.  The returned findings are the error payload.
    """
    from raft_tla_tpu_torch.analysis import cfglint, widthcheck
    from raft_tla_tpu_torch.frontend.registry import resolve_model

    opts = job.options
    # Budget first: a zero/negative/non-numeric wall_s is a client error
    # the lint gate must name, never a traceback out of the queue worker
    # (and never a job the executor starts only to stop at once).
    w = opts.wall_s
    if w is not None and (type(w) not in (int, float) or w <= 0):
        f = _report.Finding(
            _report.CFG, _report.ERROR, "budget-invalid",
            f"wall_s must be a positive number of seconds, got {w!r}",
            field="wall_s")
        return Admission(job, False, [f], reason="budget-invalid")
    # Spec name next: an unknown spec must be a lint-style finding, not
    # a traceback out of the queue worker.
    try:
        model = resolve_model(opts.spec)
    except ValueError as e:
        f = _report.Finding(_report.CFG, _report.ERROR, "spec-unknown",
                            str(e), field=opts.spec)
        return Admission(job, False, [f], reason="spec-unknown")

    try:
        cfg = cfgparse.parse_cfg(job.read_cfg_text())
    except (OSError, ValueError) as e:
        f = _report.Finding(_report.CFG, _report.ERROR, "cfg-unreadable",
                            str(e), file=job.cfg_path)
        return Admission(job, False, [f], reason="cfg-unreadable")

    if not model.is_raft:
        # Non-Raft admission: the model maps the cfg itself, then its
        # schema validity gate plays the width-proof role.
        try:
            config, props = model.resolve_check_config(
                cfg, opts, path=job.cfg_path)
        except ValueError as e:
            f = _report.Finding(_report.CFG, _report.ERROR,
                                "resolve-failed", str(e), file=job.cfg_path)
            return Admission(job, False, [f], reason="cfg-invalid")
        findings = list(model.check_widths(config.bounds))
        if _report.has_errors(findings):
            return Admission(job, False, findings, reason="width-unsafe")
        return Admission(job, True, findings, config=config,
                         properties=props)

    sub = model.sub
    try:
        bounds = Bounds(
            n_servers=len(cfg.server_names()),
            n_values=len(cfg.value_names()),
            max_term=opts.max_term, max_log=opts.max_log,
            max_msgs=opts.max_msgs, max_dup=opts.max_dup,
            history=opts.faithful, max_elections=opts.max_elections)
    except ValueError as e:
        # The encodings cannot even represent these bounds: width-unsafe
        # by construction (same lift analysis/__main__ applies).
        f = _report.Finding(_report.WIDTH, _report.ERROR, "bounds-invalid",
                            str(e), file=job.cfg_path)
        findings = [f] + cfglint.lint_cfg(
            cfg, Bounds(), spec=sub, view=opts.view,
            path=job.cfg_path)
        return Admission(job, False, findings, reason="width-unsafe")

    findings = list(widthcheck.check_widths(bounds, sub))
    if _report.has_errors(findings):
        return Admission(job, False, findings, reason="width-unsafe")

    findings += cfglint.lint_cfg(cfg, bounds, spec=sub,
                                 view=opts.view, path=job.cfg_path)
    if _report.has_errors(findings):
        return Admission(job, False, findings, reason="cfg-invalid")
    vacuous = [f for f in findings if f.code == "invariant-vacuous"]
    if vacuous:
        return Admission(job, False, findings, reason="vacuous")

    try:
        config, props = resolve_check_config(cfg, opts, path=job.cfg_path)
    except ValueError as e:
        findings.append(_report.Finding(
            _report.CFG, _report.ERROR, "resolve-failed", str(e),
            file=job.cfg_path))
        return Admission(job, False, findings, reason="cfg-invalid")
    return Admission(job, True, findings, config=config, properties=props)
