"""The checker CLI — the port of ``raft_tla_tpu/check.py``,
``python -m raft_tla_tpu_torch.check CFG``.

A stock TLC model config in (the universe ``Server``/``Value`` and the
``INVARIANT`` stanza); the state constraint from the ``--max-*`` flags; the
engine runs the search on the card (``--device cuda``, the default) or on
the CPU (``--device cpu``).  The result lines and exit codes are the
reference's: 0 no error, 11 deadlock, 12 invariant violation, 13 liveness
violation, 14 stopped before completion (``--deadline`` or SIGINT), 1
error.

Before any build the width pass (analysis/widthcheck) proves that no
transition can overflow a packed field for these bounds: ``--lint warn``
(the default) prints its findings on stderr and runs on, ``--lint strict``
makes any finding fatal, ``--no-lint`` skips it.

``--property NAME_OR_FORMULA`` (and the cfg's PROPERTY stanza) checks a
temporal property under the weak fairness of ``--wf`` after an exhaustive
search without error (models/liveness.py): ``host`` and ``ref`` without a
VIEW build the graph with the interpreter; SYMMETRY, a VIEW or ``--engine
ddd`` build it from the DDD engine's store; otherwise the device engine's.

Four engines: ``--engine device`` (the default: the whole search in the
card's memory), ``--engine ddd`` (exact dedup on the host, the card expands
and filters; ``--block``, ``--retention``, ``--keep-levels``,
``--deadline``, ``--host-dedup``, ``--prefetch``; other engines ignore
them, as the reference's do), ``--engine host`` (the step per chunk on the
card, a fingerprint set on the host) and ``--engine ref`` (the
pure-Python oracle).  ``--stats`` (one progress line per segment),
``--checkpoint``/``--resume`` and the run-event log (``--events PATH``,
with ``--phase-timers`` and ``--trace``; obs/) need ``device`` or
``ddd``.  ``--emit-tlc DIR`` writes the run's TLC twin, then runs it.

``--spec twophase`` checks the second bundled protocol, two-phase commit
compiled from the action IR (frontend/twophase.py; the cfg binds ``CONSTANT
RM``): ``--engine host`` (the schema step on the card, its rows keyed by
K2) and ``--simulate``/``--fleet``; any other engine is refused with exit 2.

``--simulate N`` samples N random behaviors instead (TLC's ``-simulate``;
``--depth``, ``--walkers``, ``--seed``; simulate.py, one fused-step launch
a walker step), and ``--fleet`` runs the walker fleet (``--steer``,
``--fault-weights``; fleet/), on one card: exit 0, 11 or 12 with a trace
that replays exactly, never a claim of exhaustion.

This port supports them in parity and faithful mode (``--faithful``: the
history variables carried as state, with the ``*Hist`` invariants), with
SYMMETRY on the Server and Value axes (``--symmetry`` or the cfg stanza),
the registered VIEWs (``--view``), registry invariants and whole-line
predicate expressions in the INVARIANT stanza, and the PROPERTY stanza.
The reference's other flags and stanzas are refused with the ROADMAP.md
item that will bring them.
"""

from __future__ import annotations

import argparse
import sys
import time

EXIT_OK = 0
EXIT_DEADLOCK = 11       # TLC's exit code for deadlock
EXIT_VIOLATION = 12      # TLC's exit code for safety-property violations
EXIT_LIVENESS = 13       # TLC's exit code for liveness-property violations
EXIT_STOPPED = 14        # a lossless stop short of exhaustion
EXIT_ERROR = 1

# Reference flags that this slice refuses, each with its refusal: the
# ROADMAP.md queue item, or the spelling here.
_LATER = "is not ported to raft_tla_tpu_torch yet (ROADMAP.md queue A: {})"
_GATED = _LATER.format("item 7, gated variants")
_PARALLEL = _LATER.format("item 11, parallel engines")
_NOT_PORTED = {
    "--route": _GATED, "--device-dedup": _GATED, "--devdedup": _GATED,
    "--prescan": _GATED, "--sig-prune": _GATED, "--megakernel": _GATED,
    "--ring": _LATER.format("item 9, the paged and streamed engines"),
    "--reshard-to": _PARALLEL, "--reshard-cap": _PARALLEL,
    "--devices": _PARALLEL, "--seg-chunks": _PARALLEL,
    "--cp-lanes": _PARALLEL, "--slices": _PARALLEL,
    "--compile-cache": _LATER.format(
        "item 12, serving (the warm-start cache)"),
    "--cpu": "is spelled --device cpu in raft_tla_tpu_torch",
}
ENGINES = ("device", "ddd", "host", "ref")
_DEVICE_ENGINES = ("device", "ddd")    # the reference's device-class engines


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m raft_tla_tpu_torch.check",
        description="GPU exhaustive checker for the Raft TLA+ spec "
                    "(PyTorch/CUDA port of raft_tla_tpu)")
    p.add_argument("cfg", help="TLC model config; binds Server/Value/"
                               "INVARIANT")
    p.add_argument("--spec", default="full",
                   choices=("full", "election", "replication", "twophase"),
                   help="loaded spec: a Raft Next-disjunct subset (default: "
                        "full raft.tla:454-465) or the bundled twophase "
                        "(two-phase commit, frontend-compiled; --engine "
                        "host; cfg binds CONSTANT RM)")
    p.add_argument("--engine", default="device",
                   help="device (the reference's default: the search in "
                        "the card's memory), ddd (delayed duplicate "
                        "detection: exact dedup on the host, the card "
                        "expands and filters), host (the step per chunk "
                        "on the card, dedup in a host set) or ref (the "
                        "pure-Python oracle)")
    p.add_argument("--max-term", type=int, default=3,
                   help="CONSTRAINT: currentTerm[i] <= N (default 3)")
    p.add_argument("--max-log", type=int, default=2,
                   help="CONSTRAINT: Len(log[i]) <= N (default 2)")
    p.add_argument("--max-msgs", type=int, default=4,
                   help="CONSTRAINT: Cardinality(DOMAIN messages) <= N")
    p.add_argument("--max-dup", type=int, default=1,
                   help="CONSTRAINT: messages[m] <= N")
    p.add_argument("--deadlock", action="store_true",
                   help="check for deadlocks (exit code 11 on one)")
    p.add_argument("--faithful", action="store_true",
                   help="carry the proof-only history variables (elections/"
                        "allLogs/voterLog/mlog, raft.tla:39,44,77) as real "
                        "fingerprinted state, as stock TLC does on the "
                        "unmodified spec; enables the *Hist invariants "
                        "(default: parity mode, history stripped)")
    p.add_argument("--max-elections", type=int, default=6,
                   help="elections-history slot capacity (--faithful only); "
                        "exceeding it aborts loudly")
    p.add_argument("--chunk", type=int, default=1024,
                   help="frontier states expanded per step")
    p.add_argument("--cap", type=int, default=1 << 20,
                   help="distinct-state capacity (store rows)")
    p.add_argument("--levels", type=int, default=256, help="max BFS depth")
    p.add_argument("--block", type=int, default=None, metavar="ROWS",
                   help="--engine ddd: frontier rows uploaded per block "
                        "(default 2^20; must match the run when resuming)")
    p.add_argument("--retention", default="full",
                   choices=("full", "frontier"),
                   help="--engine ddd: 'frontier' keeps the master keys in "
                        "RAM and only the current and next BFS level of "
                        "rows, in disk-backed level files, with no trace "
                        "links (a violation reports the state)")
    p.add_argument("--keep-levels", action="store_true",
                   help="--retention frontier: keep every level file, so "
                        "a violation rebuilds its full trace by backward "
                        "re-search")
    p.add_argument("--deadline", type=float, default=None,
                   metavar="SECONDS",
                   help="--engine ddd: stop losslessly at the first segment "
                        "boundary past this wall budget (exit 14, snapshot "
                        "saved with --checkpoint)")
    p.add_argument("--stats", action="store_true",
                   help="one JSON line of run stats per search segment on "
                        "stderr (device and ddd engines; ddd: per host "
                        "flush and level end)")
    p.add_argument("--host-dedup", default=None,
                   choices=("auto", "on", "off"),
                   help="--engine ddd: partitioned master keys and a "
                        "background flush thread (sets RAFT_TLA_HOSTDEDUP; "
                        "auto = on iff the host has 2+ cores)")
    p.add_argument("--prefetch", default=None,
                   choices=("auto", "on", "off"),
                   help="--engine ddd: read and upload block k+1 while "
                        "block k expands (sets RAFT_TLA_PREFETCH; auto = on "
                        "iff the host has 2+ cores)")
    p.add_argument("--checkpoint", metavar="PATH",
                   help="write the search carry (device) or a DDD snapshot "
                        "here (the reference's formats)")
    p.add_argument("--checkpoint-every", type=float, default=120.0,
                   help="seconds between checkpoints")
    p.add_argument("--resume", metavar="PATH",
                   help="resume from a checkpoint of either package")
    p.add_argument("--coverage", action="store_true",
                   help="print per-action-family new-state counts")
    p.add_argument("--no-trace", action="store_true",
                   help="print only the verdict line of a violation")
    p.add_argument("--symmetry", action="store_true",
                   help="quotient the state space by Server permutation "
                        "symmetry (TLC SYMMETRY analog; also enabled by a "
                        "cfg SYMMETRY stanza)")
    from raft_tla_tpu_torch.models.views import REGISTRY as view_registry
    p.add_argument("--view", default=None,
                   choices=tuple(sorted(view_registry)),
                   help="TLC VIEW analog: fold a registered exact view into "
                        "every dedup key (deadvotes: zero votesResponded/"
                        "votesGranted of non-Candidates)")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="where the search runs (default: cuda)")
    p.add_argument("--emit-tlc", metavar="DIR",
                   help="also write MCraft.tla/MCraft.cfg for a stock-TLC "
                        "parity run, then continue")
    p.add_argument("--property", action="append", default=[],
                   metavar="NAME_OR_FORMULA",
                   help="temporal property to check under weak fairness: "
                        "a registered name (models/liveness.PROPERTIES) "
                        "or a formula '<>P', '[]<>P', 'P ~> Q' over "
                        "registered predicates (models/liveness."
                        "PREDICATES). Also read from the cfg's PROPERTY "
                        "stanza")
    p.add_argument("--wf", default="Next",
                   help="comma-separated action families assumed weakly "
                        "fair for --property (default: Next = the whole "
                        "relation; 'none' = no fairness, the reference "
                        "spec's actual Spec, raft.tla:469)")
    p.add_argument("--lint", default="warn", choices=("warn", "strict"),
                   help="static width-safety pass (analysis/widthcheck) "
                        "before any step build: prove no transition can "
                        "overflow a packed field for these bounds. 'warn' "
                        "(default) prints findings and proceeds; 'strict' "
                        "makes any finding fatal")
    p.add_argument("--no-lint", action="store_true",
                   help="skip the static width-safety pass")
    p.add_argument("--events", metavar="PATH",
                   help="append the versioned JSONL run-event log "
                        "(run_start/segment/level_end/checkpoint/"
                        "violation/run_end — obs/events.py) to PATH. Sets "
                        "RAFT_TLA_EVENTS process-wide so liveness "
                        "re-runs inherit the same log")
    p.add_argument("--trace", action="store_true",
                   help="emit schema-v8 span events (trace spans with "
                        "nesting and thread attribution) into the "
                        "--events log; merge and export with "
                        "python -m raft_tla_tpu_torch.obs.tracecli. Unlike "
                        "--phase-timers this adds no device waits — spans "
                        "record host-side dispatch walls. Distinct from "
                        "--no-trace, which suppresses counterexample "
                        "trace RENDERING. Also RAFT_TLA_TRACE=1")
    p.add_argument("--phase-timers", action="store_true",
                   help="attribute wall time to search phases (upload/"
                        "expand/export/dedup/snapshot, plus dedup_submit/"
                        "dedup_wait when background host dedup is on) in "
                        "each segment event, at the cost of a device wait "
                        "per phase — the ddd engine loses its two-deep "
                        "overlap while this is on. Also RAFT_TLA_"
                        "PHASE_TIMERS=1")
    p.add_argument("--simulate", type=int, metavar="N", default=None,
                   help="TLC -simulate analog: instead of exhaustive "
                        "search, sample N random behaviors (batched "
                        "walkers on the card, one fused-step launch a "
                        "walker step), invariants checked on every "
                        "generated state")
    p.add_argument("--depth", type=int, default=100,
                   help="--simulate: maximum behavior length (TLC's "
                        "-depth; default 100)")
    p.add_argument("--walkers", type=int, default=1024,
                   help="--simulate: parallel walkers per device step "
                        "(with --fleet: the fleet size)")
    p.add_argument("--seed", type=int, default=0,
                   help="--simulate: PRNG seed (same seed = same walks, "
                        "on the card and on the CPU)")
    p.add_argument("--fleet", action="store_true",
                   help="--simulate: run the walker fleet (coverage "
                        "steering, scenario weights, a confidence report; "
                        "one card)")
    p.add_argument("--steer", type=float, default=0.0, metavar="TAU",
                   help="--fleet: coverage-steering temperature — bias "
                        "lane sampling against over-visited actions by "
                        "TAU * log1p(visits/mean) (default 0 = off; "
                        "exact replay preserved)")
    p.add_argument("--fault-weights", default=None, metavar="F=W,...",
                   help="--fleet: per-action-family sampling weights, "
                        "e.g. 'Restart=2,DropMessage=0.5' (sampling "
                        "policy only; enabledness untouched)")
    for flag in _NOT_PORTED:
        p.add_argument(flag, nargs="?", const=True, default=None,
                       help=argparse.SUPPRESS)
    return p


def resolve_check_config(cfg, spec: str = "full", max_term: int = 3,
                         max_log: int = 2, max_msgs: int = 4,
                         max_dup: int = 1, chunk: int = 1024,
                         deadlock: bool = False, symmetry: bool = False,
                         view: str | None = None, path: str | None = None,
                         faithful: bool = False, max_elections: int = 6):
    """cfg -> ``CheckConfig``: the Raft branch of the reference's
    ``serve/jobs.resolve_check_config``.  ``symmetry`` is the
    ``--symmetry`` flag (Server), ``view`` the ``--view`` flag,
    ``faithful``/``max_elections`` the ``--faithful``/``--max-elections``
    flags.  Raises ValueError on a bad cfg (a PROPERTY that does not parse
    included)."""
    from raft_tla_tpu_torch.config import Bounds, CheckConfig
    from raft_tla_tpu_torch.models import invariants as inv_mod
    from raft_tla_tpu_torch.models import liveness
    from raft_tla_tpu_torch.utils import cfgparse

    if cfg.specification not in (None, "Spec"):
        raise ValueError(
            f"unsupported SPECIFICATION {cfg.specification!r}: the compiled "
            "model implements Spec == Init /\\ [][Next]_vars (raft.tla:469)")
    if cfg.init not in (None, "Init") or cfg.next not in (None, "Next"):
        raise ValueError(
            f"unsupported INIT/NEXT ({cfg.init!r}/{cfg.next!r}): only the "
            "spec's Init and Next are compiled")
    # Whole-line predicate expressions bypass the registry and must parse
    # against the Raft state schema instead.
    named = [nm for nm in cfg.invariants if not cfgparse.is_expression(nm)]
    cfgparse.resolve_names(named, inv_mod.REGISTRY, "invariant",
                           cfg=cfg, path=path)
    for nm in cfg.invariants:
        if not cfgparse.is_expression(nm):
            continue
        try:
            inv_mod._expression(nm)
        except ValueError as e:
            lineno = cfg.line_of("invariant", nm)
            where = f"{path or 'cfg'} line {lineno}: " if lineno else ""
            raise ValueError(
                f"{where}invariant expression {nm!r} does not parse: {e}")
    for nm in cfg.properties:
        liveness.parse_property(nm)     # raises with both registries
    sym_names = set(cfg.symmetry) | ({"Server"} if symmetry else set())
    bad_sym = sym_names - {"Server", "SymServer", "Value", "SymValue",
                           "SymServerValue"}
    if bad_sym:
        raise ValueError(
            f"SYMMETRY {sorted(bad_sym)} not supported: Server and/or "
            "Value permutation symmetry (name them Server/SymServer, "
            "Value/SymValue, or the combined SymServerValue)")
    axes = tuple(ax for ax in ("Server", "Value")
                 if {ax, f"Sym{ax}"} & sym_names
                 or "SymServerValue" in sym_names)
    if [c for c in cfg.constraints if c != "StateConstraint"]:
        raise ValueError(
            f"CONSTRAINT {cfg.constraints} not supported: the state "
            "constraint is the built-in bound, set via --max-* flags")
    if faithful:
        # Faithful mode fingerprints full states; a cfg that declares the
        # history-stripping view would contradict it.
        if cfg.view is not None:
            raise ValueError(
                f"VIEW {cfg.view} contradicts --faithful: faithful mode "
                "fingerprints full states (no view); re-emit the TLC twin "
                "with --faithful --emit-tlc")
    elif cfg.view not in (None, "ParityView"):
        raise ValueError(
            f"VIEW {cfg.view} not supported: parity mode fingerprints "
            "under the built-in history-free ParityView")
    bounds = Bounds(n_servers=len(cfg.server_names()),
                    n_values=len(cfg.value_names()),
                    max_term=max_term, max_log=max_log,
                    max_msgs=max_msgs, max_dup=max_dup,
                    history=faithful, max_elections=max_elections)
    return CheckConfig(bounds=bounds, spec=spec,
                       invariants=tuple(cfg.invariants), symmetry=axes,
                       chunk=chunk, check_deadlock=deadlock, view=view)


def verdict_code(result) -> int:
    """The TLC exit code of a finished check."""
    from raft_tla_tpu_torch.engine import DEADLOCK
    if result.violation is None:
        return EXIT_OK
    return EXIT_DEADLOCK if result.violation.invariant == DEADLOCK \
        else EXIT_VIOLATION


def main(argv=None) -> int:
    return run(argv)[0]


def properties_of(cfg, extra=()) -> tuple:
    """The properties to check: the cfg's PROPERTY stanza, then the
    ``--property`` entries it does not name; each must parse."""
    from raft_tla_tpu_torch.models import liveness
    props = list(cfg.properties) + [nm for nm in extra
                                    if nm not in cfg.properties]
    for nm in props:
        liveness.parse_property(nm)     # raises with both registries
    return tuple(props)


def config_of(args, cfg=None) -> CheckConfig:
    """The ``CheckConfig`` of parsed CLI arguments (the cfg file read,
    unless it is given)."""
    from raft_tla_tpu_torch.utils.cfgparse import load_cfg
    return resolve_check_config(
        cfg if cfg is not None else load_cfg(args.cfg), spec=args.spec,
        max_term=args.max_term, max_log=args.max_log,
        max_msgs=args.max_msgs, max_dup=args.max_dup, chunk=args.chunk, deadlock=args.deadlock, symmetry=args.symmetry,
        view=args.view, path=args.cfg, faithful=args.faithful,
        max_elections=args.max_elections)


def options_of(args):
    """The ``serve/jobs.JobOptions`` of parsed CLI arguments (what a
    model adapter's ``resolve_check_config`` reads)."""
    from raft_tla_tpu_torch.serve.jobs import JobOptions
    return JobOptions(
        spec=args.spec, max_term=args.max_term, max_log=args.max_log,
        max_msgs=args.max_msgs, max_dup=args.max_dup,
        faithful=args.faithful, max_elections=args.max_elections,
        chunk=args.chunk, symmetry=args.symmetry, view=args.view,
        deadlock=args.deadlock, properties=tuple(args.property))


def run(argv=None) -> tuple:
    """The CLI: ``(exit code, engine or None, result or None)``; the
    engine is returned for callers that inspect it after the run."""
    p = build_argparser()
    args = p.parse_args(argv)
    for flag, why in _NOT_PORTED.items():
        if getattr(args, flag[2:].replace("-", "_")) is not None:
            p.error(f"{flag} {why}")
    if args.engine not in ENGINES:
        p.error(f"--engine {args.engine} is not ported to raft_tla_tpu_torch "
                "yet (ROADMAP.md queue A: items 9 and 11, the paged, "
                f"streamed and parallel engines); only {', '.join(ENGINES)}")
    # The reference's engine gates (its check.main), with its exit code 2.
    if args.view and args.simulate:
        p.error("--view does not compose with --simulate (random walks "
                "replay concrete states; a view only folds dedup keys)")
    if (args.checkpoint or args.resume) and \
            args.engine not in _DEVICE_ENGINES:
        p.error(f"--checkpoint/--resume require a device-class engine "
                f"(got {args.engine}); other engines would silently "
                "ignore them")
    if args.deadline is not None and args.engine != "ddd":
        p.error(f"--deadline requires --engine ddd (got {args.engine}); "
                "only the ddd engine stops losslessly at a segment "
                "boundary — dropping it silently would run unbounded")
    if args.stats and args.engine not in _DEVICE_ENGINES:
        p.error(f"--stats requires a device-class engine "
                f"(got {args.engine})")
    if (args.events or args.phase_timers or args.trace) and \
            args.engine not in _DEVICE_ENGINES:
        p.error(f"--events/--phase-timers/--trace require a device-class "
                f"engine (got {args.engine}); other engines emit no run "
                "events")
    import os
    from raft_tla_tpu_torch.obs.events import ENV_EVENTS, events_path
    if args.trace and not events_path(args.events):
        p.error("--trace requires --events PATH (spans are rows in the "
                "run-event log; without a log there is nowhere to put "
                "them)")
    if args.events or args.phase_timers or args.trace:
        # process-wide, as in the reference: every engine an invocation
        # builds (liveness re-runs included) reads the same gates
        from raft_tla_tpu_torch.obs.phases import ENV_PHASE_TIMERS
        from raft_tla_tpu_torch.obs.trace import ENV_TRACE
        if args.events:
            os.environ[ENV_EVENTS] = args.events
        if args.phase_timers:
            os.environ[ENV_PHASE_TIMERS] = "1"
        if args.trace:
            os.environ[ENV_TRACE] = "1"
    for flag, env in (("host_dedup", "RAFT_TLA_HOSTDEDUP"),
                      ("prefetch", "RAFT_TLA_PREFETCH")):
        if getattr(args, flag) is not None:
            # resolved once at engine construction (utils/keyset,
            # utils/prefetch), as in the reference
            os.environ[env] = getattr(args, flag)
    from raft_tla_tpu_torch import __version__
    from raft_tla_tpu_torch.frontend.registry import resolve_model
    from raft_tla_tpu_torch.utils.cfgparse import load_cfg
    model = resolve_model(args.spec)
    try:
        cfg = load_cfg(args.cfg)
        if model.is_raft:
            config = config_of(args, cfg)
            props = properties_of(cfg, args.property)
        else:
            # non-Raft models own their cfg mapping (the reference's
            # serve/jobs.resolve_check_config routes them so)
            config, props = model.resolve_check_config(
                cfg, options_of(args), path=args.cfg)
    except (OSError, ValueError, NotImplementedError) as e:
        print(f"Error: {e}", file=sys.stderr)
        return EXIT_ERROR, None, None
    if not model.is_raft and args.engine not in model.engines:
        p.error(f"--engine {args.engine} does not support spec "
                f"{args.spec!r} (supported: {', '.join(model.engines)})")
    if args.simulate is not None and "simulate" not in model.engines:
        p.error(f"--simulate is not supported by spec {args.spec!r} "
                f"(supported engines: {', '.join(model.engines)})")
    if args.fleet and args.simulate is None:
        p.error("--fleet requires --simulate N (fleets are a "
                "simulation-mode engine)")
    if args.steer and not args.fleet:
        p.error("--steer requires --fleet (coverage steering lives in "
                "the sharded fleet engine)")
    if args.fault_weights and not args.fleet:
        p.error("--fault-weights requires --fleet")
    if not args.no_lint and lint(config, args.lint) != EXIT_OK:
        return EXIT_ERROR, None, None

    b = config.bounds
    if not model.is_raft:
        print(f"raft_tla_tpu_torch {__version__} — exhaustive check of spec "
              f"{args.spec} (frontend-compiled)")
        print(f"Universe: {b.n_servers} resource managers "
              f"(from {args.cfg})")
        print(f"Invariants: {', '.join(config.invariants) or '(none)'}")
    else:
        print(f"raft_tla_tpu_torch {__version__} — exhaustive check of Spec "
              f"(raft.tla:469), subset: {args.spec}")
        print(f"Universe: {b.n_servers} servers, {b.n_values} values "
              f"(from {args.cfg})")
        print(f"Constraint: MaxTerm={b.max_term} MaxLogLen={b.max_log} "
              f"MaxMsgs={b.max_msgs} MaxDup={b.max_dup}")
        if b.history:
            print("Faithful mode: history variables (elections/allLogs/"
                  f"voterLog/mlog) carried; elections capacity "
                  f"{b.max_elections}")
        print(f"Invariants: {', '.join(config.invariants) or '(none)'}")
        if config.symmetry:
            print(f"Symmetry: {' x '.join(config.symmetry)} permutations "
                  "(counting orbits)")
        if config.view:
            print(f"View: {config.view} (counting view-quotient states)")

    if args.emit_tlc and not model.is_raft:
        try:
            tla, cfgp = model.emit_tla(args.emit_tlc, b, config.invariants)
        except (OSError, ValueError) as e:
            print(f"Error: {e}", file=sys.stderr)
            return EXIT_ERROR, None, None
        print(f"TLC parity artifacts: {tla}, {cfgp}")
    elif args.emit_tlc:
        from raft_tla_tpu_torch.models import tla_export
        try:
            tla, cfgp = tla_export.export(args.emit_tlc, b,
                                          config.invariants,
                                          parity_view=not b.history,
                                          symmetry=config.symmetry,
                                          view=config.view,
                                          spec=config.spec,
                                          properties=props,
                                          wf=parse_wf(args.wf))
        except (OSError, ValueError) as e:
            print(f"Error: {e}", file=sys.stderr)
            return EXIT_ERROR, None, None
        print(f"TLC parity artifacts: {tla}, {cfgp}")

    if args.simulate is not None:
        if props:
            # Liveness needs the full behavior graph; sampling cannot
            # check it — reject rather than silently report OK.
            print(f"Error: PROPERTY {list(props)} cannot be checked in "
                  "--simulate mode (liveness needs exhaustive search)",
                  file=sys.stderr)
            return EXIT_ERROR, None, None
        sim = None
        try:
            sim = make_simulator(args, config)
            return report_simulation(args, config, sim)
        except Exception as e:
            print(f"Error: {e}", file=sys.stderr)
            return EXIT_ERROR, sim, None

    t0 = time.monotonic()
    eng = None
    try:
        eng = make_engine(args, config)
        if args.engine == "ref":
            from raft_tla_tpu_torch.models import refbfs
            result = refbfs.check(config)
        elif args.engine == "host":
            result = eng.check()
        elif args.engine == "ddd":
            result = eng.check(on_progress=_stats_cb(args),
                               checkpoint=args.checkpoint,
                               checkpoint_every_s=args.checkpoint_every,
                               resume=args.resume, deadline_s=args.deadline)
        else:
            result = eng.check(checkpoint=args.checkpoint,
                               checkpoint_every_s=args.checkpoint_every,
                               resume=args.resume,
                               on_progress=_stats_cb(args))
    except Exception as e:
        print(f"Error: {e}", file=sys.stderr)
        return EXIT_ERROR, eng, None
    wall = time.monotonic() - t0

    print(f"{result.n_states} distinct states found, diameter "
          f"{result.diameter}, {result.n_transitions} transitions, "
          f"{wall:.2f}s ({result.n_states / max(wall, 1e-9):,.0f} states/s).")
    if args.device == "cuda":
        # this process's kernel launches (a campaign's child reports its
        # own here, in its output file)
        from raft_tla_tpu_torch.ops import pallas_fp, pallas_step
        print(f"Kernel launches: step {pallas_step.launches}, fingerprint "
              f"{pallas_fp.launches}", file=sys.stderr)
    if args.coverage:
        for fam, cnt in sorted(result.coverage.items()):
            print(f"  {fam}: {cnt} new states")
    if result.violation is None and not result.complete:
        # A lossless stop: no verdict was reached, so neither "no error
        # found" nor liveness (which needs the whole graph) may be claimed.
        print("Model checking stopped before completion (state space "
              "not exhausted); resume from the checkpoint to continue.")
        return EXIT_STOPPED, eng, result
    if result.violation is None and props:
        code = check_liveness(args, config, props, result.liveness)
        if code != EXIT_OK:
            return code, eng, result
    code = verdict_code(result)
    if code == EXIT_OK:
        print("Model checking completed. No error has been found.")
    elif args.no_trace:
        print("Error: Deadlock reached." if code == EXIT_DEADLOCK else
              f"Error: Invariant {result.violation.invariant} is violated.")
    else:
        print(model.render_trace(result.violation, b))
    return code, eng, result


def lint(config, mode: str = "warn") -> int:
    """The width pass before any step build (the reference's ``--lint``;
    for a non-Raft spec its schema check): findings go to stderr under
    ``speclint (width pass):``; a crash of the
    analyzer is itself a finding; ``strict`` turns any finding into exit
    1."""
    from raft_tla_tpu_torch.analysis import report
    from raft_tla_tpu_torch.frontend.registry import resolve_model
    try:
        # a Raft spec's width proof; a schema spec's validity gate
        found = resolve_model(config.spec).check_widths(config.bounds)
    except Exception as e:      # analyzer bug: report, don't block
        found = [report.Finding(
            report.WIDTH, report.ERROR, "lint-internal-error",
            f"width pass crashed: {e!r}")]
    if found:
        print(report.render(found, header="speclint (width pass):"),
              file=sys.stderr)
        if mode == "strict":
            return EXIT_ERROR
    return EXIT_OK


def parse_wf(text: str) -> tuple:
    """``--wf`` families; 'none' = no fairness (the raw reference Spec).
    One definition for the checker and the TLC twin, so the emitted
    FairSpec always encodes the same fairness as the verdict."""
    if text.strip().lower() == "none":
        return ()
    return tuple(f.strip() for f in text.split(",") if f.strip())


def liveness_graph(args, config):
    """The behavior graph of a liveness check, by the reference's routing:
    the interpreter for ``host``/``ref`` without a VIEW; the DDD engine's
    store under SYMMETRY, a VIEW or ``--engine ddd``; else the device
    engine's."""
    from raft_tla_tpu_torch.models import liveness
    if args.engine in ("host", "ref") and not config.view:
        return liveness.explore_graph(config)
    if config.view or config.symmetry or args.engine == "ddd":
        from raft_tla_tpu_torch.ddd_engine import DDDCapacities
        from raft_tla_tpu_torch.models import spec as S
        if config.symmetry:
            print("Symmetry: liveness runs on the orbit-quotient "
                  "graph (exact for the registered properties — "
                  "models/liveness.ddd_graph); the lasso, if any, "
                  "is a quotient witness")
        A = len(S.action_table(config.bounds, config.spec))
        return liveness.ddd_graph(config, DDDCapacities(
            block=args.block or 1 << 20,
            table=1 << max(10, min(26, (2 * args.cap - 1).bit_length())),
            seg_rows=max(1 << 19, 2 * args.chunk * A),
            levels=args.levels), device=args.device)
    from raft_tla_tpu_torch.device_engine import Capacities
    return liveness.engine_graph(config, Capacities(
        n_states=args.cap, levels=args.levels), device=args.device)


def check_liveness(args, config, props, out: list) -> int:
    """Build the graph once and check every property on it (the
    reference's ``_check_liveness``); each verdict is appended to
    ``out``."""
    from raft_tla_tpu_torch.models import liveness
    try:
        graph = liveness_graph(args, config)
    except (ValueError, RuntimeError) as e:
        print(f"Error: {e}", file=sys.stderr)
        return EXIT_ERROR
    try:
        return report_liveness(args, config, props, parse_wf(args.wf),
                               graph, out)
    finally:
        if isinstance(graph[0], liveness.StatesView):
            graph[0].close()        # the rows the export kept


def report_liveness(args, config, props, wf, graph, out: list) -> int:
    """The reference's ``_report_liveness``: one verdict line per
    property, and the lasso of the first violated one (exit 13)."""
    from raft_tla_tpu_torch.models import liveness
    from raft_tla_tpu_torch.utils.render import render_state

    for nm in props:
        t0 = time.monotonic()
        try:
            res = liveness.check(config, nm, wf=wf, graph=graph)
        except ValueError as e:
            print(f"Error: {e}", file=sys.stderr)
            return EXIT_ERROR
        wall = time.monotonic() - t0
        out.append(res)
        pspec = liveness.parse_property(nm)
        shape = f"{pspec.pred_names[0]} ~> {pspec.pred_names[1]}" \
            if pspec.form == liveness.LEADS_TO \
            else f"{pspec.form}{pspec.pred_names[0]}"
        shape_txt = f" ({shape})" if shape != nm else ""
        wf_txt = ", ".join(wf) if wf else "no fairness (raw Spec)"
        print(f"Property {nm}{shape_txt} under WF({wf_txt}): "
              f"{res.n_states} states, {res.n_edges} transitions, "
              f"{wall:.2f}s.")
        if res.holds:
            print(f"Property {nm} is satisfied.")
            continue
        print(f"Error: Property {nm} is violated.")
        if not args.no_trace:
            print("Error: The following behavior, repeated forever, "
                  "refutes it:")
            v = res.violation
            for k, (label, state) in enumerate(v.prefix, start=1):
                head = "<Initial predicate>" if label is None \
                    else f"<{label}>"
                print(f"State {k}: {head}")
                print(render_state(state, config.bounds))
            n0 = len(v.prefix)
            for k, (label, state) in enumerate(v.cycle, start=n0 + 1):
                print(f"State {k}: <{label}>  (loop)")
                print(render_state(state, config.bounds))
            print(f"(the loop returns to State {n0 + 1})")
        return EXIT_LIVENESS
    return EXIT_OK


def make_engine(args, config):
    """The engine of parsed CLI arguments, sized as the reference's CLI
    sizes it (None for the oracle, which is a function)."""
    if args.engine == "ref":
        return None
    if args.engine == "host":
        from raft_tla_tpu_torch.engine import Engine
        return Engine(config, device=args.device)
    if args.engine == "ddd":
        from raft_tla_tpu_torch.ddd_engine import DDDCapacities, DDDEngine
        from raft_tla_tpu_torch.models import spec as S
        # the filter is a traffic optimization, not a capacity bound:
        # sized to the expected state count, capped at 2^28 slots
        table = 1 << max(10, min(28, (2 * args.cap - 1).bit_length()))
        # a segment's buffers hold at least one chunk's worst-case stream
        A = len(S.action_table(config.bounds, config.spec))
        seg_rows = max(1 << 19, 2 * args.chunk * A)
        return DDDEngine(config, DDDCapacities(
            block=args.block or 1 << 20, table=table, seg_rows=seg_rows,
            levels=args.levels, retention=args.retention,
            keep_levels=args.keep_levels), device=args.device)
    from raft_tla_tpu_torch.device_engine import Capacities, DeviceEngine
    return DeviceEngine(config, Capacities(n_states=args.cap,
                                           levels=args.levels),
                        device=args.device)


def parse_fault_weights(text):
    """``Fam=W,Fam=W`` -> dict; raises ValueError on malformed cells
    (family-name validity is checked by the fleet engine, which knows
    the spec's action table)."""
    if not text:
        return None
    out = {}
    for cell in text.split(","):
        fam, eq, w = cell.partition("=")
        if not eq or not fam.strip():
            raise ValueError(f"bad --fault-weights cell {cell!r} "
                             "(want Family=Weight,...)")
        out[fam.strip()] = float(w)
    return out


def make_simulator(args, config):
    """The walker engine of parsed CLI arguments: the fleet with
    ``--fleet``, else the solo simulator."""
    if args.fleet:
        from raft_tla_tpu_torch.fleet import FleetSimulator
        return FleetSimulator(config, walkers=args.walkers,
                              depth=args.depth, seed=args.seed,
                              steer_tau=args.steer,
                              fault_weights=parse_fault_weights(
                                  args.fault_weights),
                              device=args.device)
    from raft_tla_tpu_torch.simulate import Simulator
    return Simulator(config, walkers=args.walkers, depth=args.depth,
                     seed=args.seed, device=args.device)


def report_simulation(args, config, sim) -> tuple:
    """TLC -simulate analog (the reference's ``_simulate``): run, print the
    result lines, ``-> (exit code, simulator, result)``."""
    from raft_tla_tpu_torch.engine import DEADLOCK
    # --stats/--events flow through the same RunTelemetry facade as the
    # exhaustive engines (the events path rides the env set in run()).
    res = sim.run(args.simulate, on_progress=_stats_cb(args))
    print(f"{res.n_behaviors} behaviors generated ({res.n_states} states, "
          f"deepest {res.max_depth_seen}), {res.wall_s:.2f}s "
          f"({res.states_per_sec:,.0f} states/s).")
    if args.device == "cuda":
        from raft_tla_tpu_torch.ops import pallas_step
        print(f"Kernel launches: step {pallas_step.launches}; host fetches "
              f"{sim.fetches} over {sim.dispatches} dispatches",
              file=sys.stderr)
    if args.fleet:
        print(f"Fleet: {res.n_devices} devices x "
              f"{res.walkers // res.n_devices} walkers"
              + (f", steer tau={res.steer_tau:g}" if res.steer_tau
                 else "")
              + f"; action-coverage entropy {res.coverage_entropy:.3f}")
    if res.violation is None:
        print("Model checking completed. No error has been found.")
        print(f"  (simulation: {args.simulate} behaviors of depth "
              f"<= {args.depth}; not exhaustive)")
        if args.fleet:
            per = res.confidence(config.invariants)["per_invariant"]
            for nm in config.invariants:
                print(f"  {nm}: held on {per[nm]:,} sampled states")
        return EXIT_OK, sim, res
    is_deadlock = res.violation.invariant == DEADLOCK
    if args.no_trace:
        print("Error: Deadlock reached." if is_deadlock else
              f"Error: Invariant {res.violation.invariant} is violated.")
    else:
        from raft_tla_tpu_torch.frontend.registry import resolve_model
        print(resolve_model(config.spec).render_trace(res.violation,
                                                      config.bounds))
    return (EXIT_DEADLOCK if is_deadlock else EXIT_VIOLATION), sim, res


def _stats_cb(args):
    if not args.stats:
        return None
    import json

    def cb(stats):
        print(json.dumps(stats), file=sys.stderr, flush=True)
    return cb


def entry() -> None:
    """Console-script entry point."""
    sys.exit(main())


if __name__ == "__main__":
    sys.exit(main())
