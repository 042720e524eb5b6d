"""The checker CLI — the port of ``raft_tla_tpu/check.py``,
``python -m raft_tla_tpu_torch.check CFG``.

A stock TLC model config in (the universe ``Server``/``Value`` and the
``INVARIANT`` stanza); the state constraint from the ``--max-*`` flags; the
device engine runs the search on the card (``--device cuda``, the default)
or on the CPU (``--device cpu``).  The result lines and exit codes are the
reference's: 0 no error, 11 deadlock, 12 invariant violation, 1 error.

This port supports the device engine in parity and faithful mode
(``--faithful``: the history variables carried as state, with the
``*Hist`` invariants), with SYMMETRY on the Server and Value axes
(``--symmetry`` or the cfg stanza), the registered VIEWs (``--view``) and
registry invariants.  The reference's other flags and stanzas are refused
with the ROADMAP.md item that will bring them.
"""

from __future__ import annotations

import argparse
import sys
import time

EXIT_OK = 0
EXIT_DEADLOCK = 11       # TLC's exit code for deadlock
EXIT_VIOLATION = 12      # TLC's exit code for safety-property violations
EXIT_ERROR = 1

# Reference flags that this slice refuses, with the ROADMAP.md queue item.
_NOT_PORTED = {
    "--property": "liveness",
    "--simulate": "simulation and fleets",
    "--emit-tlc": "TLC export",
}


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m raft_tla_tpu_torch.check",
        description="GPU exhaustive checker for the Raft TLA+ spec "
                    "(PyTorch/CUDA port of raft_tla_tpu)")
    p.add_argument("cfg", help="TLC model config; binds Server/Value/"
                               "INVARIANT")
    p.add_argument("--spec", default="full",
                   choices=("full", "election", "replication"),
                   help="Next-disjunct subset (default: full)")
    p.add_argument("--engine", default="device",
                   help="only 'device' is ported (the reference's default)")
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
    p.add_argument("--checkpoint", metavar="PATH",
                   help="write the search carry here (reference .npz format)")
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
    flags.  Raises ValueError on a bad cfg and NotImplementedError on a
    stanza that is not ported."""
    from raft_tla_tpu_torch.config import (
        Bounds, CheckConfig, not_ported)
    from raft_tla_tpu_torch.models import invariants as inv_mod
    from raft_tla_tpu_torch.utils import cfgparse

    if cfg.specification not in (None, "Spec"):
        raise ValueError(
            f"unsupported SPECIFICATION {cfg.specification!r}: the compiled "
            "model implements Spec == Init /\\ [][Next]_vars (raft.tla:469)")
    if cfg.init not in (None, "Init") or cfg.next not in (None, "Next"):
        raise ValueError(
            f"unsupported INIT/NEXT ({cfg.init!r}/{cfg.next!r}): only the "
            "spec's Init and Next are compiled")
    exprs = [nm for nm in cfg.invariants if cfgparse.is_expression(nm)]
    if exprs:
        raise not_ported(f"invariant expression {exprs[0]!r}",
                         "expression invariants")
    cfgparse.resolve_names(cfg.invariants, inv_mod.REGISTRY, "invariant",
                           cfg=cfg, path=path)
    if cfg.properties:
        raise not_ported(f"PROPERTY {cfg.properties}", "liveness")
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


def run(argv=None) -> tuple:
    """The CLI: ``(exit code, engine or None, result or None)``; the
    engine is returned for callers that inspect it after the run."""
    p = build_argparser()
    args = p.parse_args(argv)
    for flag, item in _NOT_PORTED.items():
        if getattr(args, flag[2:].replace("-", "_")) is not None:
            p.error(f"{flag} is not ported to raft_tla_tpu_torch yet "
                    f"(ROADMAP.md queue A: {item})")
    if args.engine != "device":
        p.error(f"--engine {args.engine} is not ported to raft_tla_tpu_torch "
                "yet (ROADMAP.md queue A: other engines); only 'device'")
    from raft_tla_tpu_torch import __version__
    from raft_tla_tpu_torch.utils.cfgparse import load_cfg
    try:
        config = resolve_check_config(
            load_cfg(args.cfg), spec=args.spec, max_term=args.max_term,
            max_log=args.max_log, max_msgs=args.max_msgs,
            max_dup=args.max_dup, chunk=args.chunk, deadlock=args.deadlock,
            symmetry=args.symmetry, view=args.view, path=args.cfg,
            faithful=args.faithful, max_elections=args.max_elections)
    except (OSError, ValueError, NotImplementedError) as e:
        print(f"Error: {e}", file=sys.stderr)
        return EXIT_ERROR, None, None

    b = config.bounds
    print(f"raft_tla_tpu_torch {__version__} — exhaustive check of Spec "
          f"(raft.tla:469), subset: {args.spec}")
    print(f"Universe: {b.n_servers} servers, {b.n_values} values "
          f"(from {args.cfg})")
    print(f"Constraint: MaxTerm={b.max_term} MaxLogLen={b.max_log} "
          f"MaxMsgs={b.max_msgs} MaxDup={b.max_dup}")
    if b.history:
        print("Faithful mode: history variables (elections/allLogs/"
              f"voterLog/mlog) carried; elections capacity {b.max_elections}")
    print(f"Invariants: {', '.join(config.invariants) or '(none)'}")
    if config.symmetry:
        print(f"Symmetry: {' x '.join(config.symmetry)} permutations "
              "(counting orbits)")
    if config.view:
        print(f"View: {config.view} (counting view-quotient states)")

    t0 = time.monotonic()
    eng = None
    try:
        from raft_tla_tpu_torch.device_engine import Capacities, DeviceEngine
        eng = DeviceEngine(config, Capacities(n_states=args.cap,
                                              levels=args.levels),
                           device=args.device)
        result = eng.check(checkpoint=args.checkpoint,
                           checkpoint_every_s=args.checkpoint_every,
                           resume=args.resume)
    except Exception as e:
        print(f"Error: {e}", file=sys.stderr)
        return EXIT_ERROR, eng, None
    wall = time.monotonic() - t0

    print(f"{result.n_states} distinct states found, diameter "
          f"{result.diameter}, {result.n_transitions} transitions, "
          f"{wall:.2f}s ({result.n_states / max(wall, 1e-9):,.0f} states/s).")
    if args.coverage:
        for fam, cnt in sorted(result.coverage.items()):
            print(f"  {fam}: {cnt} new states")
    code = verdict_code(result)
    if code == EXIT_OK:
        print("Model checking completed. No error has been found.")
    elif args.no_trace:
        print("Error: Deadlock reached." if code == EXIT_DEADLOCK else
              f"Error: Invariant {result.violation.invariant} is violated.")
    else:
        from raft_tla_tpu_torch.utils.render import render_trace
        print(render_trace(result.violation, b))
    return code, eng, result


def entry() -> None:
    """Console-script entry point."""
    sys.exit(main())


if __name__ == "__main__":
    sys.exit(main())
