"""The port's lint CLI (``python -m raft_tla_tpu_torch.lint``) against the
reference's (``raft_tla_tpu.analysis.__main__``): the same flags, header,
exit-code policy and the same pass-1 and pass-2 findings on the same cfg
and flags, in each ``--mode``.  Passes 3-5 read each package's own tree,
so they are held to their references in tests/test_torch_{jitlint,
threadlint,contracts}.py and skipped here.  Tolerance: exact equality of
every finding field (pass, severity, code, message, transition, field,
interval, width, file, line) and of the exit codes.
"""

import dataclasses
import io
import sys
from contextlib import redirect_stdout
from pathlib import Path

import pytest

from raft_tla_tpu.analysis import __main__ as jlint

from raft_tla_tpu_torch import lint
from raft_tla_tpu_torch.analysis import __main__ as plint

ROOT = Path(__file__).resolve().parent.parent
FLAGSHIP = str(ROOT / "runs" / "MC3s2v.cfg")
TREE_PASSES = ["--skip", "jit", "--skip", "thread", "--skip", "contract"]
BASE = ("CONSTANTS\n Server = {s1, s2, s3}\n Value = {v1, v2}\n")


def _both(argv):
    """``(port findings, port code), (reference findings, code)``, the
    findings as tuples of all their fields."""
    out = []
    for mod in (plint, jlint):
        findings, code = mod.run_lint(
            mod.build_argparser().parse_args(argv + TREE_PASSES))
        out.append(([dataclasses.astuple(f) for f in findings], code))
    return out


def _cfg(tmp_path, text):
    p = tmp_path / "t.cfg"
    p.write_text(text)
    return str(p)


@pytest.mark.parametrize("mode", ["parity", "faithful", "both"])
def test_flagship_passes_1_2_match_reference(mode):
    """Acceptance: the flagship cfg proves clean in each mode, as in the
    reference, exit 0."""
    mine, ref = _both([FLAGSHIP, "--mode", mode])
    assert mine == ref == ([], 0)


def test_unknown_names_match_reference(tmp_path):
    """An unknown invariant (did-you-mean, its cfg line) and an unknown
    symmetry: the same error findings in both modes, exit 1 in both."""
    cfg = _cfg(tmp_path, "SPECIFICATION Spec\nINVARIANT NoTwoLeders\n"
                         "SYMMETRY Serv\n" + BASE)
    mine, ref = _both([cfg])
    assert mine == ref
    findings, code = mine
    assert code == 1
    inv = [f for f in findings if f[2] == "unknown-invariant"]
    assert len(inv) == 2 and all(f[9] == 2 for f in inv)
    assert all("NoTwoLeaders" in f[3] for f in inv)
    assert any(f[2] == "unknown-symmetry" for f in findings)


def test_strict_policy_matches_reference(tmp_path):
    """Warnings alone (a vacuous invariant under the election subspec)
    exit 0; under --strict they exit 1; the same findings in both."""
    cfg = _cfg(tmp_path, "SPECIFICATION Spec\nINVARIANT LogMatching\n"
                         + BASE)
    mine, ref = _both([cfg, "--spec", "election"])
    assert mine == ref and mine[1] == 0
    assert mine[0] and all(f[1] == "warning" for f in mine[0])
    strict, jstrict = _both([cfg, "--spec", "election", "--strict"])
    assert strict == jstrict and strict[1] == 1


def test_skip_covers_all_five_passes(tmp_path):
    """Each pass can be skipped: with all five skipped a bad cfg has no
    findings and exits 0 (as in the reference)."""
    cfg = _cfg(tmp_path, "SPECIFICATION Spec\nINVARIANT NoTwoLeders\n"
                         + BASE)
    argv = [cfg, "--skip", "width", "--skip", "cfg"]
    assert _both(argv) == [([], 0), ([], 0)]
    assert _both([cfg, "--skip", "width"])[0][1] == 1


def test_unreadable_cfg_matches_reference():
    mine, ref = _both(["/no/such/file.cfg"])
    assert mine == ref
    assert mine[1] == 1 and mine[0][0][2] == "cfg-unreadable"


def test_spec_goes_through_the_model_registry(tmp_path):
    """``--spec ir-election`` finds what ``election`` finds; a twophase
    cfg lints clean through its schema check; an unknown spec is a
    ``spec-unknown`` finding with the registry's did-you-mean, exit 1."""
    def run(argv):
        findings, code = plint.run_lint(
            plint.build_argparser().parse_args(argv + TREE_PASSES))
        return [dataclasses.astuple(f) for f in findings], code

    ir, hand = run([FLAGSHIP, "--spec", "ir-election"]), \
        run([FLAGSHIP, "--spec", "election"])
    assert ir == hand and hand[1] == 0 and hand[0]    # vacuity warnings
    tpc = _cfg(tmp_path, "SPECIFICATION Spec\nCONSTANT RM = {r1, r2}\n"
                         "INVARIANT TCConsistent\n")
    assert run([tpc, "--spec", "twophase"]) == ([], 0)
    bad = _cfg(tmp_path, "SPECIFICATION Spec\nCONSTANT RM = {}\n")
    findings, code = run([bad, "--spec", "twophase"])
    assert code == 1 and findings[0][2] == "resolve-failed"
    findings, code = run([FLAGSHIP, "--spec", "fulll"])
    assert code == 1 and findings[0][2] == "spec-unknown"
    assert "did you mean: full" in findings[0][3]


def test_entry_header_and_aliases(monkeypatch):
    """``entry()`` (the ``raft-tla-lint-torch`` script) exits with
    ``main``'s code and prints the reference's header and summary;
    ``python -m raft_tla_tpu_torch.analysis`` is the same program."""
    monkeypatch.setattr(sys, "argv", ["raft-tla-lint-torch", FLAGSHIP,
                                      "--mode", "parity", *TREE_PASSES])
    out = io.StringIO()
    with pytest.raises(SystemExit) as e, redirect_stdout(out):
        lint.entry()
    assert e.value.code == 0
    lines = out.getvalue().splitlines()
    assert lines == [f"speclint: {FLAGSHIP} mode=parity spec=full",
                     "0 error(s), 0 warning(s)"]
    assert lint.main is plint.main and lint.run_lint is plint.run_lint
    assert plint.build_argparser().prog == "raft-tla-lint-torch"
    assert 'raft-tla-lint-torch = "raft_tla_tpu_torch.lint:entry"' in \
        (ROOT / "pyproject.toml").read_text()
