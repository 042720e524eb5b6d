"""The port's CLI against the JAX CLI, and the port's import hygiene.

``python -m raft_tla_tpu_torch.check --device cpu`` must print the JAX
CLI's result lines (counts, coverage, verdict, rendered trace) and return
its exit codes.  On a pass every engine of the reference prints the same
lines, so the JAX side runs its ``ref`` oracle (no compile).  On a
violation or deadlock a device engine also counts the states of the chunk
in which the search stopped: at ``--chunk 1`` that is exactly what the
oracle counts, and at a larger chunk the JAX side runs its device engine
at the same ``--chunk``.
"""

import ast
import io
import re
import subprocess
import sys
from contextlib import redirect_stderr, redirect_stdout
from pathlib import Path

import pytest
import torch

from raft_tla_tpu import check as jcli

from raft_tla_tpu_torch import check as cli

# The suite runs in several worker processes: one torch thread each keeps
# these small CPU tensors from competing with the other workers for cores.
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent

_CONSTANTS = (
    "CONSTANTS\n"
    "    Server = {%s}\n    Value = {v1}\n"
    '    Follower = "Follower"\n    Candidate = "Candidate"\n'
    '    Leader = "Leader"\n    Nil = "Nil"\n')


def write_cfg(path, servers="s1, s2", invariant="NoTwoLeaders", extra=""):
    path.write_text(f"SPECIFICATION Spec\nINVARIANT {invariant}\n"
                    + extra + _CONSTANTS % servers)
    return str(path)


def _run(main, argv):
    out, err = io.StringIO(), io.StringIO()
    with redirect_stdout(out), redirect_stderr(err):
        code = main(list(argv))
    return code, out.getvalue(), err.getvalue()


def _result_lines(text):
    """Everything from the count line on, with the wall time and rate cut
    out of the count line."""
    lines = text.splitlines()
    k = next(i for i, ln in enumerate(lines) if "distinct states found" in ln)
    lines[k] = re.sub(r", [0-9.]+s \(.*states/s\)\.$", "", lines[k])
    return lines[k:]


ELECTION_2S = ["--spec", "election", "--max-term", "2", "--max-log", "0",
               "--max-msgs", "2"]


@pytest.mark.parametrize("args,invariant,servers,engine,want_code,extra", [
    (ELECTION_2S + ["--coverage"], "NoTwoLeaders", "s1, s2", "ref", 0, ""),
    (ELECTION_2S + ["--deadlock", "--chunk", "1"], "NoTwoLeaders",
     "s1", "ref", 11, ""),
    pytest.param(["--spec", "election", "--max-term", "3", "--max-log", "0",
                  "--max-msgs", "1", "--chunk", "1024"], "NaiveNoTwoLeaders",
                 "s1, s2, s3", "device", 12, "", marks=pytest.mark.slow),
    (ELECTION_2S + ["--coverage"], "NoTwoLeaders", "s1, s2", "ref", 0,
     "SYMMETRY SymServer\n"),
    (ELECTION_2S + ["--symmetry", "--coverage"], "NoTwoLeaders", "s1, s2",
     "ref", 0, ""),
    (["--spec", "full", "--max-term", "2", "--max-log", "1",
      "--max-msgs", "1", "--view", "deadvotes", "--coverage"],
     "NoTwoLeaders", "s1, s2", "ref", 0, ""),
    (ELECTION_2S + ["--faithful", "--max-elections", "4", "--coverage"],
     "NoTwoLeaders ElectionSafetyHist LeaderCompletenessHist "
     "AllLogsPrefixClosed", "s1, s2", "ref", 0, ""),
    (["--spec", "election", "--max-term", "2", "--max-log", "0",
      "--max-msgs", "1", "--faithful", "--max-elections", "2",
      "--view", "deadvotes", "--coverage"], "ElectionSafetyHist", "s1, s2",
     "ref", 0, "SYMMETRY Server\n"),
], ids=["pass", "deadlock", "violation", "symmetry-stanza", "symmetry-flag",
        "view", "faithful", "faithful-symmetry-view"])
def test_cli_result_lines_match_jax_cli(tmp_path, args, invariant, servers,
                                       engine, want_code, extra):
    cfg = write_cfg(tmp_path / "m.cfg", servers, invariant, extra)
    code, out, _ = _run(cli.main, [cfg, "--device", "cpu", *args])
    jcode, jout, _ = _run(jcli.main, [cfg, "--engine", engine, *args])
    assert code == jcode == want_code
    assert _result_lines(out) == _result_lines(jout)


def test_cli_refuses_what_is_not_ported(tmp_path):
    cfg = write_cfg(tmp_path / "m.cfg")
    for flag in ("--property", "--events"):
        with pytest.raises(SystemExit) as e:
            _run(cli.main, [cfg, flag, "x"])
        assert e.value.code == 2
    view = write_cfg(tmp_path / "v.cfg", extra="VIEW MyView\n")
    code, _, err = _run(cli.main, [view, "--device", "cpu"])
    jcode, _, jerr = _run(jcli.main, [view, "--engine", "ref"])
    assert code == jcode == cli.EXIT_ERROR
    assert "VIEW MyView not supported: parity mode" in err
    assert err.splitlines()[-1] == jerr.splitlines()[-1]
    # An expression that does not parse: the reference's error, line and
    # column included, and its exit code.
    expr = write_cfg(tmp_path / "e.cfg", invariant="\\A i : role[i] <= 2")
    code, _, err = _run(cli.main, [expr, "--device", "cpu"])
    jcode, _, jerr = _run(jcli.main, [expr, "--engine", "ref"])
    assert code == jcode == cli.EXIT_ERROR
    assert "does not parse: predicate syntax error at column 1" in err
    assert err.splitlines()[-1] == jerr.splitlines()[-1]
    if not torch.cuda.is_available():       # the default device is cuda
        code, _, err = _run(cli.main, [cfg, "--max-term", "2"])
        assert code == cli.EXIT_ERROR and "no GPU" in err


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def _is_forbidden(name):
    return name == "jax" or name.startswith("jax.") \
        or name == "raft_tla_tpu" or name.startswith("raft_tla_tpu.")


def test_port_sources_import_neither_jax_nor_the_reference():
    files = sorted((ROOT / "raft_tla_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    bad = [(f.name, m) for f in files for m in _imports(f) if _is_forbidden(m)]
    assert len(files) > 15 and not bad


def test_running_the_port_leaves_jax_and_the_reference_unloaded(tmp_path):
    cfg = write_cfg(tmp_path / "m.cfg", servers="s1")
    code = (
        "import sys\n"
        "from raft_tla_tpu_torch import check\n"
        f"rc = check.main([{cfg!r}, '--device', 'cpu', '--spec', 'full',"
        " '--max-term', '2', '--max-log', '1', '--max-msgs', '1'])\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'raft_tla_tpu' or m.startswith('raft_tla_tpu.')]\n"
        "print('LOADED', bad, 'RC', rc)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert "LOADED [] RC 0" in r.stdout, r.stdout + r.stderr
    assert "distinct states found" in r.stdout
