"""The port's TLC export (``--emit-tlc``) against the JAX reference.

``raft_tla_tpu_torch.models.tla_export.export`` must write ``MCraft.tla``
and ``MCraft.cfg`` byte-equal to ``raft_tla_tpu.models.tla_export.export``
for the same bounds and flags: parity and faithful mode, with and without
SYMMETRY and VIEW, both spec subsets it exports, with and without temporal
PROPERTY twins and the ``--wf`` fairness twin.  It keeps the reference's
refusals, and the CLI writes the twin and then runs the check, as the
reference's does.
"""

import io
import itertools
from contextlib import redirect_stderr, redirect_stdout
from pathlib import Path

import pytest

from raft_tla_tpu import check as jcli
from raft_tla_tpu.config import Bounds as JBounds
from raft_tla_tpu.models import tla_export as jexport
from raft_tla_tpu.utils import cfgparse as jcfgparse

from raft_tla_tpu_torch import check as cli
from raft_tla_tpu_torch.config import Bounds
from raft_tla_tpu_torch.models import tla_export

from test_torch_cli import _result_lines, write_cfg

PARITY = ("NoTwoLeaders", "LogMatching", "CommittedWithinLog",
          "LeaderCompleteness", "NaiveNoTwoLeaders", "ElectionSafety")
FAITHFUL = PARITY[:4] + ("ElectionSafetyHist", "LeaderCompletenessHist",
                         "AllLogsPrefixClosed")


# (properties, --wf families): none; registered names and formulas of all
# three shapes under per-family fairness; WF(Next); no fairness
TEMPORAL = (((), ()),
            (("EventuallyLeader", "[]<>SomeLeader",
              "SomeCandidate ~> SomeLeader"), ("Timeout", "Receive")),
            (("EventuallyCommit",), ("Next",)),
            (("<>SomeCommit",), ()))


def _both(tmp_path, tag, kw, invs, **flags):
    """The two packages' files for one configuration, as bytes."""
    out = []
    for name, mod, B in (("port", tla_export, Bounds),
                         ("jax", jexport, JBounds)):
        d = tmp_path / f"{tag}-{name}"
        paths = mod.export(str(d), B(**kw), invs, **flags)
        out.append([Path(p).read_bytes() for p in paths])
        assert [Path(p).name for p in paths] == ["MCraft.tla", "MCraft.cfg"]
    return out


@pytest.mark.parametrize("faithful", [False, True],
                         ids=["parity", "faithful"])
def test_export_is_byte_equal_to_the_reference(tmp_path, faithful):
    kw = dict(n_servers=3, n_values=2, max_term=2, max_log=1, max_msgs=2,
              max_dup=1, history=faithful)
    invs = FAITHFUL if faithful else PARITY
    grid = itertools.product(
        ((), ("Server",), ("Value",), ("Server", "Value"), True),
        (None, "deadvotes"), ("full", "election"), TEMPORAL)
    for k, (sym, view, spec, (props, wf)) in enumerate(grid):
        got, want = _both(tmp_path, k, kw, invs, parity_view=not faithful,
                          symmetry=sym, view=view, spec=spec,
                          properties=props, wf=wf)
        assert got == want, (sym, view, spec, props, wf)
    # The emitted cfg round-trips through the reference's parser.
    text = got[1].decode()
    parsed = jcfgparse.parse_cfg(text)
    assert parsed.invariants == list(invs)


def test_export_keeps_the_reference_refusals(tmp_path):
    b, jb = Bounds(), JBounds()
    for bad in (dict(invariants=("commitIndex <= logLen",)),
                dict(invariants=("NoTwoLeaders",), view="myview"),
                dict(invariants=("NoTwoLeaders",), spec="replication"),
                dict(invariants=("NoTwoLeaders",), symmetry=("Term",)),
                dict(invariants=("NoTwoLeaders",),
                     properties=("EventuallyLeader",), wf=("Bogus",)),
                dict(invariants=("NoTwoLeaders",), properties=("<>Nope",))):
        args = dict(bad)
        invs = args.pop("invariants")
        with pytest.raises(ValueError) as want:
            jexport.emit_module(jb, invs, **args)
        with pytest.raises(ValueError) as got:
            tla_export.emit_module(b, invs, **args)
        assert str(got.value) == str(want.value)


def _run(main, argv):
    out, err = io.StringIO(), io.StringIO()
    with redirect_stdout(out), redirect_stderr(err):
        code = main(list(argv))
    return code, out.getvalue(), err.getvalue()


def test_cli_emits_the_twin_then_checks(tmp_path):
    """``--emit-tlc DIR``: the JAX CLI's files and lines, exit codes
    included, for a pass, a faithful symmetric run and an expression (which
    the export refuses: exit 1 before any search)."""
    args = ["--spec", "election", "--max-term", "2", "--max-log", "0",
            "--max-msgs", "2"]
    cases = [("NoTwoLeaders", "", []),
             ("NoTwoLeaders ElectionSafetyHist", "SYMMETRY Server\n",
              ["--faithful", "--max-elections", "4", "--view", "deadvotes"]),
             ("count(role = 2) <= 1", "", []),
             ("NoTwoLeaders", "PROPERTY EventuallyLeader\n",
              ["--property", "SomeCandidate ~> SomeLeader", "--wf",
               "Timeout,Receive"])]
    for k, (inv, extra, flags) in enumerate(cases):
        cfg = write_cfg(tmp_path / f"m{k}.cfg", invariant=inv, extra=extra)
        outs = []
        for name, main, engine in (("port", cli.main, ["--device", "cpu"]),
                                   ("jax", jcli.main, [])):
            d = tmp_path / f"twin{k}"
            code, out, err = _run(main, [cfg, "--engine", "ref", *engine,
                                         "--emit-tlc", str(d), *args,
                                         *flags])
            files = sorted(p.name for p in d.glob("*")) if d.exists() \
                else []
            outs.append((code, out, err, files,
                         [p.read_bytes() for p in sorted(d.glob("*"))]))
        (code, out, err, files, blobs), (jcode, jout, jerr, jfiles,
                                         jblobs) = outs
        assert code == jcode
        if code == cli.EXIT_ERROR:
            assert "no TLA+ export for invariants" in err
            assert err.splitlines()[-1] == jerr.splitlines()[-1]
            continue
        assert files == jfiles == ["MCraft.cfg", "MCraft.tla"]
        assert blobs == jblobs
        assert f"TLC parity artifacts: {tmp_path / f'twin{k}'}" in out
        assert _result_lines(out) == _result_lines(jout)
