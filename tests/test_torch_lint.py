"""The port's width pass (``analysis/widthcheck``, the CLI's ``--lint``)
against the JAX reference's.

The port's ``check_widths`` runs over the port's own tables (``ops/msgbits``,
``ops/bitpack``, ``ops/kernels.TRANSFER_WRITES``, ``ops/pallas_step.
FUSED_WRITES``) and must give the JAX findings, as tuples, over a grid of
bounds and spec subsets and under three injected mutations of the
reference's mutation harness.  The kernels' declared write sets must cover
what the plain step really writes.  ``--no-lint`` and ``--lint strict`` run,
and a finding makes ``--lint strict`` exit 1 in both packages.
"""

import dataclasses
import itertools

import pytest
import torch

from raft_tla_tpu import check as jcli
from raft_tla_tpu.analysis import intervals as jiv
from raft_tla_tpu.analysis import report as jreport
from raft_tla_tpu.analysis import widthcheck as jwc
from raft_tla_tpu.config import Bounds as JBounds
from raft_tla_tpu.ops import bitpack as jbitpack, kernels as jkernels
from raft_tla_tpu.ops import msgbits as jmsgbits

from raft_tla_tpu_torch import check as cli
from raft_tla_tpu_torch.analysis import intervals as iv
from raft_tla_tpu_torch.analysis import report
from raft_tla_tpu_torch.analysis import widthcheck as wc
from raft_tla_tpu_torch.config import Bounds, CheckConfig
from raft_tla_tpu_torch.device_engine import Capacities, DeviceEngine
from raft_tla_tpu_torch.models import spec as SP
from raft_tla_tpu_torch.ops import bitpack, kernels, msgbits
from raft_tla_tpu_torch.ops import state as st

from test_torch_cli import ELECTION_2S, _run, write_cfg

torch.set_num_threads(1)


def _tuples(findings):
    return [dataclasses.astuple(f) for f in findings]


@pytest.mark.parametrize("spec", ["full", "election", "replication"])
def test_findings_equal_jax_over_the_bounds_grid(spec):
    for n, faithful in itertools.product((2, 3, 4, 5), (False, True)):
        kw = dict(n_servers=n, n_values=2, max_term=2, max_log=1,
                  max_msgs=2, history=faithful)
        got = wc.check_widths(Bounds(**kw), spec)
        want = jwc.check_widths(JBounds(**kw), spec)
        assert _tuples(got) == _tuples(want) == [], (kw, spec)


def _narrowed(pkg_bitpack, B):
    fb = dict(pkg_bitpack.field_bits(B()))
    fb["term"] -= 1
    return dict(field_bits_table=fb)


def _overlapping(pkg_msgbits, _B):
    hi = dict(pkg_msgbits.HI_FIELDS)
    sh, w = hi["mterm"]
    hi["mterm"] = (sh, w + 4)                    # grows into field 'a'
    return dict(hi_fields=hi)


def _drift(pkg_wc, _B):
    mut = dict(pkg_wc.TRANSFERS)

    def sneaky_advance(bounds, env, menv):
        r = pkg_wc.t_advance_commit(bounds, env, menv)
        writes = dict(r.writes)
        writes["matchIndex"] = env["matchIndex"]   # undeclared write
        return pkg_wc.TransferResult(writes, r.sends)

    mut["AdvanceCommitIndex"] = sneaky_advance
    return dict(transfers=mut)


# the reference's tests/test_lint_mutations.py cases, each with the module
# it mutates in the port and in the reference
MUTATIONS = {
    "field_bits_narrowed": (_narrowed, bitpack, jbitpack, "envelope-width"),
    "overlapping_subfields": (_overlapping, msgbits, jmsgbits,
                              "msg-table-overlap"),
    "transfer_drift_detected": (_drift, wc, jwc, "transfer-drift"),
}


@pytest.mark.parametrize("name", sorted(MUTATIONS))
def test_mutations_give_the_jax_findings(name):
    make, mod, jmod, code = MUTATIONS[name]
    got = wc.check_widths(Bounds(), **make(mod, Bounds))
    want = jwc.check_widths(JBounds(), **make(jmod, JBounds))
    assert _tuples(got) == _tuples(want)
    assert code in {f.code for f in got}


def test_kernel_write_sets_cover_the_plain_step():
    """Each family's successors differ from their parents only in the
    family's declared TRANSFER_WRITES (and the allLogs postlude), in parity
    and faithful mode; the tables are the reference's."""
    assert kernels.TRANSFER_WRITES == jkernels.TRANSFER_WRITES
    assert kernels.POSTLUDE_WRITES == jkernels.POSTLUDE_WRITES
    assert set(kernels.transfer_metadata()) == set(SP.ALL_FAMILIES)
    for faithful in (False, True):
        b = Bounds(n_servers=2, n_values=1, max_term=2, max_log=1,
                   max_msgs=1, history=faithful, max_elections=4)
        eng = DeviceEngine(CheckConfig(bounds=b, spec="full", invariants=(),
                                       chunk=256),
                           Capacities(n_states=1 << 17), device="cpu")
        res = eng.check()
        rows = eng.carry["store"][:res.n_states:3]
        out = kernels.build_step(b, "full")(rows)
        lay = st.Layout.of(b)
        succ = st.unpack(out["svecs"], lay)
        par = st.unpack(rows[:, None, :], lay)
        fams = [a.family for a in SP.action_table(b, "full")]
        for fam in set(fams):
            lanes = torch.tensor([f == fam for f in fams])
            val = out["valid"] & lanes
            written = {f for f in lay.fields
                       if ((succ[f] != par[f]).reshape(val.shape + (-1,))
                           .any(-1) & val).any()}
            assert written <= set(kernels.TRANSFER_WRITES[fam]) \
                | set(kernels.POSTLUDE_WRITES), (fam, faithful)
            assert written, fam


def test_no_lint_and_strict_run(tmp_path):
    cfg = write_cfg(tmp_path / "m.cfg")
    for flags in (["--no-lint"], ["--lint", "strict"], ["--lint", "warn"]):
        code, out, err = _run(cli.main, [cfg, "--device", "cpu", "--engine",
                                         "ref", *ELECTION_2S, *flags])
        jcode, jout, jerr = _run(jcli.main, [cfg, "--engine", "ref",
                                             *ELECTION_2S, *flags])
        assert code == jcode == 0, (flags, err, jerr)
        assert "speclint" not in err and "speclint" not in jerr
        assert "3014 distinct states found" in out


def test_a_finding_makes_strict_fail_in_both_packages(tmp_path,
                                                      monkeypatch):
    cfg = write_cfg(tmp_path / "m.cfg")
    finding = ("width", "error", "width-overflow", "planted", "Timeout",
               "term", (1, 5), 3, None, None)
    monkeypatch.setattr(wc, "check_widths",
                        lambda *a, **k: [report.Finding(*finding)])
    monkeypatch.setattr(jwc, "check_widths",
                        lambda *a, **k: [jreport.Finding(*finding)])
    for mode, want in (("strict", 1), ("warn", 0)):
        code, out, err = _run(cli.main, [cfg, "--device", "cpu", "--engine",
                                         "ref", *ELECTION_2S, "--lint", mode])
        jcode, jout, jerr = _run(jcli.main, [cfg, "--engine", "ref",
                                             *ELECTION_2S, "--lint", mode])
        assert code == jcode == want
        lines = err.splitlines()
        assert lines[:3] == jerr.splitlines()[:3] == [
            "speclint (width pass):",
            "error[width-overflow]: planted (transition=Timeout, "
            "field=term, interval=[1, 5], width=3)",
            "1 error(s), 0 warning(s)"]
        assert ("distinct states found" in out) == (mode == "warn")

    def crash(*a, **k):
        raise KeyError("boom")

    monkeypatch.setattr(wc, "check_widths", crash)
    code, _, err = _run(cli.main, [cfg, "--device", "cpu", "--engine", "ref",
                                   *ELECTION_2S, "--lint", "strict"])
    assert code == 1
    assert "error[lint-internal-error]: width pass crashed: " \
           "KeyError('boom')" in err


def test_intervals_match_jax():
    for kw in (dict(), dict(history=True), dict(n_servers=5, history=True)):
        b, jb = Bounds(**kw), JBounds(**kw)
        for fn, jfn in ((iv.envelope, jiv.envelope),
                        (iv.expansion_envelope, jiv.expansion_envelope),
                        (iv.init_env, jiv.init_env)):
            got = {k: v.as_tuple() for k, v in fn(b).items()}
            want = {k: v.as_tuple() for k, v in jfn(jb).items()}
            assert got == want, (kw, fn.__name__)
