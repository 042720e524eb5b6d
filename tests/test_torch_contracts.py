"""Pass 5 of the port (``raft_tla_tpu_torch/analysis/contracts.py``)
against the reference's contract lint: the reference's planted gate,
obs-schema and waiver breaks, fed as the same ``Inputs`` to both (the
port's sources under ``raft_tla_tpu_torch/``, the reference's under
``raft_tla_tpu/``, each package's default schema and digest paths and
analysis exclusion), give the same findings with the paths mapped; a
``jit-ok`` waiver on a host sync is live and goes stale (an error) once
the sync is gone; the repaired gates each have one resolver; and the
port's tree is clean under ``--strict``.  Tolerance: exact equality of
every finding field after mapping the package prefix; the message of
``gate-no-smoke`` names each package's own smoke leg and is left out.
"""

import dataclasses
import io
from contextlib import redirect_stdout

import pytest

from raft_tla_tpu.analysis import contracts as jcontracts

from raft_tla_tpu_torch.analysis import contracts, threadlint
from raft_tla_tpu_torch.config import Bounds
from raft_tla_tpu_torch.lint import main as lint_main
from raft_tla_tpu_torch.ops import kernels

from test_contracts import (DIGEST_MOD, EMIT_MOD, GATE_MOD, LINT_SH, README,
                            SCHEMA_MOD)

# An analysis module talks about gates and events without producing them:
# both packages leave their own analysis/ out of the gate and obs
# contracts.
ANALYSIS_MOD = '''
"""Mentions RAFT_TLA_FROBLE once, and emits a finding, not an event."""

def check(self):
    self._emit("bogus-event", x=1)
'''

NO_FLAG = GATE_MOD.replace(
    '''def add_args(p):
    p.add_argument("--frobble", choices=("auto", "on", "off"),
                   help="sets RAFT_TLA_FROBBLE for the whole run")
''', "")
NO_RESOLVER = GATE_MOD.replace(
    "    return explicit or os.environ.get(ENV_FROBBLE) or None",
    "    return explicit")
EXTRA_READ = '''
import os

def sneaky_read():
    return os.environ.get("RAFT_TLA_FROBBLE")
'''
TYPO = '''
import os

def oops():
    return os.environ.get("RAFT_TLA_FROBLE")
'''
IN_DIGEST = DIGEST_MOD.replace(
    "    blob = repr((config, caps, init_key)).encode()",
    '    tag = "RAFT_TLA_FROBBLE"\n'
    "    blob = repr((config, caps, init_key, tag)).encode()")
OBS = EMIT_MOD + '''
def more(tel, path, append_event, fields):
    tel.emit("segment", states=3, wall_s=0.5, queue_depth=2)
    append_event(path, "warp-start", x=1)
    tel.emit("segment", **fields)
'''
WAIVERS = '''
"""Documents the `# lint: jit-ok` syntax."""
import threading

class W:
    def __init__(self):
        self.flag = False
        t = threading.Thread(target=self.run, daemon=True)
        t.start()

    def run(self):
        self.flag = True  # lint: thread-ok benign one-way latch

    def done(self):
        y = 2  # lint: thread-ok nothing races here
        z = 3  # lint: jit-ok long gone
        w = 4  # lint: threads-ok typo'd kind
        return self.flag
'''

BREAKS = {
    "clean": ({}, {}),
    "no-flag-smoke-readme": ({"gates.py": NO_FLAG},
                             {"readme": "", "lint_sh": ""}),
    "no-resolver": ({"gates.py": NO_RESOLVER}, {}),
    "resolvers-typo-digest": ({"extra.py": EXTRA_READ, "typo.py": TYPO,
                               "utils/ckpt.py": IN_DIGEST}, {}),
    "obs-schema": ({"emit.py": OBS}, {}),
    "waivers": ({"w.py": WAIVERS}, {}),
}


def _inputs(mod, pkg, edits, extra):
    base = {"gates.py": GATE_MOD, "emit.py": EMIT_MOD,
            "obs/events.py": SCHEMA_MOD, "utils/ckpt.py": DIGEST_MOD,
            "analysis/talk.py": ANALYSIS_MOD}
    base.update(edits)
    kw = {"readme": README, "lint_sh": LINT_SH}
    kw.update(extra)
    return mod.Inputs(sources={f"{pkg}/{p}": s for p, s in base.items()},
                      **kw)


def _norm(findings, pkg):
    out = []
    for f in findings:
        t = dataclasses.astuple(f)
        t = tuple(x.replace(pkg + "/", "PKG/") if isinstance(x, str) else x
                  for x in t)
        if f.code == "gate-no-smoke":
            t = t[:3] + (None,) + t[4:]
        out.append(t)
    return out


@pytest.mark.parametrize("case", list(BREAKS))
def test_same_inputs_same_findings(case):
    edits, extra = BREAKS[case]
    mine = contracts.lint_inputs(
        _inputs(contracts, "raft_tla_tpu_torch", edits, extra))
    ref = jcontracts.lint_inputs(
        _inputs(jcontracts, "raft_tla_tpu", edits, extra))
    assert _norm(mine, "raft_tla_tpu_torch") == _norm(ref, "raft_tla_tpu")
    codes = sorted(f.code for f in mine)
    assert codes == {
        "clean": [],
        "no-flag-smoke-readme": ["gate-no-cli-flag", "gate-no-readme",
                                 "gate-no-smoke"],
        "no-resolver": ["gate-no-resolver"],
        "resolvers-typo-digest": ["gate-in-digest", "gate-multiple-resolvers",
                                  "gate-near-miss"],
        "obs-schema": ["obs-undeclared-field", "obs-unknown-event"],
        "waivers": ["stale-waiver", "stale-waiver", "waiver-unknown-kind"],
    }[case]
    if case == "no-flag-smoke-readme":
        smoke = next(f for f in mine if f.code == "gate-no-smoke")
        assert "chip_smoke.py or tools/*_run.py" in smoke.message


HOST_SYNC = '''
import torch

def run(xs, dev):
    for x in xs:
        y = torch.tensor(0, device=dev)  # lint: jit-ok hidden sync, test
    return y
'''


def test_jit_waiver_on_a_host_sync_is_live_then_stale():
    """The waiver audit relints with the port's Pass 3: a waiver on a host
    sync is live; once the sync leaves the loop it is a stale-waiver
    error (the reference's tracer lint would call both stale)."""
    def audit(src):
        return contracts.lint_inputs(_inputs(
            contracts, "raft_tla_tpu_torch", {"hot.py": src}, {}))

    assert audit(HOST_SYNC) == []
    gone = HOST_SYNC.replace("torch.tensor(0, device=dev)", "x + 1")
    [f] = audit(gone)
    assert (f.code, f.severity, f.line) == ("stale-waiver", "error", 6)
    assert f.file == "raft_tla_tpu_torch/hot.py"


def test_repaired_gates_have_one_resolver_each(monkeypatch):
    """RAFT_TLA_PRESCAN, _SIGPRUNE and _MEGAKERNEL are each read by name
    in one helper of ops/kernels, and that helper honours the value."""
    src = threadlint.package_sources()
    reads = {g: [p for p, s in src.items()
                 if f'os.environ.get("{g}"' in s]
             for g in ("RAFT_TLA_PRESCAN", "RAFT_TLA_SIGPRUNE",
                       "RAFT_TLA_MEGAKERNEL")}
    assert all(v == ["raft_tla_tpu_torch/ops/kernels.py"]
               for v in reads.values()), reads
    b = Bounds(n_servers=3, n_values=1, max_term=2, max_log=0, max_msgs=1)
    for v, want in (("on", True), ("off", False)):
        monkeypatch.setenv("RAFT_TLA_PRESCAN", v)
        assert kernels.prescan_enabled(b, ("Server",)) is want
        monkeypatch.setenv("RAFT_TLA_SIGPRUNE", v)
        assert kernels.sigprune_enabled(b, ("Server",)) is want
        monkeypatch.setenv("RAFT_TLA_MEGAKERNEL", v)
        assert kernels.megakernel_setting() == v


def test_port_tree_is_clean_under_strict():
    """Acceptance: ``python -m raft_tla_tpu_torch.lint --strict`` (passes
    1 and 3-5 over the port's tree) exits 0 with no finding."""
    out = io.StringIO()
    with redirect_stdout(out):
        code = lint_main(["--strict"])
    assert code == 0
    assert out.getvalue().splitlines() == [
        "speclint: (no cfg) mode=both spec=full", "0 error(s), 0 warning(s)"]
