"""Pass 4 of the port (``raft_tla_tpu_torch/analysis/threadlint.py``)
against the reference's race detector: the reference's planted races and
their disciplined twins give equal findings from both analyzers; the
port's own thread seams are modeled (every spawn site and module-global
lock of the port is on the result) and clean; and mutations of those
seams are caught.  Tolerance: exact equality of every finding field.
"""

import dataclasses
import os
import re
from pathlib import Path

import pytest

from raft_tla_tpu.analysis import threadlint as jthreadlint

from raft_tla_tpu_torch.analysis import threadlint

from test_threadlint import PRE_FIX_PHASES, SAFE_WORKER

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "raft_tla_tpu_torch"

_DROPPED = SAFE_WORKER.replace(
    "        with self._lock:\n            self._closed = True",
    "        self._closed = True")
_POST_SPAWN = SAFE_WORKER.replace(
    "        self._closed = False\n        self._thread = threading.Thread",
    "        self._thread = threading.Thread").replace(
    "        self._thread.start()",
    "        self._thread.start()\n        self._closed = False")
_HANDOFF = '''
import threading, queue

class Pump:
    def __init__(self):
        self._q = queue.Queue()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        while True:
            self._q.get()

    def reset(self):
        self._q = queue.Queue()
'''
_SUBMIT = '''
import threading
from concurrent.futures import ThreadPoolExecutor

class Batcher:
    def __init__(self):
        self._pool = ThreadPoolExecutor(2)
        self._results = []

    def _job(self, x):
        self._results.append(x)

    def submit(self, x):
        self._pool.submit(self._job, x)
        n = len(self._results)
        self._results = []
        return n
'''
_NO_REASON = SAFE_WORKER.replace(
    "        with self._lock:\n            self._closed = True",
    "        self._closed = True  # lint: thread-ok")

PLANTED = {
    "dropped-lock": (_DROPPED, "unguarded-shared-mutation"),
    "post-spawn-publish": (_POST_SPAWN, "post-spawn-publish"),
    "handoff-rebound": (_HANDOFF, "handoff-rebound"),
    "executor-submit": (_SUBMIT, "unguarded-shared-mutation"),
    "waiver-no-reason": (_NO_REASON, "waiver-missing-reason"),
}


def _both(src, path="planted.py"):
    return ([dataclasses.astuple(f)
             for f in threadlint.lint_source(src, path)],
            [dataclasses.astuple(f)
             for f in jthreadlint.lint_source(src, path)])


@pytest.mark.parametrize("case", list(PLANTED))
def test_planted_races_match_reference(case):
    src, code = PLANTED[case]
    mine, ref = _both(src)
    assert mine == ref
    assert code in [f[2] for f in mine] and all(f[1] == "error"
                                                 for f in mine)


def test_disciplined_shapes_match_reference():
    """The safe worker, a waiver with its reason, the off-owner timers
    race (caught) and its fix (clean): equal in both."""
    waived = SAFE_WORKER.replace(
        "        with self._lock:\n            self._closed = True",
        "        self._closed = True  # lint: thread-ok benign one-way flag")
    assert _both(SAFE_WORKER) == _both(waived) == ([], [])
    mine, ref = _both(PRE_FIX_PHASES)
    assert mine == ref and mine


def test_port_tree_is_modeled_and_clean():
    """The pass sees every spawn site of the port (threads and executor
    submits, each resolved to its target) and the module-global locks,
    and reports nothing; the reference's analyzer over the port's sources
    agrees.  Spawn sites are found here by an independent text scan."""
    sources = threadlint.package_sources(str(ROOT))
    res = threadlint.analyze(sources)
    assert res.findings == [] and res.used_waivers == set()
    spawns = {(p, ln) for p, ln, _t in res.spawn_sites}
    scan = {(p, i + 1) for p, src in sources.items()
            if not p.startswith("raft_tla_tpu_torch/analysis/")
            for i, line in enumerate(src.splitlines())
            if re.search(r"\bThread\(|\.submit\(self\.|ex\.map\(", line)}
    assert spawns == scan and len(spawns) == 10
    targets = {t[1] for _p, _l, t in res.spawn_sites}
    assert {"ChaosMonkey._stalk", "EventLog._writer", "DedupWorker._run",
            "PartitionedMasterKeys._dedup_partition",
            "BlockPrefetcher._run", "DispatchScheduler._compile",
            "PoolChaos._stalk.<locals>.run", "MetricsServer._serve_http",
            "MetricsServer._snapshot_loop"} <= targets
    assert {("raft_tla_tpu_torch/ops/build.py", "_lock"),
            ("raft_tla_tpu_torch/utils/native.py", "_lock"),
            ("raft_tla_tpu_torch/utils/keyset.py", "_POOL_LOCK")} <= \
        set(res.global_locks)
    assert jthreadlint.analyze(sources).findings == []


def _mutated(rel, guarded, unguarded):
    src = (PKG / rel).read_text()
    assert guarded in src, f"{rel} changed shape; update the test"
    assert threadlint.lint_source(src, rel) == []
    return threadlint.lint_source(src.replace(guarded, unguarded), rel)


def test_flushq_dropped_lock_is_caught():
    """The flush worker's count published without its lock."""
    findings = _mutated(
        os.path.join("utils", "flushq.py"),
        "                with self._lock:\n"
        "                    self._done_new += n_new",
        "                self._done_new += n_new")
    assert [f.code for f in findings] == ["unguarded-shared-mutation"]
    assert "DedupWorker._done_new" in findings[0].message


def test_chaos_fired_outside_lock_is_caught():
    """A stalker thread's ``fired`` record written outside the monkey's
    lock."""
    findings = _mutated(
        os.path.join("campaign", "chaos.py"),
        "                with self._lock:\n"
        "                    self.fired.append((attempt, kind, seen))",
        "                self.fired.append((attempt, kind, seen))")
    assert any(f.code == "unguarded-shared-mutation"
               and "ChaosMonkey.fired" in f.message for f in findings)
