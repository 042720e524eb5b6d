"""The port's paged engine (on the CPU) against the JAX ``PagedEngine``.

``PagedEngine(device="cpu")`` runs the plain torch step.  Rings small
enough to wrap many times force every path of the ring: frontier reads
after a wrap, the pause before an overwrite, the pageout to the host store
and traces rebuilt from it.  Exact equality of states, diameter, levels,
transitions, coverage and the first violation with the JAX engine (one JAX
run a universe, shared through a module fixture) and the pure-Python
oracle; the port's ``DeviceEngine`` discovers in the same order; an
undersized ring fails as the reference fails.
"""

import numpy as np
import pytest
import torch

from raft_tla_tpu import device_engine as jdev
from raft_tla_tpu import paged_engine as jpaged
from raft_tla_tpu.config import Bounds as JBounds, CheckConfig as JConfig
from raft_tla_tpu.models import interp as jinterp, refbfs
from raft_tla_tpu.ops import msgbits as jmb

from raft_tla_tpu_torch.config import Bounds, CheckConfig
from raft_tla_tpu_torch.device_engine import Capacities, DeviceEngine
from raft_tla_tpu_torch.models import interp, spec as SP
from raft_tla_tpu_torch.ops import msgbits as mb
from raft_tla_tpu_torch.paged_engine import PagedCapacities, PagedEngine

torch.set_num_threads(1)

ELECTION = dict(n_servers=2, n_values=1, max_term=2, max_log=0, max_msgs=2)
FULL = dict(n_servers=2, n_values=1, max_term=2, max_log=1, max_msgs=2)
FULL_INVS = ("NoTwoLeaders", "LogMatching", "CommittedWithinLog")
# (bounds, spec, invariants, chunk, ring): 3014 states through a 2,048-row
# ring, and 48,041 through 16,384 rows (widest level pair 8,122)
UNIVERSES = {
    "election": (ELECTION, "election", ("NoTwoLeaders",), 16, 2048),
    "full": (FULL, "full", FULL_INVS, 256, 16384),
}


def _configs(kw, spec, invs, chunk, **more):
    return (CheckConfig(bounds=Bounds(**kw), spec=spec, invariants=invs,
                        chunk=chunk, **more),
            JConfig(bounds=JBounds(**kw), spec=spec, invariants=invs,
                    chunk=chunk, **more))


def _same(got, want):
    assert (got.n_states, got.diameter, got.levels, got.n_transitions) == \
        (want.n_states, want.diameter, want.levels, want.n_transitions)
    assert dict(got.coverage) == dict(want.coverage)
    assert (got.violation is None) == (want.violation is None)


@pytest.fixture(scope="module")
def jax_runs():
    """The JAX PagedEngine on both universes, with the same rings: each
    engine (one build) and its uninterrupted run."""
    out = {}
    for name, (kw, spec, invs, chunk, ring) in UNIVERSES.items():
        jcfg = _configs(kw, spec, invs, chunk)[1]
        eng = jpaged.PagedEngine(jcfg, jpaged.PagedCapacities(
            ring=ring, table=1 << 17, levels=64))
        out[name] = (eng, eng.check())
    return out


@pytest.mark.parametrize("name", sorted(UNIVERSES))
def test_ring_wraps_and_matches_the_jax_engine(name, jax_runs):
    kw, spec, invs, chunk, ring = UNIVERSES[name]
    cfg, jcfg = _configs(kw, spec, invs, chunk)
    eng = PagedEngine(cfg, PagedCapacities(ring=ring, table=1 << 17,
                                           levels=64), device="cpu")
    got = eng.check()
    _same(got, jax_runs[name][1])
    if name == "election":
        _same(got, refbfs.check(jcfg))
    assert got.violation is None and got.complete
    assert got.n_states > ring              # the ring wrapped
    if name == "full":
        for fam in (SP.RESTART, SP.DUPLICATE, SP.DROP):
            assert got.coverage[fam] > 0


def _port_state(s):
    return interp.PyState(**{f: getattr(s, f)
                             for f in interp.PyState.__dataclass_fields__})


def _bag(*ms):
    return tuple(sorted((m, 1) for m in ms))


SEEDED = dict(n_servers=3, n_values=1, max_term=3, max_log=0, max_msgs=4,
              max_dup=1)


def _seeded(interp_mod, msgbits, b):
    """The reference's seeded NaiveNoTwoLeaders start (3 servers)."""
    return interp_mod.init_state(b)._replace(
        role=(SP.LEADER, SP.FOLLOWER, SP.CANDIDATE), term=(2, 3, 3),
        votedFor=(1, 3, 0), vGrant=(0b011, 0, 0b100),
        msgs=_bag(msgbits.rv_response(3, 1, 1, 2)))


def test_trace_from_the_host_store_in_the_device_engine_order():
    """The violation's trace is rebuilt from the host store alone, replays
    through the interpreter, matches the oracle's, and its labels are the
    port's DeviceEngine's (the same discovery order)."""
    cfg, jcfg = _configs(SEEDED, "election", ("NaiveNoTwoLeaders",), 32)
    b = cfg.bounds
    start = _seeded(interp, mb, b)
    got = PagedEngine(cfg, PagedCapacities(ring=4096, table=1 << 15,
                                           levels=64),
                      device="cpu").check(init_override=start)
    dev = DeviceEngine(cfg, Capacities(n_states=1 << 15, levels=64),
                       device="cpu").check(init_override=start)
    ref = refbfs.check(jcfg, init_override=_seeded(jinterp, jmb,
                                                   jcfg.bounds))
    v = got.violation
    assert v is not None and v.invariant == "NaiveNoTwoLeaders"
    assert v.state == _port_state(ref.violation.state)
    assert [lab for lab, _ in v.trace] == \
        [lab for lab, _ in ref.violation.trace]
    assert [lab for lab, _ in v.trace] == [lab for lab, _ in dev.violation.trace]
    assert v.trace == dev.violation.trace
    assert v.trace[0] == (None, start)
    for (_l, prev), (_label, cur) in zip(v.trace, v.trace[1:]):
        assert cur in [t for _i, t in interp.successors(prev, b,
                                                       spec="election")]


def test_ring_too_small_for_the_window_fails_as_the_reference():
    # the 3-server election's live window outgrows a 1,024-row ring fast
    kw = dict(n_servers=3, n_values=1, max_term=2, max_log=0, max_msgs=1)
    cfg, _ = _configs(kw, "election", (), 16)
    caps = PagedCapacities(ring=1024, table=1 << 19, levels=64)
    with pytest.raises(RuntimeError) as e:
        PagedEngine(cfg, caps, device="cpu").check()
    jcaps = jpaged.PagedCapacities(ring=1024, table=1 << 19, levels=64)
    assert str(e.value) == (
        f"paged search aborted: {jdev.decode_fail(jdev.FAIL_RING)} "
        f"(caps={jcaps}) — grow PagedCapacities and rerun")


def test_ring_must_cover_the_chunk_fanout():
    cfg, jcfg = _configs(ELECTION, "election", (), 1024)
    with pytest.raises(ValueError) as want:
        jpaged.PagedEngine(jcfg, jpaged.PagedCapacities(ring=2048,
                                                        table=1 << 13))
    with pytest.raises(ValueError) as got:
        PagedEngine(cfg, PagedCapacities(ring=2048, table=1 << 13),
                    device="cpu")
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="powers of two"):
        PagedCapacities(ring=3000)


def test_checkpoints_cross_between_the_packages(tmp_path, jax_runs):
    """A snapshot the port writes after its first segment (then a deadline
    stops it) resumes to the uninterrupted counts in the port and in the
    JAX engine: the reference's c0..c16, ``paged`` and streams."""
    kw, spec, invs, chunk, ring = UNIVERSES["election"]
    cfg, _ = _configs(kw, spec, invs, chunk)
    caps = PagedCapacities(ring=ring, table=1 << 17, levels=64)
    jeng, straight = jax_runs["election"]
    ck = str(tmp_path / "paged.ckpt")
    eng = PagedEngine(cfg, caps, seg_chunks=16, device="cpu")
    part = eng.check(checkpoint=ck, checkpoint_every_s=0.0, deadline_s=0.0)
    assert not part.complete and 1 < part.n_states < 3014
    with np.load(ck) as z:
        assert z["c0"].shape == (ring, eng.schema.P)
        assert 1 < int(z["paged"]) <= part.n_states
    _same(PagedEngine(cfg, caps, device="cpu").check(resume=ck), straight)
    _same(jeng.check(resume=ck), straight)


def test_deadline_progress_records_and_events(tmp_path):
    """``deadline_s`` stops the search after the first segment with
    ``complete=False``; each segment's progress record carries the live
    coverage (every state but Init credited), and every line of the
    run-event log passes both packages' schema."""
    import json
    from raft_tla_tpu.obs.events import validate_event as jvalidate
    from raft_tla_tpu_torch.obs.events import validate_event
    kw, spec, invs, chunk, ring = UNIVERSES["election"]
    cfg, _ = _configs(kw, spec, invs, chunk)
    eng = PagedEngine(cfg, PagedCapacities(ring=ring, table=1 << 17,
                                           levels=64), seg_chunks=4,
                      device="cpu")
    eng.SEG_MAX = 4                     # many tiny segments
    stats, path = [], tmp_path / "run.events"
    part = eng.check(deadline_s=0.0, on_progress=stats.append,
                     events=str(path))
    assert not part.complete and 0 < part.n_states < 3014
    cov = stats[-1]["coverage"]
    assert sum(cov.values()) == stats[-1]["n_states"] - 1 and "Timeout" in cov
    events = [json.loads(ln) for ln in path.read_text().splitlines()]
    assert events[0]["event"] == "run_start" and \
        events[0]["engine"] == "paged"
    assert events[-1]["event"] == "run_end"
    assert all(validate_event(e) == [] == jvalidate(e) for e in events)
