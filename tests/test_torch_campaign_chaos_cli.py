"""``python -m raft_tla_tpu_torch.campaign.chaos``: the reference's
``--mesh-plan`` and ``--cpu`` flags (``raft_tla_tpu/campaign/chaos.py:191-194``).

``--cpu`` is refused with its spelling here, ``--device cpu``, as in the
port's other CLIs; ``--mesh-plan 1`` is accepted and reaches the
supervisor; a plan above one card is refused naming ROADMAP.md item 11 (b),
as the supervisor's own refusal does.
"""

import io
from contextlib import redirect_stderr

import pytest

from raft_tla_tpu_torch.campaign import chaos

ARGS = ["toy.cfg", "--workdir", "w", "--spec", "election", "--device", "cpu"]


def _refusal(argv) -> str:
    err = io.StringIO()
    with pytest.raises(SystemExit) as e, redirect_stderr(err):
        chaos.main(argv)
    assert e.value.code == 2
    return err.getvalue()


def test_cpu_is_spelled_device_cpu():
    assert "--cpu is spelled --device cpu in raft_tla_tpu_torch" in \
        _refusal([*ARGS, "--cpu"])


def test_mesh_plan_of_one_card_is_accepted(monkeypatch):
    """The smoke gets past its flags to the uninterrupted reference run
    (stopped there by a stand-in) with the plan of one card."""
    reached = {}

    class Reached(Exception):
        pass

    def fake_reference(spec, workdir):
        reached["spec"] = spec
        raise Reached

    monkeypatch.setattr(chaos, "run_reference", fake_reference)
    with pytest.raises(Reached):
        chaos.main([*ARGS, "--mesh-plan", "1"])
    assert reached["spec"].cpu


@pytest.mark.parametrize("plan", ["2", "1,2,1"])
def test_larger_mesh_plan_names_item_11b(plan):
    msg = _refusal([*ARGS, "--mesh-plan", plan])
    assert f"--mesh-plan {plan}" in msg and "item 11 (b)" in msg
