"""``python -m raft_tla_tpu_torch.campaign`` == ``raft-tla-campaign-torch``."""

from raft_tla_tpu_torch.campaign.cli import entry

if __name__ == "__main__":
    entry()
