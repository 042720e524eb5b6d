"""``python -m raft_tla_tpu_torch.serve`` — same front as
``raft-tla-serve-torch``."""

from raft_tla_tpu_torch.serve.service import entry

entry()
