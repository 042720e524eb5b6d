"""``python -m raft_tla_tpu_torch`` — alias for ``raft_tla_tpu_torch.check``."""

import sys

from raft_tla_tpu_torch.check import main

sys.exit(main())
