"""``python -m raft_tla_tpu_torch.lint`` — the port's speclint analyzer.

Thin alias for :mod:`raft_tla_tpu_torch.analysis.__main__` (the short
spelling; also the ``raft-tla-lint-torch`` console script).  See that
module for the pass descriptions and exit-code policy.
"""

from __future__ import annotations

import sys

from raft_tla_tpu_torch.analysis.__main__ import build_argparser, main, run_lint

__all__ = ["build_argparser", "main", "run_lint", "entry"]


def entry() -> None:
    """Console-script entry point (pyproject: raft-tla-lint-torch)."""
    sys.exit(main())


if __name__ == "__main__":
    sys.exit(main())
