"""raft_tla_tpu_torch — the PyTorch/CUDA port of the Raft TLA+ checker.

A second package beside ``raft_tla_tpu`` (the JAX reference, which stays
unchanged).  The port imports ``torch`` and numpy, never ``jax`` and nothing
of ``raft_tla_tpu``: where it needs one of the reference's host modules it
keeps its own copy, under the same module name, so each counterpart is easy
to find.

The port covers the reference's main path, ``python -m raft_tla_tpu.check``
with the device engine, in parity and faithful mode (``--faithful``: the
history variables as state), with SYMMETRY (Server, Value) and the
registered VIEWs: cfg -> :class:`CheckConfig` -> a BFS resident on the GPU
-> verdict, trace and TLC exit code; the DDD engine (``--engine ddd``,
``ddd_engine.py``), whose exact dedup runs on the host (``utils/keyset``,
``utils/native``) while the card expands and filters; the host engine
(``--engine host``, ``engine.py``) and the oracle (``--engine ref``,
``models/refbfs.py``); registry and expression invariants
(``frontend/predicate.py``); the TLC twin (``--emit-tlc``,
``models/tla_export.py``); simulation (``simulate.py``, ``fleet/``); and
the spec frontend (``frontend/``): two-phase commit (``--spec twophase``)
and the IR-compiled Raft specs, compiled from the action IR into torch ops
whose rows K2 keys on the card.  Two hand-written Hopper kernels carry the
engines:

- ``csrc/step.cu`` — the fused frontier step with its history stage, its
  dedup-key stage (view, orbit-minimal fingerprint) and its expression
  stage (``ops/predprog.py``) (``ops/pallas_step.py``);
- ``csrc/fingerprint.cu`` — the two-lane fingerprint (``ops/pallas_fp.py``).

Each has a plain PyTorch version beside it; a wrapper runs the plain version
only for tensors that lie on the CPU.  Entry points run on ``cuda`` unless
the caller passes ``device="cpu"``.
"""

from raft_tla_tpu_torch.config import Bounds, CheckConfig

__version__ = "0.1.0"

__all__ = ["Bounds", "CheckConfig", "__version__"]
