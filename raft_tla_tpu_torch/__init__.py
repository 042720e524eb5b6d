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
-> verdict, trace and TLC exit code.  Two hand-written Hopper kernels carry
it:

- ``csrc/step.cu`` — the fused frontier step with its history stage and
  its dedup-key stage (view, orbit-minimal fingerprint)
  (``ops/pallas_step.py``);
- ``csrc/fingerprint.cu`` — the two-lane fingerprint (``ops/pallas_fp.py``).

Each has a plain PyTorch version beside it; a wrapper runs the plain version
only for tensors that lie on the CPU.  Entry points run on ``cuda`` unless
the caller passes ``device="cpu"``.
"""

from raft_tla_tpu_torch.config import Bounds, CheckConfig

__version__ = "0.1.0"

__all__ = ["Bounds", "CheckConfig", "__version__"]
