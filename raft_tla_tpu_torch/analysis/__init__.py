"""Static analysis — the port's copy of the reference's width-safety pass
(Pass 1 of ``raft_tla_tpu/analysis``).

Every transition writes values that must fit the per-field bit widths
``ops/bitpack.field_bits`` derives from the bounds; one overflowing write is
silently truncated by the pack, collides fingerprints and turns a passing
check into a false negative.  :mod:`.widthcheck` proves width-safety per
transition by interval abstract interpretation (:mod:`.intervals`) and
cross-checks its transfer twins against the port's own kernel tables
(``ops/kernels.TRANSFER_WRITES``, ``ops/pallas_step.FUSED_WRITES``,
``ops/msgbits``, ``ops/bitpack``), so drift between the CUDA layout and the
analyzer surfaces as a finding.  The CLI runs it before every build
(``--lint warn|strict``, ``--no-lint``); findings are :mod:`.report`'s.
"""
