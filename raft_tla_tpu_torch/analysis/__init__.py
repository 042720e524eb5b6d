"""Static analysis — the port's copy of the reference's five-pass analyzer
(``raft_tla_tpu/analysis``), run over the port's own tables and tree.

- **Pass 1** (:mod:`.widthcheck`): every transition writes values that
  must fit the per-field bit widths ``ops/bitpack.field_bits`` derives from
  the bounds; one overflowing write is silently truncated by the pack,
  collides fingerprints and turns a passing check into a false negative.
  The pass proves width-safety per transition by interval abstract
  interpretation (:mod:`.intervals`) and cross-checks its transfer twins
  against the port's own kernel tables (``ops/kernels.TRANSFER_WRITES``,
  ``ops/pallas_step.FUSED_WRITES``, ``ops/msgbits``, ``ops/bitpack``), so
  drift between the CUDA layout and the analyzer surfaces as a finding.
- **Pass 2** (:mod:`.cfglint`): the cfg against the registries (unknown
  names with did-you-mean, constants against the bounds, vacuous
  invariants, view and symmetry compatibility).
- **Pass 3** (:mod:`.jitlint`): host syncs in the port's sources (Python
  control flow on a tensor's elements, scalar casts, copies to and from
  the card in loops), set iteration and unjustified narrowing.
- **Pass 4** (:mod:`.threadlint`): unguarded state shared across the
  port's thread entry points.
- **Pass 5** (:mod:`.contracts`): the ``RAFT_TLA_*`` gates, the obs schema
  against its emission sites, and stale waivers.

Entry points: ``python -m raft_tla_tpu_torch.lint`` (all five; also
``python -m raft_tla_tpu_torch.analysis``), ``check.py --lint warn|strict``
and ``--no-lint`` (Pass 1 before every build), and admission
(``serve/jobs.admit``: Passes 1 and 2).  Findings are :mod:`.report`'s.
"""
