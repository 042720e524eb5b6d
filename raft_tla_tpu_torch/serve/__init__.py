"""serve/ — the job model and its admission gate (``jobs``), which the
campaign supervisor runs before it spawns a child.  The rest of the
reference's ``serve/`` is ROADMAP.md queue A item 12."""
