"""Run the repository's two large liveness checks through the port.

    python3 tools/liveness_run.py [--out build/liveness_run.out]

1. ``runs/liveness_4s.out``: the 4-server election (t2 l0 m1) under
   SYMMETRY Server (|G| = 24), the reference's largest whole liveness
   check.  One DDD graph export (models/liveness.ddd_graph: the DDD engine's
   host store re-expanded by K1), then all six verdicts of that file.
2. ``runs/liveness_2m.out``: the raw 3-server election (t2 l0 m2), one DDD
   graph export without symmetry, then its three verdicts.

Each graph's orbits and edges, and each verdict's ``holds`` and
``n_sccs_checked``, must equal the file's line.  One JSON line per graph and
per verdict goes to stdout and to ``--out``, with the walls (graph build,
verdict; the graph's split into the DDD search, the key log's sort and the
K1 re-expansion), the K1 launches of each export and the peak host RSS;
then the card's name and power limit.  Exits non-zero on any difference.
Runs on the card only; imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import resource
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

CHUNK = 8192
# (reference file, Bounds keywords, SYMMETRY axes)
CASES = (
    ("liveness_4s.out", dict(n_servers=4, n_values=1, max_term=2, max_log=0,
                             max_msgs=1), ("Server",)),
    ("liveness_2m.out", dict(n_servers=3, n_values=1, max_term=2, max_log=0,
                             max_msgs=2), ()),
)


def rss_gib() -> float:
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20


def run_case(name, kw, axes, emit) -> bool:
    import torch

    from raft_tla_tpu_torch.config import Bounds, CheckConfig
    from raft_tla_tpu_torch.ddd_engine import DDDCapacities
    from raft_tla_tpu_torch.models import liveness
    from raft_tla_tpu_torch.models import spec as S
    from raft_tla_tpu_torch.ops import pallas_step

    lines = [json.loads(ln) for ln in (ROOT / "runs" / name).read_text()
             .splitlines()]
    graph_ref, verdicts = lines[0], lines[1:]
    cfg = CheckConfig(bounds=Bounds(**kw), spec="election", invariants=(),
                      symmetry=axes, chunk=CHUNK)
    A = len(S.action_table(cfg.bounds, cfg.spec))
    n_ref = graph_ref.get("orbits", graph_ref.get("n_states"))
    e_ref = graph_ref.get("edges", graph_ref.get("n_edges"))
    caps = DDDCapacities(
        block=1 << 20, table=1 << max(10, min(26, (2 * n_ref).bit_length())),
        seg_rows=max(1 << 19, 2 * CHUNK * A), levels=256)
    pallas_step.launches = 0
    stages = {}
    t0 = time.monotonic()
    graph = liveness.ddd_graph(cfg, caps, stats=stages)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    n, n_edges = len(graph[0]), graph[1].n_edges
    ok = (n, n_edges) == (n_ref, e_ref)
    emit({"file": name, "phase": "graph", "orbits": n, "edges": n_edges,
          "wall_s": round(wall, 2),
          **{k: round(v, 2) for k, v in stages.items()},
          "k1_launches": pallas_step.launches,
          "reexpansion_launches": -(-n // CHUNK),
          "reference_wall_s": graph_ref["wall_s"], "equal": ok,
          "peak_rss_gib": round(rss_gib(), 2)})
    try:
        for ref in verdicts:
            t1 = time.monotonic()
            r = liveness.check(cfg, ref["prop"], wf=tuple(ref["wf"]),
                               graph=graph)
            same = (r.holds, r.n_states, r.n_edges, r.n_sccs_checked) == (
                ref["holds"], ref["n_states"], ref["n_edges"],
                ref["n_sccs_checked"])
            ok &= same
            emit({"file": name, "prop": ref["prop"], "wf": ref["wf"],
                  "holds": r.holds, "n_states": r.n_states,
                  "n_edges": r.n_edges, "n_sccs_checked": r.n_sccs_checked,
                  "wall_s": round(time.monotonic() - t1, 2),
                  "reference_wall_s": ref["wall_s"], "equal": same})
    finally:
        graph[0].close()
    return ok


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", type=Path, default=None,
                   help="also append the JSON lines here")
    args = p.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("liveness_run: no CUDA device visible to torch",
              file=sys.stderr)
        return 2
    sink = None
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        sink = args.out.open("a")

    def emit(d):
        line = json.dumps(d)
        print(line, flush=True)
        if sink:
            sink.write(line + "\n")
            sink.flush()

    ok = True
    for name, kw, axes in CASES:
        ok &= run_case(name, kw, axes, emit)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip())
    print("liveness_run: " + ("every count and verdict equal to runs/"
                              if ok else "DIFFERS from runs/")
          + "liveness_4s.out and runs/liveness_2m.out")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
