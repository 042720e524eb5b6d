"""Run the 5-server election campaign through the port's DDD engine.

    python3 tools/elect5_run.py --deadline 1500 [--resume]

Runs ``python -m raft_tla_tpu_torch.check runs/MC5s2v.cfg --spec election
--max-term 2 --max-log 0 --max-msgs 2 --engine ddd --retention frontier
--chunk 4096 --stats`` in-process, with ``--checkpoint`` (a snapshot every
``--every`` seconds and at the deadline) and ``--deadline``, on the card.
The stats lines are appended to ``--out`` as they come.  At the end it
prints, for every completed BFS level: the cumulative orbit count,
whether it equals the last line of that level in
``runs/elect5ddd.stats`` (the JAX package's campaign; levels past its
last complete one have no reference), the orbits/s over the level, and
the peak host RSS at the level's end; then the deepest level, the card's
name and power limit.
Exits non-zero if a level differs.  Imports no JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import resource
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

CFG = ROOT / "runs" / "MC5s2v.cfg"
ARGS = ["--spec", "election", "--max-term", "2", "--max-log", "0",
        "--max-msgs", "2", "--engine", "ddd", "--retention", "frontier",
        "--chunk", "4096", "--stats"]
REFERENCE = ROOT / "runs" / "elect5ddd.stats"


def level_ends(lines) -> dict:
    """level -> (cumulative orbits, wall_s) of the last line of each level
    that a later level follows (a completed level)."""
    last = {}
    for d in lines:
        last[d["level"]] = (d["n_states"], d["wall_s"])
    return {lv: v for lv, v in last.items() if lv + 1 in last}


class StatsSink(io.TextIOBase):
    """stderr stand-in: stats lines to a file (flushed), with the peak host
    RSS sampled at each; everything else passed through."""

    def __init__(self, path: Path):
        self.f = path.open("a", buffering=1)
        self.lines, self.rss = [], {}
        self._buf = ""

    def write(self, s: str) -> int:
        self._buf += s
        while "\n" in self._buf:
            ln, self._buf = self._buf.split("\n", 1)
            if ln.startswith("{"):
                d = json.loads(ln)
                self.lines.append(d)
                self.rss[d["level"]] = resource.getrusage(
                    resource.RUSAGE_SELF).ru_maxrss / 2**20
                self.f.write(ln + "\n")
            else:
                sys.__stderr__.write(ln + "\n")
        return len(s)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--deadline", type=float, required=True)
    ap.add_argument("--every", type=float, default=600.0,
                    help="seconds between snapshots")
    ap.add_argument("--checkpoint", default=str(ROOT / "build" / "elect5"
                                                / "elect5.ckpt"))
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--out", default=str(ROOT / "build" / "elect5"
                                         / "elect5.stats"),
                    help="stats lines, appended as they come")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("elect5_run: no CUDA device visible to torch", file=sys.stderr)
        return 2
    from raft_tla_tpu_torch import check
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    Path(args.checkpoint).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    argv = [str(CFG), *ARGS, "--deadline", str(args.deadline),
            "--checkpoint", args.checkpoint, "--checkpoint-every",
            str(args.every)]
    if args.resume:
        argv += ["--resume", args.checkpoint]
    sink = StatsSink(Path(args.out))
    t0 = time.monotonic()
    with contextlib.redirect_stderr(sink):
        code, eng, res = check.run(argv)
    wall = time.monotonic() - t0
    sink.f.close()
    ref = level_ends(json.loads(ln) for ln in REFERENCE.read_text()
                     .splitlines() if ln.startswith("{"))
    got = level_ends(sink.lines)
    bad = 0
    prev = None
    print(f"{'level':>5} {'orbits':>12} {'= JAX':>6} {'orbits/s':>10} "
          f"{'RSS GiB':>8}")
    for lv in sorted(got):
        n, w = got[lv]
        same = "-" if lv not in ref else str(ref[lv][0] == n)
        bad += same == "False"
        rate = (n - prev[0]) / max(w - prev[1], 1e-9) if prev else 0.0
        print(f"{lv:>5} {n:>12} {same:>6} {rate:>10.0f} "
              f"{sink.rss.get(lv, 0.0):>8.2f}")
        prev = (n, w)
    st = eng.stats if eng is not None else {}
    print(f"exit {code}; {res.n_states if res else None} orbits, deepest "
          f"completed level {max(got) if got else 0}, wall {wall:.1f} s; "
          f"chunks {st.get('chunks')}, host flush {st.get('flush_s', 0):.1f}"
          f" s; peak host RSS "
          f"{resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20:.2f}"
          f" GiB; on {card}")
    return 1 if bad or code not in (0, 14) else 0


if __name__ == "__main__":
    sys.exit(main())
