"""Time the gated step variants of the port on the card.

    python3 tools/gates_run.py [--out chiprun_out/gates_run.json]
                               [--only k1|ddd|elect5]

First K1 alone (``chip_smoke.phase17a``): its full scan, prescan,
sig-prune and both on reachable rows at phase 5's layout (|G| = 6),
faithful Server x Value (|G| = 12) and elect5's layout (|G| = 120), ms a
launch beside the share of pairs the prescan skipped, the group elements
keyed a scanned pair and the probes, each held to the full scan and to
its plain version; and its occupancy per variant.  Then, in-process
through the CLI (``chip_smoke.drive``), in turns:

- the flagship through the DDD engine (``chip_smoke.py`` phase 9:
  ``runs/MC3s2v.cfg`` t2 l1 m2, SYMMETRY Server, chunk 8,192): dense, with
  ``--route K`` (K = half a chunk's lanes), with ``--device-dedup hash``
  and with ``--device-dedup sort``, then the same four in the reverse
  order.  Each run must give phase 5's counts.  Per run: the wall, orbits/s, the step's and the
  filter's milliseconds a chunk (CUDA events; routed, the step's includes
  the compaction), the device set's seconds, hits and exported rows, the
  bytes copied to the host, and ``route_peak``;
- elect5 (phase 12: ``runs/MC5s2v.cfg``, |G| = 120, to a 30 s deadline)
  with the prescan and sig-prune off and on (off, prescan, sig-prune,
  both, then the reverse order): the deepest completed level (each level's count held to
  ``runs/elect5ddd.stats``), orbits, orbits/s and K1's milliseconds a
  chunk.

Prints one line a run, then the card's name and power limit, and writes
every number to ``--out`` as JSON.  Needs the card; imports no JAX.
"""

from __future__ import annotations

import argparse
import io
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as c  # noqa: E402


def ddd_row(label, argv) -> dict:
    code, eng, res, _out, wall, launches = c.drive(argv, label)
    st = eng.stats
    chunks = max(1, st["chunks"])
    row = dict(label=label, code=code, n_states=res.n_states,
               diameter=res.diameter, n_transitions=res.n_transitions,
               wall=wall, rate=res.n_states / wall, chunks=st["chunks"],
               step_ms=1e3 * st["step_s"] / chunks,
               filter_ms=1e3 * st["filter_s"] / chunks,
               devdedup_s=st["devdedup_s"], hits=st["dev_dedup_hits"],
               export_rows=st["export_rows"], d2h_bytes=st["d2h_bytes"],
               route_peak=st["route_peak"], syncs=st["syncs"],
               launches=launches)
    c.say(f"{label}: exit {code}, {res.n_states} orbits, diameter "
          f"{res.diameter}, {res.n_transitions} transitions; wall "
          f"{wall:.2f} s, {row['rate']:,.0f} orbits/s; step "
          f"{row['step_ms']:.4f} ms/chunk, filter {row['filter_ms']:.4f} "
          f"ms/chunk over {st['chunks']} chunks; device set "
          f"{st['devdedup_s']:.2f} s, hits {row['hits']}; exported rows "
          f"{row['export_rows']}, {row['d2h_bytes']} bytes to the host; "
          f"route_peak {row['route_peak']}; host syncs {st['syncs']}")
    return row


def flagship(rows: list) -> None:
    from raft_tla_tpu_torch.config import Bounds
    from raft_tla_tpu_torch.models import spec as SP
    want = (94_396_461, 57, 258_131_266)
    A = len(SP.action_table(Bounds(3, 2, 2, 1, 2), "full"))
    K = c.MAIN_CHUNK * A // 2
    base = [str(c.FLAGSHIP_CFG), *c.FLAGSHIP_ARGS, "--engine", "ddd"]
    arms = [("dense", []), ("route", ["--route", str(K)]),
            ("hash", ["--device-dedup", "hash"]),
            ("sort", ["--device-dedup", "sort"])]
    for label, extra in arms + arms[::-1]:
        row = ddd_row(f"flagship DDD {label}", base + extra)
        rows.append(row)
        if (row["n_states"], row["diameter"], row["n_transitions"]) != want:
            c.fail(f"flagship DDD {label}: counts differ from {want}")


def elect5(rows: list) -> None:
    arms = [("off", "off", "off"), ("prescan", "on", "off"),
            ("sig-prune", "off", "on"), ("both", "on", "on")]
    for label, pre, sp in arms + arms[::-1]:
        err = io.StringIO()
        argv = [str(c.ELECT5_CFG), *c.ELECT5_ARGS, "--deadline",
                str(c.ELECT5_DEADLINE), "--prescan", pre, "--sig-prune", sp]
        code, eng, res, _out, wall, launches = c.drive(argv, label, err)
        lines = [json.loads(ln) for ln in err.getvalue().splitlines()
                 if ln.startswith("{")]
        ends = {d["level"]: d["n_states"] for d in lines}
        done = [lv for lv in sorted(ends) if lv + 1 in ends]
        bad = [lv for lv in done if ends[lv] != c.ELECT5_LEVEL_ENDS.get(lv)]
        st = eng.stats
        chunks = max(1, st["chunks"])
        row = dict(label=f"elect5 {label}", code=code,
                   n_states=res.n_states, level=done[-1] if done else 0,
                   wall=wall, rate=res.n_states / wall, chunks=st["chunks"],
                   step_ms=1e3 * st["step_s"] / chunks, launches=launches)
        c.say(f"elect5 {label} (--prescan {pre} --sig-prune {sp}): exit "
              f"{code}, {res.n_states} orbits, level {row['level']} "
              f"completed, every level equal to the JAX campaign: "
              f"{not bad}; wall {wall:.2f} s, {row['rate']:,.0f} orbits/s; "
              f"K1 {row['step_ms']:.4f} ms/chunk over {st['chunks']} chunks;"
              f" K1 launches by variant {launches['step_by_variant']}")
        rows.append(row)
        if bad or code not in (0, 14):
            c.fail(f"elect5 {label}: levels {bad} differ")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=str(ROOT / "chiprun_out"
                                         / "gates_run.json"))
    ap.add_argument("--only", choices=("k1", "ddd", "elect5"))
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("gates_run: needs a CUDA device", file=sys.stderr)
        return 2
    rows, k1 = [], {}
    t0 = time.monotonic()
    if args.only in (None, "k1"):
        c.phase17a(k1)
    if args.only in (None, "ddd"):
        flagship(rows)
    if args.only in (None, "elect5"):
        elect5(rows)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    c.say(f"{card}; {time.monotonic() - t0:.1f} s")
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(
        {"card": card, "k1": k1, "runs": rows}, indent=1, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
