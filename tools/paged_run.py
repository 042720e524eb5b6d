"""The flagship through the port's paged and streamed engines on the card.

    python3 tools/paged_run.py [--out chiprun_out/paged_run.json]
                               [--only paged|streamed]

``runs/MC3s2v.cfg`` (3 servers, 2 values, SYMMETRY Server) at t2 l1 m2,
chunk 8,192, ``--cap 100000000``, as ``chip_smoke.py`` phase 5 runs it on
the device engine, through the CLI:

- ``--engine paged --ring 16777216``: the widest level pair of
  ``runs/flagship_r2_ddd.out`` is 5,715,242 + 5,505,117 = 11,220,359 rows,
  so 2^24 is the smallest power-of-two ring that holds it;
- ``--engine streamed`` at its default ring of 2^22, below that pair.

Each run goes in a child process of its own (so its peak host RSS is its
own), after the kernels and the host store are built here.  Each must give
94,396,461 orbits, diameter 57, 258,131,266 transitions and every level of
the file.  Per run: the wall, orbits/s, pageout and upload seconds, chunks
and K1 launches, host syncs a chunk, peak device memory, the host store's
size (computed from the state count and row width, not read from the store)
and peak host RSS.  Prints one line a run, then the card's name and
power limit, and writes every number to ``--out`` as JSON.  Needs the
card; imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as c  # noqa: E402

WANT = (94_396_461, 57, 258_131_266)
RINGS = {"paged": ["--ring", str(1 << 24)], "streamed": []}


def one(engine: str) -> dict:
    """One run in this process: its row, as JSON on the last line."""
    import torch
    argv = [str(c.FLAGSHIP_CFG), *c.FLAGSHIP_ARGS, "--engine", engine,
            *RINGS[engine]]
    code, eng, res, _out, wall, launches = c.drive(argv, f"flagship {engine}")
    st = eng.stats
    row = dict(engine=engine, argv=argv[1:], code=code,
               n_states=res.n_states, diameter=res.diameter,
               n_transitions=res.n_transitions,
               levels_equal=res.levels == c.flagship_levels(), wall=wall,
               rate=res.n_states / wall, chunks=st["chunks"],
               k1_launches=launches["step"],
               k2_launches=launches["fingerprint"],
               plain_calls=launches["plain step"]
               + launches["plain orbit key"],
               pageout_s=st["pageout_s"], upload_s=st["upload_s"],
               syncs_per_chunk=st["syncs"] / max(1, st["chunks"]),
               ring=eng.caps.ring,
               peak_dev_gib=torch.cuda.max_memory_allocated() / 2**30,
               host_store_gib_est=res.n_states * (
                   4 * eng.schema.P + 12 + 4 * (engine == "streamed"))
               / 2**30,
               peak_rss_gib=c.host_rss_gib())
    return row


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=str(ROOT / "chiprun_out"
                                         / "paged_run.json"))
    ap.add_argument("--only", choices=tuple(RINGS))
    ap.add_argument("--one", choices=tuple(RINGS), help=argparse.SUPPRESS)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("paged_run: needs a CUDA device", file=sys.stderr)
        return 2
    if args.one:
        print(json.dumps(one(args.one)))
        return 0
    from raft_tla_tpu_torch.config import Bounds
    from raft_tla_tpu_torch.ops import build, pallas_step
    from raft_tla_tpu_torch.utils import native
    t0 = time.monotonic()
    build.prebuild([(pallas_step.SOURCE, tuple(sorted(
        pallas_step.layout_defines(Bounds(3, 2, 2, 1, 2)).items())))])
    native._lib()
    c.say(f"built K1 (flagship layout) and the host store in "
          f"{time.monotonic() - t0:.1f} s")
    rows = []
    for engine in ([args.only] if args.only else list(RINGS)):
        proc = subprocess.run([sys.executable, __file__, "--one", engine],
                              cwd=ROOT, capture_output=True, text=True,
                              timeout=3000)
        if proc.returncode != 0:
            c.fail(f"flagship {engine}: exit {proc.returncode}\n"
                   f"{proc.stdout[-3000:]}{proc.stderr[-3000:]}")
        row = json.loads(proc.stdout.strip().splitlines()[-1])
        rows.append(row)
        c.say(f"flagship --engine {engine} (ring {row['ring']:,}): exit "
              f"{row['code']}; {row['n_states']} orbits, diameter "
              f"{row['diameter']}, {row['n_transitions']} transitions, "
              f"levels equal to {c.FLAGSHIP_OUT.name}: "
              f"{row['levels_equal']}; wall {row['wall']:.2f} s, "
              f"{row['rate']:,.0f} orbits/s; {row['chunks']} chunks, K1 "
              f"launches {row['k1_launches']}, host syncs "
              f"{row['syncs_per_chunk']:.2f}/chunk; pageout "
              f"{row['pageout_s']:.2f} s, upload {row['upload_s']:.2f} s; "
              f"peak device memory {row['peak_dev_gib']:.2f} GiB, host "
              f"store (computed from the states) "
              f"{row['host_store_gib_est']:.2f} GiB, peak host RSS "
              f"{row['peak_rss_gib']:.2f} GiB")
        got = (row["n_states"], row["diameter"], row["n_transitions"])
        if row["code"] != 0 or got != WANT or not row["levels_equal"] \
                or row["k1_launches"] != row["chunks"] \
                or row["plain_calls"]:
            c.fail(f"flagship {engine}: {row}")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    c.say(f"{card}; {time.monotonic() - t0:.1f} s")
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps({"card": card, "runs": rows},
                                         indent=1, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
