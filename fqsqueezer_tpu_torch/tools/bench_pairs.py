"""An earlier checkout of the package against this one, in pairs on one card.

    python3 -m fqsqueezer_tpu_torch.tools.bench_pairs --parent DIR [--pairs 10]

DIR holds the earlier package, e.g. from
`git archive <commit> fqsqueezer_tpu_torch | tar -x -C DIR`. Each pair runs
this checkout's `bench_gpu.py --primary-only` twice, in processes of their
own: once with DIR's package on the path and once with this checkout's.
The side that runs first alternates from pair to pair (parent, change,
change, parent, ...), so that a drift of the card falls on both sides.
Prints one JSON line a run, then one summary line: for compress and decode
reads/s, each side's median and quartiles and the pairs the change won.
Needs a CUDA card, as bench_gpu does.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
BENCH = os.path.join(REPO, "fqsqueezer_tpu_torch", "tools", "bench_gpu.py")
METRICS = ("value", "decode_reads_per_s")


def run_side(path: str) -> dict:
    """bench_gpu's primary row with the package under `path`."""
    env = dict(os.environ, PYTHONPATH=path)
    out = subprocess.run([sys.executable, BENCH, "--primary-only"], env=env,
                         capture_output=True, text=True, timeout=900)
    if out.returncode != 0:
        raise RuntimeError(f"bench_gpu with {path} returned "
                           f"{out.returncode}: {out.stderr.strip()[-400:]}")
    row = json.loads(out.stdout.strip().splitlines()[-1])
    want = os.path.join(os.path.abspath(path), "fqsqueezer_tpu_torch")
    if row["package"] != want:
        raise RuntimeError(f"bench_gpu measured {row['package']}, not {want}")
    return row


def summarize(pairs: list) -> dict:
    """pairs: [(parent row, change row)]. Per metric: each side's median
    and quartiles, and how many pairs the change won (ties win for
    neither)."""
    out = {}
    for key in METRICS:
        side = {}
        for name, rows in (("parent", [p for p, _ in pairs]),
                           ("change", [c for _, c in pairs])):
            vals = [r[key] for r in rows]
            q1, _, q3 = statistics.quantiles(vals, n=4)
            side[name] = {"median": statistics.median(vals), "q1": q1,
                          "q3": q3, "runs": vals}
        side["change_wins"] = sum(c[key] > p[key] for p, c in pairs)
        side["pairs"] = len(pairs)
        out[key] = side
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", required=True,
                    help="directory that holds the earlier package")
    ap.add_argument("--pairs", type=int, default=10)
    args = ap.parse_args()
    if not os.path.isdir(os.path.join(args.parent, "fqsqueezer_tpu_torch")):
        raise SystemExit(f"bench_pairs: no fqsqueezer_tpu_torch under "
                         f"{args.parent}")
    pairs = []
    for i in range(args.pairs):
        order = ("parent", "change") if i % 2 == 0 else ("change", "parent")
        rows = {}
        for side in order:
            rows[side] = run_side(args.parent if side == "parent" else REPO)
            print(json.dumps({"pair": i, "side": side, "row": rows[side]}),
                  flush=True)
        pairs.append((rows["parent"], rows["change"]))
    print(json.dumps(summarize(pairs)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
