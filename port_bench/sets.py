"""Runs of the benchmark's command in sequence, one process each, as the
check makes them; prints each run's result and the spread of each
end-to-end metric.

    python3 -m port_bench.sets --workload euroc_mono_vio.laps \\
        --seeds 1,2,3,4,5,6 [--seconds 51] [--trace 0] [--out FILE]

The spread of a metric is the distance between the first and third
quartile (Python's ``statistics.quantiles(values, n=4)``) over the median;
``spread_less_far`` is the same with the run farthest from the median left
out, as the check's test of a bound's tightness takes it.
Each run's result line, with the tail of its standard error, is appended
to ``--out`` as JSON.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def spread(values: list) -> float:
    q = statistics.quantiles(values, n=4)
    return (q[2] - q[0]) / statistics.median(values)


def spread_less_far(values: list) -> float:
    med = statistics.median(values)
    far = max(range(len(values)), key=lambda i: abs(values[i] - med))
    return spread([v for i, v in enumerate(values) if i != far])


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m port_bench.sets")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float)
    p.add_argument("--trace", type=int, default=0)
    p.add_argument("--out")
    p.add_argument("--label", default="")
    args = p.parse_args(argv)
    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    seconds = args.seconds or manifest["run_seconds"]
    results = []
    for seed in args.seeds.split(","):
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "port_bench.run", "--workload",
             args.workload, "--seed", seed, "--seconds", str(seconds),
             "--trace", str(args.trace)], cwd=ROOT, capture_output=True,
            text=True)
        wall = time.perf_counter() - t0
        lines = proc.stdout.strip().splitlines()
        try:
            res = json.loads(lines[-1])
        except (IndexError, json.JSONDecodeError):
            res = None
        rec = {"label": args.label, "workload": args.workload,
               "seed": int(seed), "trace": args.trace, "rc": proc.returncode,
               "wall_s": wall, "result": res,
               "stderr": [ln for ln in proc.stderr.splitlines()
                          if not ln.startswith("USDT")][-40:]}
        results.append(rec)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(rec) + "\n")
        brief = ({k: v["value"] for k, v in res["metrics"].items()}
                 if res else None)
        print(json.dumps({"seed": int(seed), "rc": proc.returncode,
                          "wall_s": round(wall, 1),
                          "correct": res and res["correct"],
                          "metrics": brief}), flush=True)
        if res is None:
            print("\n".join(rec["stderr"][-15:]), flush=True)
    ok = [r["result"] for r in results if r["result"]]
    if len(ok) >= 2:
        for name in ok[0]["metrics"]:
            vals = [r["metrics"][name]["value"] for r in ok
                    if name in r["metrics"]]
            if len(vals) >= 2:
                print(json.dumps({"metric": name, "median":
                                  statistics.median(vals),
                                  "spread": spread(vals) if len(vals) >= 3
                                  else None,
                                  "spread_less_far": spread_less_far(vals)
                                  if len(vals) >= 4 else None,
                                  "values": vals}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
