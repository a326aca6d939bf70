#!/usr/bin/env python3
"""The readings that the limits of ``correct`` are set from, on the card.

    python3 perfbench/calibrate.py --workload <cell> --seeds 1,2,3 \\
        --seconds 2 [--faults answer,half_batch,...]

For each seed, in one process: the cell's set-up and a short window at its
own load, then the comparison of the kept outputs with the reference (the
program's reading), and the control's reading: the reference computed at
TF32 in the program's place, on the same batches (``check.compare``).
With ``--faults``, the first three seeds again with each planted fault
(``faults.py``).  One JSON line a reading on stdout, then a summary: the
program's largest reading of each number (the lower one), the control's
smallest (the upper one).  Not part of a benchmark run.
"""

import argparse
import json
import sys
from pathlib import Path

sys.path[0] = str(Path(__file__).resolve().parents[1])

from perfbench import check, faults, harness  # noqa: E402


def readings(cell, seed, seconds, dev, wrap=None, control=False):
    r = harness.measure(cell, seed, seconds, dev, wrap)
    out = {"seed": seed,
           "audio_s_per_s": r.window.audio_s / r.window.seconds,
           "batches": r.window.batches}
    numbers, _, failed = check.compare(cell.config, r.checked, r.kept)
    out["program"] = {n: v for n, (v, _) in numbers.items()}
    out["program_failed"] = failed
    if control:
        numbers, _, failed = check.compare(
            cell.config, r.checked, [None] * len(r.checked), "tf32")
        out["control"] = {n: v for n, (v, _) in numbers.items()}
        out["control_failed"] = failed
    return out


def main(argv) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--faults", default="")
    args = p.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("calibrate: needs a CUDA device", file=sys.stderr)
        return 2
    dev = harness.Cuda(torch)
    cell = harness.load_cell(args.workload)
    seeds = [int(s) for s in args.seeds.split(",")]
    lower, upper = {}, {}
    for seed in seeds:
        line = readings(cell, seed, args.seconds, dev, control=True)
        print(json.dumps(line), flush=True)
        for n, v in line["program"].items():
            lower[n] = max(lower.get(n, v), v)
        for n, v in line["control"].items():
            upper[n] = min(upper.get(n, v), v)
        torch.cuda.empty_cache()
    for name in filter(None, args.faults.split(",")):
        for seed in seeds[:3]:
            line = readings(cell, seed, args.seconds, dev,
                            wrap=faults.FAULTS[name])
            print(json.dumps({"fault": name, **line}), flush=True)
            torch.cuda.empty_cache()
    print(json.dumps({"workload": cell.name, "seeds": len(seeds),
                      "lower": lower, "upper": upper,
                      "kind": dev.kind(), "power": dev.power_limit()}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
