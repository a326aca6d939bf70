#!/usr/bin/env python3
"""Run one benchmark cell once and print its result line.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds ``BENCHMARK.json``, ``perfbench/``
and the program.  Needs a CUDA card: without one it exits 2 and prints no
result.  See ``perfbench/README.md``.
"""

import sys
from pathlib import Path

# the checkout's root, in place of this script's own directory
sys.path[0] = str(Path(__file__).resolve().parents[1])

from perfbench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:]))
