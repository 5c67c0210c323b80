#!/usr/bin/env python3
"""Run one cell of the benchmark of doda_tpu_torch on this machine's card.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s>
                             --trace <0|1>

from the root of a checkout (``python3 -m portbench.run`` alike). Prints
the check's numbers beside their limits as the last lines of standard
error, and the result as the last line of standard output. Exits non-zero
with no result where the cell's cards are missing.
"""

import argparse
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# every build and kernel cache of the program inside the checkout, at
# fixed paths (the program's own nvcc and g++ builds go to build/)
os.environ.setdefault('TORCH_EXTENSIONS_DIR',
                      str(ROOT / 'build' / 'torch_extensions'))
os.environ.setdefault('TRITON_CACHE_DIR', str(ROOT / 'build' / 'triton'))


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seed', type=int, required=True)
    ap.add_argument('--seconds', type=float, required=True)
    ap.add_argument('--trace', type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


if __name__ == '__main__':
    args = parse()
    from portbench import bench
    sys.exit(bench.main(args))
