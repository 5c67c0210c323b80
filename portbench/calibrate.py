#!/usr/bin/env python3
"""The readings a cell's limits are set from, in one process:

    python3 portbench/calibrate.py --workload <name> --seeds 1 2 ... \
        [--control-seeds 7 8 9] [--modes fp8 half_batch] [--seconds 3] \
        [--out FILE]

For each of ``--seeds`` a run of the cell (``bench.run_cell``, a window
of ``--seconds``, the program's outputs against the reference); for each
of ``--control-seeds`` and ``--modes`` the same numbers with the control
or a fault in the program's place (``controls.py``). Prints one JSON line
a reading, and appends them to ``--out``. Needs the cell's card.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seeds', type=int, nargs='*', default=[])
    ap.add_argument('--control-seeds', type=int, nargs='*', default=[])
    ap.add_argument('--modes', nargs='*', default=['fp8'])
    ap.add_argument('--seconds', type=float, default=3.0)
    ap.add_argument('--out')
    args = ap.parse_args(argv)
    import torch
    from portbench import bench, controls
    if not torch.cuda.is_available():
        print('calibrate: needs a CUDA card', file=sys.stderr)
        return 2
    torch.set_num_threads(4)
    out = open(args.out, 'a') if args.out else None

    def emit(line):
        text = json.dumps(line)
        print(text, flush=True)
        if out:
            out.write(text + '\n')
            out.flush()

    for seed in args.seeds:
        t = time.time()
        r, notes = bench.run_cell(args.workload, seed, args.seconds, False)
        emit({'workload': args.workload, 'seed': seed, 'mode': 'program',
              'correct': r['correct'], 'attempted': r['attempted'],
              'numbers': notes['numbers'],
              'seconds': time.time() - t})
    for mode in args.modes:
        for seed in args.control_seeds:
            t = time.time()
            nums = controls.numbers(args.workload, seed, mode)
            emit({'workload': args.workload, 'seed': seed, 'mode': mode,
                  'numbers': nums, 'seconds': time.time() - t})
            torch.cuda.empty_cache()
    return 0


if __name__ == '__main__':
    sys.exit(main())
