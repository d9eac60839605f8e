"""Reads a cell's correctness numbers, and its control's, over many seeds.

    python3 benchmark/tools/readings.py --workload <cell> --seconds <s> \
        --seeds <n> [<n> ...] [--control] [--tf32 0]

For each seed, in one process: one run of the cell's driver with a short
window (the cell's own sizes and load), then its readings: each number
the cell compares (`checks`) and, with `--control`, the same numbers of
the control, the reference in float8 put in the program's place on the
same inputs (for training, also the faults and the reordered-rows
witness of `drivers/train_step.py`). `--tf32 0` runs the program with
TF32 off, a look at what TF32 alone moves. One JSON line per seed. The limits in
`workloads/<cell>.json` are set from these readings (PERF.md gives them).
Needs a CUDA card; the benchmark's own runs never run the control.
"""

import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def main(argv=None) -> int:
  parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  parser.add_argument('--workload', required=True)
  parser.add_argument('--seconds', type=float, default=3.0)
  parser.add_argument('--seeds', type=int, nargs='+', required=True)
  parser.add_argument('--control', action='store_true')
  parser.add_argument('--tf32', type=int, choices=(0, 1), default=1)
  args = parser.parse_args(argv)
  sys.path.insert(0, str(ROOT))
  import torch
  from benchmark import harness

  if not torch.cuda.is_available():
    print('readings needs a CUDA card', file=sys.stderr)
    return 2
  cell = harness.find_cell(args.workload, ROOT)
  if not args.tf32:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
  for seed in args.seeds:
    started = time.perf_counter()
    outcome = harness.driver(cell).run(cell, seed, args.seconds, False,
                                       'cuda', started, control=args.control)
    print(json.dumps({'workload': cell.name, 'seed': seed,
                      'tf32': bool(args.tf32),
                      'readings': outcome.readings,
                      'end_to_end': outcome.end_to_end,
                      'attempted': outcome.attempted}), flush=True)
    del outcome
    gc.collect()
    torch.cuda.empty_cache()
  return 0


if __name__ == '__main__':
  sys.exit(main())
