"""Runs one cell of the benchmark of `se3ds_torch` once, on CUDA cards.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Loads the cell's files (`harness.find_cell`), makes its weights and
inputs from the seed, warms up, measures for `--seconds`, checks the
timed calls against the plain reference, and prints the result as the
last line of standard output: `correct`, `attempted`, `failed`,
`metrics` (the cell's end-to-end metrics, or with `--trace 1` its
per-layer ones, read from a traced run of a few more calls), `device`
and, last, `checks` (each number compared, with its limit, also printed
as the last lines of standard error). Exits non-zero and prints no
result without enough CUDA cards, or if JAX or the JAX package was
loaded.
"""

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
  parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  parser.add_argument('--workload', required=True)
  parser.add_argument('--seed', type=int, required=True)
  parser.add_argument('--seconds', type=float, required=True)
  parser.add_argument('--trace', type=int, choices=(0, 1), default=0)
  args = parser.parse_args(argv)

  # Kernel caches at fixed paths inside the checkout (the program builds
  # its own CUDA sources into build/se3ds_torch/ there as well).
  os.environ.setdefault('TRITON_CACHE_DIR', str(ROOT / 'build' / 'triton'))
  os.environ.setdefault('TORCH_EXTENSIONS_DIR',
                        str(ROOT / 'build' / 'torch_extensions'))
  sys.path.insert(0, str(ROOT))
  import torch
  from benchmark import harness

  cell = harness.find_cell(args.workload, ROOT)
  if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
    print(f'{args.workload} needs {cell.chips} CUDA card(s); found '
          f'{torch.cuda.device_count() if torch.cuda.is_available() else 0}',
          file=sys.stderr)
    return 2
  print(power_limit(), file=sys.stderr)
  seed = args.seed % (1 << 63)
  outcome = harness.driver(cell).run(cell, seed, args.seconds,
                                     bool(args.trace), 'cuda', STARTED)
  found = harness.forbidden_modules()
  if found:
    print(f'the run loaded forbidden modules: {found}', file=sys.stderr)
    return 3
  device = {'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
            'count': cell.chips}
  line = harness.result(cell, outcome, bool(args.trace), device)
  print(f'readings: {json.dumps(outcome.readings)}', file=sys.stderr)
  for name, check in line['checks'].items():
    print(f"check {name}: {check['value']!r} (limit {check['limit']!r})",
          file=sys.stderr)
  sys.stderr.flush()
  print(json.dumps(line), flush=True)
  return 0


def power_limit() -> str:
  try:
    return subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        timeout=30).stdout.strip()
  except (OSError, subprocess.SubprocessError) as error:
    return f'nvidia-smi: {error}'


if __name__ == '__main__':
  sys.exit(main())
