"""What every cell shares: finding its files, its spans, its result line.

Everything that belongs to one configuration, traffic mix, cell or
per-layer metric is a file of its own, found by the name that
`BENCHMARK.json` gives it:

- `configs/<config>.json` (the `file` of the config entry): the model as
  it is run, its source, the keys changed from it and the weights assumed;
- `traffic/<traffic>.json`: the driver (`drivers/<driver>.py`) and the
  parameters that `traffic.py` draws the calls from;
- `workloads/<cell>.json`: the cell's correctness limits, with the
  readings they were set from;
- `metrics/<metric>.py`: a reader, `read(record) -> float | None`, that
  takes one per-layer metric from the run's spans, counters and trace;
  where there is none, `metrics/<stem>.py` (the name up to its first dot)
  reads every metric of that stem, one quantity split by the cells'
  end-to-end metrics (`device_idle.serve`, `device_idle.train`).
"""

from __future__ import annotations

import contextlib
import gc
import importlib.util
import json
import sys
import time
from pathlib import Path
from typing import Any, Callable, Dict, List, NamedTuple, Optional

import torch

ROOT = Path(__file__).resolve().parents[1]
HERE = Path(__file__).resolve().parent
# Top-level module names that no run may load (the JAX reference package
# and JAX itself); compared whole: the port's name begins with one.
FORBIDDEN_MODULES = ('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'se3ds_tpu')


class Cell(NamedTuple):
  name: str
  chips: int
  config_name: str
  config: Dict[str, Any]
  traffic_name: str
  traffic: Dict[str, Any]
  limits: Dict[str, float]
  end_to_end: List[Dict[str, Any]]
  per_layer: List[Dict[str, Any]]


def load_spec(root: Path = ROOT) -> Dict[str, Any]:
  return json.loads((root / 'BENCHMARK.json').read_text())


def find_cell(name: str, root: Path = ROOT,
              bench: Path = HERE) -> Cell:
  """The cell `name` of `root`'s BENCHMARK.json, with its files."""
  spec = load_spec(root)
  workloads = {w['name']: w for w in spec['workloads']}
  if name not in workloads:
    raise KeyError(f'no workload {name!r} in BENCHMARK.json; have '
                   f'{sorted(workloads)}')
  entry = workloads[name]
  configs = {c['name']: c for c in spec['configs']}
  config = json.loads((root / configs[entry['config']]['file']).read_text())
  traffic = json.loads(
      (bench / 'traffic' / f"{entry['traffic']}.json").read_text())
  limits = json.loads(
      (bench / 'workloads' / f'{name}.json').read_text())['limits']
  end_to_end = [m for m in spec['end_to_end']
                if name in m.get('workloads', [name])]
  reported = {m['name'] for m in end_to_end}
  per_layer = [m for m in spec['per_layer']
               if name in m['workloads'] or
               ('workloads' not in m and m['moves'] in reported)]
  return Cell(name, entry['chips'], entry['config'], config,
              entry['traffic'], traffic, limits, end_to_end, per_layer)


def driver(cell: Cell, bench: Path = HERE):
  """The module of the cell's driver, `drivers/<driver>.py`."""
  return _load(bench / 'drivers' / f"{cell.traffic['driver']}.py",
               f"benchmark.drivers.{cell.traffic['driver']}")


def reader(metric: str, bench: Path = HERE) -> Callable:
  """The `read` function of `metrics/<metric>.py`, or of
  `metrics/<stem>.py` where the metric has no file of its own."""
  path = bench / 'metrics' / f'{metric}.py'
  if not path.exists():
    metric = metric.split('.')[0]
    path = bench / 'metrics' / f'{metric}.py'
  module = _load(path, 'benchmark.metrics.' + metric.replace('.', '_'))
  return module.read


def _load(path: Path, name: str):
  if name in sys.modules:
    return sys.modules[name]
  spec = importlib.util.spec_from_file_location(name, path)
  module = importlib.util.module_from_spec(spec)
  sys.modules[name] = module
  spec.loader.exec_module(module)
  return module


def mark(name: str, on: bool):
  """A profiler range named `name` where `on` (the traced calls)."""
  if on:
    from torch.profiler import record_function
    return record_function(name)
  return contextlib.nullcontext()


def log(started: float, what: str) -> None:
  """A phase of the run on standard error, with the seconds since start."""
  print(f'[{time.perf_counter() - started:8.2f} s] {what}', file=sys.stderr,
        flush=True)


class Spans:
  """Host spans and counters recorded around the calls into the program:
  wall and thread-CPU seconds by name, kept in memory."""

  def __init__(self):
    self.wall: Dict[str, List[float]] = {}
    self.cpu: Dict[str, List[float]] = {}
    self.counters: Dict[str, Any] = {}

  @contextlib.contextmanager
  def span(self, name: str):
    t0, c0 = time.perf_counter(), time.thread_time()
    try:
      yield
    finally:
      self.wall.setdefault(name, []).append(time.perf_counter() - t0)
      self.cpu.setdefault(name, []).append(time.thread_time() - c0)


class Record(NamedTuple):
  """What a per-layer reader reads."""
  cell: Cell
  spans: Spans
  trace: Optional[Any]  # trace.Summary of the traced calls, or None


class Outcome(NamedTuple):
  """What a driver returns."""
  end_to_end: Dict[str, float]
  record: Record
  checks: Dict[str, tuple]  # name -> (value, limit)
  attempted: int
  failed: int
  memory_peak_bytes: int
  readings: Dict[str, Any]  # the program's and the control's readings


def sync(device) -> None:
  if torch.device(device).type == 'cuda':
    torch.cuda.synchronize()


def release(device) -> None:
  """Frees what the collector and the caching allocator hold."""
  gc.collect()
  if torch.device(device).type == 'cuda':
    torch.cuda.empty_cache()


def reset_peak(device) -> None:
  if torch.device(device).type == 'cuda':
    torch.cuda.reset_peak_memory_stats()


def peak_bytes(device) -> int:
  if torch.device(device).type != 'cuda':
    return 0
  return int(torch.cuda.max_memory_allocated())


def forbidden_modules() -> List[str]:
  return sorted(name for name in sys.modules
                if name.split('.')[0] in FORBIDDEN_MODULES)


def result(cell: Cell, outcome: Outcome, trace: bool, device: Dict
           ) -> Dict[str, Any]:
  """The result line: `correct` when every check is within its limit."""
  if trace:
    metrics = {}
    for spec in cell.per_layer:
      value = reader(spec['name'])(outcome.record)
      if value is not None:
        metrics[spec['name']] = {'value': value, 'unit': spec['unit']}
  else:
    metrics = {spec['name']: {'value': outcome.end_to_end[spec['name']],
                              'unit': spec['unit']}
               for spec in cell.end_to_end}
  correct = all(value <= limit for value, limit in outcome.checks.values())
  line = {'correct': correct, 'attempted': outcome.attempted,
          'failed': outcome.failed, 'metrics': metrics,
          'device': dict(device,
                         memory_peak_bytes=outcome.memory_peak_bytes)}
  summary = outcome.record.trace
  if trace and summary is not None:
    line['device'].update(busy_s=summary.busy_s, window_s=summary.window_s)
    line['breakdown'] = {'device_ops': summary.device_ops,
                         'idle_gaps': summary.idle_gaps}
  line['checks'] = {name: {'value': value, 'limit': limit}
                    for name, (value, limit) in outcome.checks.items()}
  return line
