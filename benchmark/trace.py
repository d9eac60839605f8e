"""The device trace of a few calls, reduced to what the readers need.

`traced(call, warmup, calls)` runs `call()` `warmup` times under
`torch.profiler` (CPU and CUDA activity) and drops what it recorded
(the tracer's own start-up), then `calls` times inside a 'bench.window'
range, which it keeps: the Chrome trace goes to the run's temporary
directory, is read back and deleted. `Summary` holds:

- `window_s`: the length of the 'bench.window' range;
- `busy_s`: the union of the device operations' intervals (kernels,
  memsets, copies) inside it;
- `ops`: (name, seconds) of every device operation in it, for readers
  that sum kernels by name;
- `device_ops`: the ten names that took the most device time;
- `idle_gaps`: the ten longest gaps between device operations, each
  named by what the host was doing then (the benchmark's range and the
  longest host operation under it).
"""

from __future__ import annotations

import json
import os
import tempfile
from typing import Callable, List, NamedTuple, Tuple

import torch
from torch.profiler import ProfilerActivity, profile, record_function

DEVICE_CATEGORIES = ('kernel', 'gpu_memcpy', 'gpu_memset')
HOST_CATEGORIES = ('cpu_op', 'user_annotation', 'cuda_runtime',
                   'cuda_driver')
WINDOW = 'bench.window'


class Summary(NamedTuple):
  window_s: float
  busy_s: float
  ops: List[Tuple[str, float]]
  device_ops: List[Tuple[str, float]]
  idle_gaps: List[Tuple[str, float]]


def traced(call: Callable[[], None], warmup: int, calls: int) -> Summary:
  fd, path = tempfile.mkstemp(suffix='.json')
  os.close(fd)
  schedule = torch.profiler.schedule(wait=0, warmup=1, active=1, repeat=1)
  try:
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule,
                 on_trace_ready=lambda p: p.export_chrome_trace(path)
                 ) as prof:
      for _ in range(warmup):
        call()
      torch.cuda.synchronize()
      prof.step()
      with record_function(WINDOW):
        for _ in range(calls):
          call()
        torch.cuda.synchronize()
      prof.step()
    with open(path) as f:
      events = json.load(f)['traceEvents']
  finally:
    os.remove(path)
  return summarise(events)


def summarise(events) -> Summary:
  """The summary of Chrome-trace events (times in microseconds)."""
  complete = [e for e in events if e.get('ph') == 'X' and 'dur' in e]
  window = [e for e in complete if e['name'] == WINDOW
            and e.get('cat') == 'user_annotation']
  if not window:
    raise RuntimeError(f'the trace holds no {WINDOW!r} range')
  w0 = float(window[0]['ts'])
  w1 = w0 + float(window[0]['dur'])
  device = sorted((float(e['ts']), float(e['ts']) + float(e['dur']),
                   e['name']) for e in complete
                  if e.get('cat') in DEVICE_CATEGORIES)
  device = [(max(a, w0), min(b, w1), n) for a, b, n in device
            if b > w0 and a < w1]
  by_name = {}
  for a, b, name in device:
    by_name[name] = by_name.get(name, 0.0) + (b - a) * 1e-6
  busy, gaps, end = 0.0, [], w0
  for a, b, _ in device:
    if a > end:
      gaps.append((end, a))
    if b > end:
      busy += b - max(a, end)
      end = b
  if end < w1:
    gaps.append((end, w1))
  host = [(float(e['ts']), float(e['ts']) + float(e['dur']), e['name'],
           e.get('cat')) for e in complete
          if e.get('cat') in HOST_CATEGORIES and e['name'] != WINDOW]
  gaps.sort(key=lambda g: g[0] - g[1])
  named_gaps = [(_host_activity(host, a, b), (b - a) * 1e-6)
                for a, b in gaps[:10]]
  top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
  return Summary(window_s=(w1 - w0) * 1e-6, busy_s=busy * 1e-6,
                 ops=[(n[:160], s) for n, s in by_name.items()],
                 device_ops=[[n[:120], s] for n, s in top],
                 idle_gaps=[[n, s] for n, s in named_gaps])


def _host_activity(host, a, b) -> str:
  """'<benchmark range>/<longest host op>' overlapping [a, b]."""
  overlap = [(min(e1, b) - max(e0, a), name, cat)
             for e0, e1, name, cat in host if e1 > a and e0 < b]
  ranges = [o for o in overlap if o[2] == 'user_annotation'
            and o[1].startswith('bench.')]
  ops = [o for o in overlap
         if not o[1].startswith(('bench.', 'ProfilerStep'))]
  parts = []
  if ranges:
    parts.append(max(ranges)[1])
  if ops:
    parts.append(max(ops)[1][:80])
  return '/'.join(parts) or 'host idle'
