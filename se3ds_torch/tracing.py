"""Spans and counters of the program: where a call's time goes, measured
from inside, with nothing switched on.

- `span(part, timed=False)` is a context manager around one part of the
  work. Its full name is the enclosing span's full name, a dot and
  `part` (`serve.step`, then `serve.step.replay`), so a child's name
  always extends its parent's. Every span records its host duration
  (`time.perf_counter_ns`) into a ring per name (the last `RING` values)
  and a count. A `timed` span also records a pair of CUDA events on the
  current stream at entry and exit (pass `timed` only for work on a
  card), at most once in `TIMED_EVERY_S` per name: on the card a pair,
  with its reading, costs a served call ~0.1 ms of host time (PERF.md),
  so a served step is timed one call in ten while each part of a train
  step is timed every step. The pair is read once its end event has
  completed, when a later pair is recorded or at `snapshot()`, so the
  hot path never waits for the device. At most `PENDING` pairs wait to
  be read; beyond that a span records none and `dropped` counts it.
  Events are reused.
- `counter(name, n=1)` adds `n` to an integer; `count(name)` reads it.
- `snapshot()` waits for the pending pairs and returns the counters and,
  for each span name, its count and its host and device duration rings
  in milliseconds. `reset()` clears everything.

While a `torch.profiler` session records (`torch.autograd.
_profiler_enabled()`, true in a schedule's active phase only), each span
is also a profiler range under its full name, on the trace's clock,
whose input is the sequence number of the outermost span it belongs to
(one call of an entry point: shown in a trace that records shapes). No
range is made otherwise. A span inside code that a CUDA graph captures
would not run at replay: spans sit around captures and replays, never
inside them, and a timed span entered during a capture records no
events.

The state is the process's (one registry, per-thread nesting): the
serving API, the train step and the kernels' wrappers write to it
wherever they are called from, and any reader in the process reads it.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Any, Deque, Dict, List

import torch

RING = 4096         # durations kept per span name
PENDING = 1024      # event pairs waiting to be read
TIMED_EVERY_S = 0.5  # least time between two event pairs of one name


class _Series:
  __slots__ = ('count', 'host_ns', 'device_ms', 'next_timed_ns')

  def __init__(self):
    self.count = 0
    self.next_timed_ns = 0
    self.host_ns: Deque[int] = collections.deque(maxlen=RING)
    self.device_ms: Deque[float] = collections.deque(maxlen=RING)


_series: Dict[str, _Series] = {}
_counters: Dict[str, int] = {}
_pending: Deque[tuple] = collections.deque()  # (series, start, end, device)
_free: Dict[int, List[torch.cuda.Event]] = {}  # device index -> events
_streams: Dict[tuple, torch.cuda.Stream] = {}  # (id, device, type) -> stream
_dropped = 0
_calls = 0  # outermost spans entered
_local = threading.local()  # .stack: full names; .call: its sequence number


def _stack() -> List[str]:
  try:
    return _local.stack
  except AttributeError:
    _local.stack = []
    return _local.stack


def _current_stream() -> torch.cuda.Stream:
  """`torch.cuda.current_stream()`, one object per stream: building a
  Stream object switches the current device twice."""
  key = torch._C._cuda_getCurrentStream(torch._C._cuda_getDevice())
  stream = _streams.get(key)
  if stream is None:
    stream = _streams[key] = torch.cuda.Stream(
        stream_id=key[0], device_index=key[1], device_type=key[2])
  return stream


def _event(device: int) -> torch.cuda.Event:
  free = _free.get(device)
  return free.pop() if free else torch.cuda.Event(enable_timing=True)


def _read(series: _Series, start, end, device: int) -> None:
  series.device_ms.append(start.elapsed_time(end))
  _free.setdefault(device, []).extend((start, end))


def _poll() -> None:
  """Reads the pairs whose end has completed, oldest first."""
  while _pending and _pending[0][2].query():
    _read(*_pending.popleft())


class span:
  """See the module doc."""

  __slots__ = ('part', 'timed', 'stack', 'series', 't0', 'start', 'stream',
               'range')

  def __init__(self, part: str, timed: bool = False):
    self.part = part
    self.timed = timed

  def __enter__(self) -> 'span':
    global _calls, _dropped
    stack = _stack()
    if stack:
      name = stack[-1] + '.' + self.part
    else:
      name = self.part
      _calls += 1
      _local.call = _calls
    stack.append(name)
    self.stack = stack
    series = _series.get(name)
    if series is None:
      series = _series[name] = _Series()
    self.series = series
    self.start = None
    if self.timed:
      now = time.perf_counter_ns()
      if (now >= series.next_timed_ns
          and not torch._C._cuda_isCurrentStreamCapturing()):
        series.next_timed_ns = now + int(TIMED_EVERY_S * 1e9)
        _poll()
        if len(_pending) < PENDING:
          self.stream = _current_stream()
          self.start = _event(self.stream.device_index)
          self.start.record(self.stream)
        else:
          _dropped += 1
    self.range = (torch.autograd._record_function_with_args_enter(
        name, _local.call) if torch.autograd._profiler_enabled() else None)
    self.t0 = time.perf_counter_ns()
    return self

  def __exit__(self, *exc) -> None:
    elapsed = time.perf_counter_ns() - self.t0
    if self.range is not None:
      torch.autograd._record_function_with_args_exit(self.range)
    if self.start is not None:
      end = _event(self.stream.device_index)
      end.record(self.stream)
      _pending.append((self.series, self.start, end,
                       self.stream.device_index))
    series = self.series
    series.count += 1
    series.host_ns.append(elapsed)
    self.stack.pop()


def counter(name: str, n: int = 1) -> None:
  _counters[name] = _counters.get(name, 0) + n


def count(name: str) -> int:
  return _counters.get(name, 0)


def snapshot() -> Dict[str, Any]:
  """{'counters': {name: int}, 'dropped': int, 'spans': {full name:
  {'count': int, 'host_ms': [...], 'device_ms': [...]}}}, the rings
  oldest first; waits for every pending event pair."""
  while _pending:
    pair = _pending.popleft()
    pair[2].synchronize()
    _read(*pair)
  return {'counters': dict(_counters), 'dropped': _dropped,
          'spans': {name: {'count': s.count,
                           'host_ms': [ns * 1e-6 for ns in s.host_ns],
                           'device_ms': list(s.device_ms)}
                    for name, s in _series.items()}}


def reset() -> None:
  """Clears the spans, the counters and the pending pairs."""
  global _dropped, _calls
  _series.clear()
  _counters.clear()
  _pending.clear()
  _dropped = 0
  _calls = 0
