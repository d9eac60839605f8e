"""Captured serving programs: one CUDA graph per key.

The PyTorch counterpart of the JAX package's compiled variants of the
serving API (`jax.jit` with static arguments,
se3ds_tpu/models/inference.py:441-457). `SE3DSModel` runs each call as
`Programs.run(key, fn, inputs)`:

- the first call of a key runs `fn(*inputs)` eagerly on the caller's
  stream. It is the warm-up: the kernels' nvcc builds, the lazy loads of
  their libraries, cuDNN's handles and algorithm choices all happen
  outside a capture;
- the second call captures `fn` into a `torch.cuda.CUDAGraph` on a side
  stream (nothing runs while it is captured), then replays it;
- every later call copies its inputs into the graph's static inputs and
  replays.

`fn` reads its inputs and state that lives at fixed addresses outside
the pool (the model's memory buffers and previous frame, which it
updates in place), and returns a dict of tensors. A replay overwrites
the graph's output tensors, so `run` returns copies of them: nothing a
caller holds changes at the next call.

Every graph of one `Programs` is captured into one memory pool. That is
safe because nothing in the pool is read across a replay of another
graph: state and static inputs live outside it, and outputs are copied
out right after their replay. A failed capture or replay raises; there
is no eager fallback.

`run` records its parts as spans of `se3ds_torch.tracing`, children of
the caller's span: `upload` (making the inputs and copying them into the
static inputs), then `eager` (a key's first call), or `capture` (its
second) and `replay`, then `copy_out` (the outputs' clones); and the
counters `serve.eager_runs`, `serve.captures` and `serve.replays`.

The kernels' launch counters (`splat.fast_launches`,
`splat.exact_launches`) and the generator's convolution counters
(`generator.convs`, `generator.nchw_convs`) move only when Python runs,
so they move while a graph is captured and not when it replays. `run`
takes a graph's count at capture back out and adds it at each replay:
the counters count the point passes and convolutions that ran.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Hashable, NamedTuple, Sequence, Tuple

import torch

from se3ds_torch import tracing

LAUNCH_COUNTERS = ('splat.fast_launches', 'splat.exact_launches',
                   'generator.convs', 'generator.nchw_convs')


def _launch_counts() -> Tuple[int, ...]:
  return tuple(tracing.count(name) for name in LAUNCH_COUNTERS)


def _add_launch_counts(counts: Sequence[int]) -> None:
  for name, n in zip(LAUNCH_COUNTERS, counts):
    if n:
      tracing.counter(name, n)


class _Graph(NamedTuple):
  graph: Any
  inputs: Tuple[torch.Tensor, ...]
  outputs: Dict[str, torch.Tensor]
  launches: Tuple[int, ...]  # of LAUNCH_COUNTERS


class Programs:
  """One captured graph per key, all in one memory pool.

  Args:
    capture: the capture context, `torch.cuda.graph` (a test passes a
      stand-in to count captures on the CPU).
    new_graph: makes an empty graph, `torch.cuda.CUDAGraph`.
    pool: the shared pool, default a new `torch.cuda.graph_pool_handle()`.
  """

  def __init__(self, capture: Callable = None, new_graph: Callable = None,
               pool=None):
    self._capture = capture or torch.cuda.graph
    self._new_graph = new_graph or torch.cuda.CUDAGraph
    self.pool = torch.cuda.graph_pool_handle() if pool is None else pool
    self.warmed = set()  # keys run once eagerly
    self.graphs: Dict[Hashable, _Graph] = {}

  @staticmethod
  def key(name: Hashable, inputs: Sequence[torch.Tensor]) -> Tuple:
    """`name` with the inputs' shapes and dtypes: a graph replays one
    signature, as `jax.jit` compiles one per signature."""
    return (name,) + tuple((tuple(x.shape), x.dtype) for x in inputs)

  def run(self, name: Hashable, fn: Callable[..., Dict[str, torch.Tensor]],
          inputs: Callable[[], Sequence[torch.Tensor]]
          ) -> Dict[str, torch.Tensor]:
    """`fn(*inputs())` as the program of `name` (see the module doc);
    `inputs` makes the call's input tensors."""
    with tracing.span('upload'):
      inputs = tuple(inputs())
      key = self.key(name, inputs)
      entry = self.graphs.get(key)
      if entry is not None:
        for static, x in zip(entry.inputs, inputs):
          static.copy_(x)
    if entry is None:
      if key not in self.warmed:
        with tracing.span('eager'):
          out = fn(*inputs)
        self.warmed.add(key)
        tracing.counter('serve.eager_runs')
        return out
      with tracing.span('capture'):
        entry = self._capture_graph(key, fn, inputs)
      tracing.counter('serve.captures')
    with tracing.span('replay'):
      entry.graph.replay()
    tracing.counter('serve.replays')
    _add_launch_counts(entry.launches)
    with tracing.span('copy_out'):
      return {k: v.clone() for k, v in entry.outputs.items()}

  def _capture_graph(self, key, fn, inputs) -> _Graph:
    # The graph reads its own copies: a caller's tensor may change later.
    static = tuple(x.clone() for x in inputs)
    graph = self._new_graph()
    before = _launch_counts()
    try:
      with self._capture(graph, pool=self.pool):
        outputs = fn(*static)
    finally:
      # Nothing ran while it was captured.
      launched = tuple(a - b for a, b in zip(_launch_counts(), before))
      _add_launch_counts([-n for n in launched])
    entry = _Graph(graph, static, outputs, launched)
    self.graphs[key] = entry
    return entry

  def pool_bytes(self) -> int:
    """Bytes the CUDA caching allocator holds in this pool's segments."""
    pool = tuple(self.pool)
    return sum(s['total_size'] for s in torch.cuda.memory_snapshot()
               if tuple(s.get('segment_pool_id', ())) == pool)
