"""The port's spans and counters (`se3ds_torch.tracing`), on the CPU.

The registry's names, nesting and bounded rings; a profiler range per
span while a `torch.profiler` session records and none otherwise; the
parts of a served call as `graphs.Programs` runs it (with a stand-in for
`torch.cuda.graph` that records captures without a card); and the parts
of a tiny `train_step`. The CUDA event pairs of timed spans are read on
the card (test_torch_cuda.py).
"""

import contextlib
import dataclasses
import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, schedule

from se3ds_torch import tracing
from se3ds_torch.models import discriminator as disc_t
from se3ds_torch.models import generator as gen_t
from se3ds_torch.models import graphs
from se3ds_torch.models import inference as inference_t
from se3ds_torch.models import layers
from se3ds_torch.models import model_config as config_t
from se3ds_torch.train import state as state_t


@pytest.fixture(autouse=True)
def fresh_registry():
  threads = torch.get_num_threads()
  torch.set_num_threads(1)
  tracing.reset()
  yield
  tracing.reset()
  torch.set_num_threads(threads)


def test_names_extend_the_enclosing_span():
  with tracing.span('serve.step'):
    with tracing.span('upload'):
      pass
    with tracing.span('replay'):
      with tracing.span('inner'):
        pass
    with tracing.span('replay'):
      pass
  with tracing.span('train.step'):
    pass
  spans = tracing.snapshot()['spans']
  assert {name: s['count'] for name, s in spans.items()} == {
      'serve.step': 1, 'serve.step.upload': 1, 'serve.step.replay': 2,
      'serve.step.replay.inner': 1, 'train.step': 1}
  assert spans['serve.step.replay']['device_ms'] == []
  outer, inner = spans['serve.step']['host_ms'], spans[
      'serve.step.upload']['host_ms']
  assert 0 <= inner[0] <= outer[0]


def test_a_span_left_by_an_exception_is_recorded_and_closed():
  with pytest.raises(ValueError):
    with tracing.span('serve.call'):
      with tracing.span('upload'):
        raise ValueError('bad input')
  with tracing.span('serve.poses'):
    pass
  assert set(tracing.snapshot()['spans']) == {
      'serve.call', 'serve.call.upload', 'serve.poses'}


def test_rings_keep_the_last_values_and_the_count(monkeypatch):
  monkeypatch.setattr(tracing, 'RING', 3)
  tracing.reset()
  for _ in range(5):
    with tracing.span('serve.step'):
      pass
  record = tracing.snapshot()['spans']['serve.step']
  assert record['count'] == 5 and len(record['host_ms']) == 3


def test_counters_add_and_reset():
  tracing.counter('serve.calls')
  tracing.counter('serve.calls', 2)
  tracing.counter('splat.fast_launches', -1)
  assert tracing.count('serve.calls') == 3
  assert tracing.count('never.counted') == 0
  assert tracing.snapshot()['counters'] == {'serve.calls': 3,
                                            'splat.fast_launches': -1}
  tracing.reset()
  assert tracing.snapshot() == {'counters': {}, 'dropped': 0, 'spans': {}}


def test_profiler_ranges_only_while_a_session_records(tmp_path):
  """A schedule's warm-up phase records nothing; its active phase gets
  one range per span under the span's full name, the sequence number of
  its outermost span as the input."""
  path = tmp_path / 'trace.json'
  with profile(activities=[ProfilerActivity.CPU], record_shapes=True,
               schedule=schedule(wait=0, warmup=1, active=1, repeat=1),
               on_trace_ready=lambda p: p.export_chrome_trace(str(path))
               ) as prof:
    with tracing.span('serve.call'):
      with tracing.span('upload'):
        pass
    prof.step()
    with tracing.span('serve.step'):
      with tracing.span('replay'):
        torch.ones(4).add_(1)
    prof.step()
  with tracing.span('serve.poses'):
    pass
  events = json.loads(path.read_text())['traceEvents']
  ranges = {e['name']: e for e in events
            if e.get('cat') == 'user_annotation'}
  assert {'serve.step', 'serve.step.replay'} <= set(ranges)
  assert not {'serve.call', 'serve.call.upload', 'serve.poses'} & set(ranges)
  outer, inner = ranges['serve.step'], ranges['serve.step.replay']
  assert outer['ts'] <= inner['ts'] and (
      inner['ts'] + inner['dur'] <= outer['ts'] + outer['dur'])
  assert outer['args']['Concrete Inputs'] == inner['args']['Concrete Inputs']
  assert outer['args']['Concrete Inputs'] == ['2']  # the second call


class _StubGraph:
  """Stands in for torch.cuda.CUDAGraph: replay runs nothing."""

  def replay(self):
    pass


def _stub_programs(captured):
  def capture(graph, pool):
    captured.append(graph)
    return contextlib.nullcontext()

  return graphs.Programs(capture=capture, new_graph=_StubGraph,
                         pool=('stub', 0))


def test_programs_record_eager_capture_and_replay():
  """A key's first call runs eagerly, its second captures and replays,
  later calls replay; a capture's splat launches are taken back and added
  at each replay."""
  captured = []
  programs = _stub_programs(captured)

  def fn(x):
    tracing.counter('splat.fast_launches', 2)
    return {'y': x + 1}

  with tracing.span('serve.call'):
    out = programs.run('p', fn, lambda: (torch.zeros(3),))
  assert torch.equal(out['y'], torch.ones(3))
  for i in range(3):
    with tracing.span('serve.call'):
      programs.run('p', fn, lambda: (torch.full((3,), float(i)),))
  snapshot = tracing.snapshot()
  assert {name: s['count'] for name, s in snapshot['spans'].items()} == {
      'serve.call': 4, 'serve.call.upload': 4, 'serve.call.eager': 1,
      'serve.call.capture': 1, 'serve.call.replay': 3,
      'serve.call.copy_out': 3}
  assert snapshot['counters'] == {'serve.eager_runs': 1,
                                  'serve.captures': 1, 'serve.replays': 3,
                                  'splat.fast_launches': 2 + 3 * 2}
  assert len(captured) == 1


def test_served_calls_record_their_spans():
  """The entry points of a model whose programs capture with the
  stand-in: each call is one entry span with its parts, and counts."""
  cfg = dataclasses.replace(config_t.get_test_config(), memory_frames=2,
                            memory_mode='ring')
  model = inference_t.SE3DSModel(cfg, device='cpu',
                                 generator=torch.Generator().manual_seed(0))
  model.graphs = _stub_programs([])
  rs = np.random.RandomState(0)
  pano = (rs.randint(0, 256, (1, 32, 64, 3)).astype(np.int32),
          rs.randint(0, 42, (1, 32, 64, 1)).astype(np.int32),
          rs.uniform(0.05, 0.6, (1, 32, 64)).astype(np.float32))
  model.add_to_memory(*pano, np.zeros((1, 3), np.float32))
  for i in range(4):
    model(np.full((1, 3), 0.1 * i, np.float32), add_preds_to_memory=True)
  model.predict_poses(np.zeros((2, 3), np.float32))
  counts = {name: s['count']
            for name, s in tracing.snapshot()['spans'].items()}
  assert counts['serve.build'] == 1
  assert counts['serve.add'] == counts['serve.add.upload'] == 1
  assert counts['serve.add.eager'] == 1
  # Frame buckets 1, 2, 2, 2: eager, eager, capture, replay.
  assert counts['serve.step'] == counts['serve.step.upload'] == 4
  assert counts['serve.step.eager'] == 2
  assert counts['serve.step.capture'] == 1
  assert counts['serve.step.replay'] == counts['serve.step.copy_out'] == 2
  assert counts['serve.poses.eager'] == 1
  assert tracing.count('serve.calls') == 6
  assert tracing.count('serve.captures') == 1
  assert tracing.count('serve.replays') == 2
  # The generator ran 4 steps (2 eager, 2 replayed; the capture's
  # convolutions taken back) and the poses once, every convolution in
  # channels_last memory.
  convs = sum(isinstance(m, (layers._Conv, layers.Conv2DTranspose))
              for m in model.model.modules())
  assert tracing.count('generator.convs') == 5 * convs > 0
  assert tracing.count('generator.nchw_convs') == 0


def test_a_train_step_records_its_parts():
  torch.manual_seed(0)
  state = state_t.create_train_state(
      gen_t.ResNetGenerator(spectral_fold=False, gen_dims=2, z_dim=2,
                            resnet_version='tiny'),
      disc_t.SNMultiScaleDiscriminator(n_dis=2, dis_dims=2, n_layers=3),
      g_lr=1e-4, d_lr=4e-4, beta1=0.5, beta2=0.999)
  h, w = 32, 64
  batch = {'image': torch.rand(4, h, w, 3), 'depth': torch.rand(4, h, w, 1),
           'proj_image': torch.rand(4, h, w, 3),
           'proj_depth': torch.rand(4, h, w, 1),
           'proj_mask': torch.ones(4, h, w, 1),
           'blurred_mask': torch.zeros(4, h, w, 1)}
  hp = state_t.GANHParams(d_step_per_g_step=2, num_batched_steps=2)
  state_t.train_step(state, batch, hp)
  spans = tracing.snapshot()['spans']
  parts = ('d_update.backward', 'd_update.clip', 'd_update.adam')
  assert set(spans) == {
      'train.step', 'train.step.d_only', 'train.step.g_d',
      'train.step.g_d.backward', 'train.step.g_d.clip',
      'train.step.g_d.adam', 'train.step.g_d.ema',
      'train.step.d_only.d_update', 'train.step.g_d.d_update',
      *(f'train.step.{p}.{part}' for p in ('d_only', 'g_d')
        for part in parts)}
  assert all(s['count'] == 1 for s in spans.values())
  assert tracing.count('train.steps') == 1
