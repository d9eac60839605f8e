"""The readers of the program's own spans and counters
(`se3ds_torch.tracing`) on hand-built snapshots: each reads its number,
and nothing where the program keeps no such span or counter, as a
program without the registry (its module cannot be imported) keeps
none."""

import sys

import pytest

from benchmark import harness

READERS = ('api_host_ms.serve', 'device_ms_per_pano.serve', 'captures.serve',
           'build_s.serve', 'update_host_ms.train', 'update_device_ms.train')


def _span(host_ms, device_ms=()):
  return {'count': len(host_ms), 'host_ms': list(host_ms),
          'device_ms': list(device_ms)}


SERVING = {
    'counters': {'serve.calls': 12, 'serve.captures': 2,
                 'serve.replays': 8, 'serve.eager_runs': 3},
    'dropped': 0,
    'spans': {
        'serve.build': _span([4000.0]),
        'serve.add': _span([2.0]),
        'serve.add.eager': _span([500.0]),
        'serve.step': _span([30.0, 1.1, 1.3, 1.2, 90.0],
                            [50.0, 47.0, 48.0, 47.5, 60.0]),
        'serve.step.eager': _span([1500.0, 20.0]),
        'serve.step.capture': _span([250.0, 230.0]),
        'serve.step.replay': _span([0.1] * 3),
        'serve.poses': _span([1.0, 9.0], [100.0, 200.0]),
    }}

TRAINING = {
    'counters': {'train.steps': 3},
    'dropped': 0,
    'spans': {
        'train.step': _span([2200.0] * 3, [2230.0] * 3),
        'train.step.g_d.adam': _span([3.0, 5.0, 4.0], [20.0, 24.0, 22.0]),
        'train.step.g_d.clip': _span([6.0, 6.0, 9.0], [7.0, 7.0, 8.0]),
        'train.step.g_d.ema': _span([1.0, 2.0, 3.0], [10.0, 11.0, 12.0]),
        'train.step.d_only.d_update.adam': _span([1.0] * 3, [2.0] * 3),
        'train.step.d_only.d_update.backward': _span([50.0] * 3,
                                                     [900.0] * 3),
        'train.step.g_d.adam_like': _span([99.0] * 3, [99.0] * 3),
    }}

EMPTY = {'counters': {}, 'dropped': 0, 'spans': {}}


class _Cell:
  def __init__(self, traffic):
    self.traffic = traffic


class _Record:
  def __init__(self, traffic=None):
    self.cell = _Cell(traffic or {})


@pytest.fixture
def snapshot(monkeypatch):
  from se3ds_torch import tracing

  def use(value):
    monkeypatch.setattr(tracing, 'snapshot', lambda: value)
  return use


@pytest.mark.parametrize('name,snap,traffic,want', [
    ('api_host_ms.serve', SERVING, {}, 1.3),
    ('device_ms_per_pano.serve', SERVING, {}, 48.0),
    ('device_ms_per_pano.serve', SERVING, {'poses_per_call': 8}, 6.0),
    ('captures.serve', SERVING, {}, 2.0),
    ('build_s.serve', SERVING, {}, 6.5),
    ('update_host_ms.train', TRAINING, {}, 4.0 + 6.0 + 2.0 + 1.0),
    ('update_device_ms.train', TRAINING, {}, 22.0 + 7.0 + 11.0 + 2.0),
])
def test_reads_its_number(snapshot, name, snap, traffic, want):
  snapshot(snap)
  assert harness.reader(name)(_Record(traffic)) == pytest.approx(want)


OTHER_KIND = ([(name, EMPTY) for name in READERS]
              + [(name, TRAINING) for name in READERS if '.serve' in name]
              + [(name, SERVING) for name in READERS if '.train' in name])


@pytest.mark.parametrize('name,snap', OTHER_KIND)
def test_reads_nothing_where_the_program_keeps_none(snapshot, name, snap):
  """Each reader reads nothing of an empty registry, and the serving and
  training readers nothing of the other kind's spans."""
  snapshot(snap)
  assert harness.reader(name)(_Record()) is None


@pytest.mark.parametrize('name', READERS)
def test_a_program_without_the_registry_reads_nothing(snapshot, monkeypatch,
                                                      name):
  import se3ds_torch
  snapshot(SERVING if name.endswith('.serve') else TRAINING)
  assert harness.reader(name)(_Record()) is not None
  monkeypatch.delattr(se3ds_torch, 'tracing')
  monkeypatch.setitem(sys.modules, 'se3ds_torch.tracing', None)
  assert harness.reader(name)(_Record()) is None


def test_no_device_time_reads_nothing(snapshot):
  served = {**SERVING, 'spans': {'serve.step': _span([1.0, 2.0])}}
  snapshot(served)
  assert harness.reader('device_ms_per_pano.serve')(_Record()) is None
  assert harness.reader('api_host_ms.serve')(_Record()) == 1.5
