"""Rematerialisation: a train step with `remat=True` against the same step
storing its activations, float32 CPU, from one state.

The stored-activation step is held to the JAX package in
tests/test_torch_train.py (and JAX's own remat step to its non-remat one
in tests/test_train.py), so remat is held to the port's step here. On the
CPU the recompute runs the same kernels on the same inputs, so the two
steps are compared exactly: metrics, parameters, both Adam moments, every
`u`, every BatchNorm statistic and the EMA. A recompute that read the
advanced `u` would change the gradients; one that wrote state would move
`u` or the statistics twice.
"""

import copy

import pytest
import torch

from se3ds_torch.models import layers
from se3ds_torch.train import checkpoints as ckpt_t
from se3ds_torch.train import state as state_t
from test_torch_serving import one_torch_thread  # noqa: F401
from test_torch_train import _batch
from test_torch_train import _tiny_trainer

pytestmark = pytest.mark.usefixtures('one_torch_thread')


def _steps(trainer, remat, seeds=(1, 2)):
  """Two steps (the EMA assign step, then a decay step) from the
  trainer's seeded state; returns (start bundle, state, metrics, number
  of checkpointed segments)."""
  state = trainer.create_state()
  start = copy.deepcopy(ckpt_t.state_bundle(state))
  hp = trainer.hp._replace(remat=remat, num_batched_steps=1)
  segments = []
  checkpoint = layers.checkpoint_lib.checkpoint

  def counted(*args, **kwargs):
    segments.append(1)
    return checkpoint(*args, **kwargs)

  layers.checkpoint_lib.checkpoint = counted
  try:
    metrics = [state_t.train_step(state, trainer.device_batch(_batch(s)), hp)
               for s in seeds]
  finally:
    layers.checkpoint_lib.checkpoint = checkpoint
  return start, state, metrics, len(segments)


@pytest.fixture(scope='module')
def both(tmp_path_factory):
  trainer = _tiny_trainer(tmp_path_factory.mktemp('remat'))
  return _steps(trainer, False), _steps(trainer, True)


def test_remat_checkpoints_segments(both):
  (_, _, _, stored), (_, _, _, remat) = both
  assert stored == 0
  # Per step: G in the G+D step, D at eval in the G loss, D in each of the
  # two D updates; each model runs many segments.
  assert remat > 100


def test_remat_step_equals_stored_step(both):
  """Every metric and every tensor of the bundle (G, D, EMA, both Adam
  states, the step) equal, bit for bit."""
  (start_a, a, metrics_a, _), (start_b, b, metrics_b, _) = both
  assert ckpt_t.bundles_equal(start_a, start_b)
  for ma, mb in zip(metrics_a, metrics_b):
    assert ma.keys() == mb.keys()
    for key in ma:
      assert torch.equal(ma[key], mb[key]), key
  assert ckpt_t.bundles_equal(ckpt_t.state_bundle(a), ckpt_t.state_bundle(b))


@pytest.mark.parametrize('part', ['generator', 'discriminator',
                                  'ema_generator'])
def test_state_advanced_once(both, part):
  """The recompute writes no state: after two steps every `u` and every
  BatchNorm statistic moved from the start (G's BatchNorms in all four
  G forwards, D's `u` in its four training forwards), and equals the
  stored-activation step's, which moves them once per forward."""
  (start, a, _, _), (_, b, _, _) = both
  after_a = ckpt_t.state_bundle(a)[part]
  after_b = ckpt_t.state_bundle(b)[part]
  buffers = [k for k in start[part] if k.endswith(('.u', 'running_mean',
                                                   'running_var'))]
  assert buffers
  for key in buffers:
    assert torch.equal(after_a[key], after_b[key]), key
    assert not torch.equal(after_b[key], start[part][key]), key


def test_trainer_accepts_remat(tmp_path):
  assert _tiny_trainer(tmp_path, remat=True).hp.remat
