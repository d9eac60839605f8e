"""A run whose timed path is broken underneath comes out not correct:
each fault a cell can have, planted in the program at a test size on the
CPU, against the cell's own limits (`workloads/<cell>.json`). No cell
spans chips, so no exchange between chips can be left out."""

import pytest
import torch

from benchmark.tests import conftest


def _unchanged_memory(monkeypatch):
  """Each served step leaves the memory as it was."""
  from se3ds_torch.models import inference
  original = inference.SE3DSModel._step_forward

  def step(self, memory, *args, **kwargs):
    scratch = memory._replace(**{f: getattr(memory, f).clone() for f in
                                 ('coords', 'feats', 'rgb_coords', 'rgb')})
    return original(self, scratch, *args, **kwargs)

  monkeypatch.setattr(inference.SE3DSModel, '_step_forward', step)


def _altered_answer(monkeypatch):
  """Every served depth is off by 2% of its scale where it is produced."""
  from se3ds_torch.models import inference
  original = inference.SE3DSModel._to_output_data

  def to_output(out):
    out = dict(out, pred_depth=out['pred_depth'] + 0.02)
    return original(out)

  monkeypatch.setattr(inference.SE3DSModel, '_to_output_data',
                      staticmethod(to_output))


def _half_the_poses(monkeypatch):
  """The second half of each call's poses is the first half again."""
  from se3ds_torch.models import inference
  original = inference.SE3DSModel._to_output_data

  def to_output(out):
    k = out['pred_rgb_u8'].shape[0]
    half = {key: torch.cat([v[:k // 2], v[:k - k // 2]])
            for key, v in out.items() if key.startswith('pred')}
    return original(dict(out, **half))

  monkeypatch.setattr(inference.SE3DSModel, '_to_output_data',
                      staticmethod(to_output))


def _unchanged_state(monkeypatch):
  """The optimizers step nothing: the train state stays as it was."""
  from se3ds_torch.parallel import mesh
  monkeypatch.setattr(mesh.Zero1Adam, 'step', lambda self, grads: None)


def _discriminator(monkeypatch, change):
  """Applies `change` to the discriminator's optimizer as it is made."""
  from se3ds_torch.train import state as state_lib
  original = state_lib.make_optimizers

  def make(*args, **kwargs):
    g_opt, d_opt = original(*args, **kwargs)
    change(d_opt)
    return g_opt, d_opt

  monkeypatch.setattr(state_lib, 'make_optimizers', make)


def _unchanged_discriminator(monkeypatch):
  """The discriminator's optimizer steps nothing; the generator trains."""
  def freeze(d_opt):
    d_opt.step = lambda grads: None
  _discriminator(monkeypatch, freeze)


def _generator_lr_for_the_discriminator(monkeypatch):
  """The discriminator steps at the generator's learning rate (a quarter
  of its own in the highres recipe)."""
  def slow(d_opt):
    for group in d_opt.param_groups:
      group['lr'] = group['lr'] / 4
  _discriminator(monkeypatch, slow)


def _half_the_batch(monkeypatch):
  """Each chunk's second half of rows is left out; the means are taken
  over the rest."""
  from se3ds_torch.train import state as state_lib
  original = state_lib.split_batch

  def split(batch, k):
    return [{key: v[:v.shape[0] // 2] for key, v in chunk.items()}
            for chunk in original(batch, k)]

  monkeypatch.setattr(state_lib, 'split_batch', split)


@pytest.mark.parametrize('name, fault', [
    ('serve-traj-ring', _unchanged_memory),
    ('serve-traj-ring', _altered_answer),
    ('serve-poses-k8', _altered_answer),
    ('serve-poses-k8', _half_the_poses),
    ('train-highres-remat', _unchanged_state),
    ('train-highres-remat', _half_the_batch),
    ('train-highres-remat', _unchanged_discriminator),
    ('train-highres-remat', _generator_lr_for_the_discriminator),
], ids=lambda x: getattr(x, '__name__', x))
def test_a_broken_run_is_not_correct(monkeypatch, name, fault):
  fault(monkeypatch)
  cell = conftest.tiny(name)
  assert not conftest.correct(cell, conftest.run_tiny(name))


@pytest.mark.parametrize('name', ['serve-traj-ring', 'serve-poses-k8',
                                  'train-highres-remat'])
def test_a_sound_run_is_correct(name):
  cell = conftest.tiny(name)
  assert conftest.correct(cell, conftest.run_tiny(name))
