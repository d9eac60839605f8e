"""The port's entry point, `python -m se3ds_torch.main`, on the CPU.

`main([... '--device', 'cpu'])` with configs/tiny_test.gin on fixture
TFRecords (8 image pairs at 64x128; 2 videos each in val_seen and
val_unseen): TRAIN leaves the JAX package's artifacts (a step directory,
TRAIN_DONE, operative configs, an event file) and resumes; TEST writes
`scores_val_seen.csv` with the JAX package's result keys and the PNG
dumps in its layout; TEST_UNSEEN evaluates a JAX trainer's fresh state,
carried across with `folding.load_train_state_from_flax`, against the JAX
package on the same display batch. Without a card and without
`--device`, the CLI raises.

Tolerances of the parity case (float32): `rmse@1` and `ema_rmse@1`
within rtol 1e-4 of the JAX rollouts' mean RMSE; the dumped RGB and depth
PNGs within 1 in uint8 (a float32 difference of ~1e-6 crosses a
truncation edge) on all but 0.1% of their values (a guidance pixel that
an ULP of trigonometry moves changes the generator's output around it;
none was off by more than 1 here, and the RMSE agreed to 1e-7).
FID and IS are only checked finite: the augmentation before Inception
draws from a `torch.Generator`, the JAX package's from a PRNG key.
"""

import csv
import glob
import os
import struct

import jax
import numpy as np
import pytest
import torch

from se3ds_torch import config as config_t
from se3ds_torch import main as main_t
from se3ds_torch.data import example_pb as example_pb_t
from se3ds_torch.data import png as png_t
from se3ds_torch.data import synthetic as synthetic_t
from se3ds_torch.data import tfrecord as tfrecord_t
from se3ds_torch.models import folding as folding_t
from se3ds_torch.train import checkpoints as ckpt_t
from se3ds_tpu import config as config_j
from se3ds_tpu.eval import metrics as metrics_j
from se3ds_tpu.train import trainer as trainer_j  # noqa: F401 (registers GAN)
from test_torch_train import _numpy_state
from test_torch_train_layers import _compiled
from test_torch_serving import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures('one_torch_thread')

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = os.path.join(REPO, 'configs', 'tiny_test.gin')
METRICS = ('fid', 'ema_fid', 'rmse', 'ema_rmse', 'inception_score',
           'ema_inception_score')
FRAMES = 2  # tiny_test.gin's eval_seq_len
EXAMPLES = 2  # videos per split
RMSE_RTOL = 1e-4
PNG_OFF_SHARE = 0.001


@pytest.fixture(scope='module')
def data_dir(tmp_path_factory):
  d = tmp_path_factory.mktemp('cli')
  synthetic_t.write_image_fixture(str(d / 'train-0.tfrecord'),
                                  num_examples=8, height=64)
  for split, seed in (('val_seen', 0), ('val_unseen', 1)):
    synthetic_t.write_video_fixture(str(d / f'{split}-0.tfrecord'),
                                    num_examples=EXAMPLES, height=64,
                                    seed=seed)
  return d


def _bindings(data_dir):
  """One epoch of 8 examples: 8 // (2 per chunk * 2 chunks) = 2 steps,
  saved at step 2 (save_every_steps), which the eval polls for."""
  return [f"R2RImageDataset.data_dir = '{data_dir}/'",
          f"R2RVideoDataset.data_dir = '{data_dir}/'",
          'GAN.num_epochs = 1',
          "R2RImageDataset.num_examples_override = {'train': 8, 'val': 4}"]


def _argv(data_dir, model_dir, mode, device='cpu'):
  argv = ['--model_dir', str(model_dir), '--mode', mode, '--gin_config', TINY]
  for binding in _bindings(data_dir):
    argv += ['--gin_bindings', binding]
  return argv + (['--device', device] if device else [])


@pytest.fixture(scope='module')
def trained(data_dir, tmp_path_factory):
  model_dir = tmp_path_factory.mktemp('model')
  assert main_t.main(_argv(data_dir, model_dir, 'TRAIN')) == 0
  return model_dir


def _result_keys(split):
  """The JAX package's result keys (se3ds_tpu/train/trainer.py:571-578)."""
  return {f'{split}/eval_image/{m}@{i}' for m in METRICS
          for i in range(1, FRAMES)}


def _scores(model_dir, split):
  with open(os.path.join(model_dir, f'scores_{split}.csv')) as f:
    return list(csv.DictReader(f))


def _png_layout(model_dir, split, step):
  """The dumped PNGs relative to images/{split}/{step}/."""
  root = os.path.join(model_dir, 'images', split, str(step))
  return sorted(os.path.relpath(p, root)
                for p in glob.glob(os.path.join(root, '*', '*.png')))


def _jax_png_layout():
  return sorted(f'{frame}/{example}_{suffix}.png'
                for suffix in ('rgb', 'depth') for example in range(EXAMPLES)
                for frame in range(FRAMES))


def _event_scalars(model_dir):
  """{tag: value} of the scalar summaries in the event files."""
  fields = lambda b: example_pb_t.iter_fields(b, 0, len(b))
  out = {}
  for path in glob.glob(os.path.join(model_dir, 'events.out.tfevents.*')):
    for record in tfrecord_t.read_records(path, verify_crc=True):
      for field, summary in fields(record):
        if field != 5:  # Event.summary
          continue
        for _, value in fields(summary):  # Summary.value
          value = dict(fields(value))
          if 2 in value:  # Value.simple_value
            out[bytes(value[1]).decode()] = struct.unpack('<f', value[2])[0]
  return out


def test_train_leaves_the_jax_artifacts_and_resumes(data_dir, trained):
  assert ckpt_t.CheckpointManager(str(trained)).all_steps() == [2]
  assert ckpt_t.is_training_done(str(trained))
  assert {os.path.basename(p) for p in glob.glob(
      str(trained / 'operative_config-*.gin'))} == {
          'operative_config-0.gin', 'operative_config-2.gin'}
  operative = (trained / 'operative_config-2.gin').read_text()
  assert "R2RImageDataset.data_dir = '" in operative
  assert 'ResNetGenerator.image_size = 32' in operative
  assert glob.glob(str(trained / 'events.out.tfevents.*'))
  # A second TRAIN restores step 2 and has nothing left to do.
  assert main_t.main(_argv(data_dir, trained, 'train')) == 0
  assert ckpt_t.CheckpointManager(str(trained)).all_steps() == [2]


def test_test_writes_jax_scores_and_pngs(data_dir, trained):
  assert main_t.main(_argv(data_dir, trained, 'TEST')) == 0
  (row,) = _scores(trained, 'val_seen')
  assert row['checkpoint_path'] == os.path.join(str(trained), '2')
  assert row['step'] == '2'
  keys = _result_keys('val_seen')
  assert keys <= set(row)
  assert not [k for k in row if '/eval_image/' in k and k not in keys]
  for key in keys:
    assert np.isfinite(float(row[key])), (key, row[key])
  assert _png_layout(trained, 'val_seen', 2) == _jax_png_layout()
  for path in glob.glob(str(trained / 'images/val_seen/2/*/*.png')):
    image = png_t.decode_png(open(path, 'rb').read())
    assert image.shape == (32, 64, 3) and image.dtype == np.uint8


def test_test_unseen_matches_jax(data_dir, tmp_path, monkeypatch):
  """A JAX trainer's fresh state (its EMA scaled by 0.95, so the raw and
  the EMA generator differ) saved as a port checkpoint at step 2, then
  `--mode TEST_UNSEEN`; the JAX trainer's eval image grid on the same
  display batch gives the reference PNGs, and its two rollouts (raw, then
  EMA) the reference RMSE. The JAX state and generator apply are compiled
  (at XLA's lowest backend level, as the layer tests compile theirs)."""
  config_j.clear_config()
  config_j.parse_config_files_and_bindings([TINY], _bindings(data_dir))
  jax_trainer = config_j.apply_config('GAN', model_dir=str(tmp_path / 'jax'),
                                      test_split='val_unseen')
  jax_trainer._build_models()
  jax_trainer._create_data(for_train=False)
  jax_state = jax.device_get(_compiled(jax_trainer._create_state)())
  jax_state = jax_state.replace(ema_params=jax.tree_util.tree_map(
      lambda p: p * 0.95, jax_state.g_params))
  config_j.clear_config()

  model_dir = tmp_path / 'port'
  config_t.clear_config()
  config_t.parse_config_files_and_bindings([TINY], _bindings(data_dir))
  port = config_t.apply_config('GAN', model_dir=str(model_dir), device='cpu')
  state = port.create_state()
  folding_t.load_train_state_from_flax(state, _numpy_state(jax_state))
  state.step = 2
  ckpt_t.CheckpointManager(str(model_dir)).save(state.step, state)
  ckpt_t.mark_training_done(str(model_dir))
  assert main_t.main(_argv(data_dir, model_dir, 'TEST_UNSEEN')) == 0

  (row,) = _scores(model_dir, 'val_unseen')
  keys = _result_keys('val_unseen')
  assert keys <= set(row)
  for key in keys:
    assert np.isfinite(float(row[key])), (key, row[key])
  scalars = _event_scalars(model_dir)

  batch = next(jax_trainer.eval_ds_factory())
  cond = {k: np.zeros((EXAMPLES, 32, 64, c), np.float32) for k, c in (
      ('prev_image', 3), ('proj_image', 3), ('proj_mask', 1),
      ('proj_depth', 1), ('blurred_mask', 1))}
  jax_trainer._generator_apply_eval = _compiled(
      jax_trainer._generator_apply_eval, jax_trainer._variables(jax_state),
      cond)
  rollouts = []
  rollout = metrics_j.rollout_generated
  monkeypatch.setattr(metrics_j, 'rollout_generated',
                      lambda *a, **k: rollouts.append(rollout(*a, **k))
                      or rollouts[-1])
  _, outputs = jax_trainer._get_image_grid(jax_state, 'eval',
                                           display_batch=batch)
  for prefix, (_, rmse, _) in zip(('', 'ema_'), rollouts):
    np.testing.assert_allclose(
        scalars[f'val_unseen/eval_image/{prefix}rmse@1'],
        np.mean(np.asarray(rmse[1])), rtol=RMSE_RTOL)

  assert _png_layout(model_dir, 'val_unseen', 2) == _jax_png_layout()
  for suffix, key in (('rgb', 'ema_generated_image'),
                      ('depth', 'ema_pred_depth')):
    for example in range(EXAMPLES):
      for frame in range(FRAMES):
        want = (np.clip(outputs[key][example * FRAMES + frame], 0, 1)
                * 255).astype(np.uint8).astype(np.int32)
        path = model_dir / f'images/val_unseen/2/{frame}/{example}_{suffix}.png'
        got = png_t.decode_png(path.read_bytes()).astype(np.int32)
        off = np.abs(got - want)
        assert (off > 1).mean() <= PNG_OFF_SHARE, (path, int((off > 1).sum()))


def test_cli_runs_on_the_card_unless_asked(data_dir, tmp_path, monkeypatch):
  monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
  with pytest.raises(RuntimeError, match='CUDA'):
    main_t.main(_argv(data_dir, tmp_path, 'TRAIN', device=None))


def test_prefetch_propagates_producer_failure(tmp_path):
  """A dying prefetch producer surfaces its error to the consumer instead
  of hanging it (the JAX test_prefetch_propagates_producer_failure)."""
  config_t.clear_config()
  config_t.parse_config_files_and_bindings([TINY])
  trainer = config_t.apply_config('GAN', model_dir=str(tmp_path),
                                  device='cpu')
  trainer.train_ds = iter(())  # immediately exhausted -> StopIteration
  clusters = trainer._prefetch_clusters(1)
  try:
    with pytest.raises(RuntimeError, match='producer failed'):
      next(clusters)
  finally:
    clusters.close()
