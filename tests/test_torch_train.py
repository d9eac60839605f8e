"""Port parity: the training slice against the JAX package, float32 CPU.

The losses, the per-tensor clip, the gradient-norm metric and the EMA
schedule against `se3ds_tpu.train`, and one full `train_step` at the
sizes of tests/test_train.py (image 32, gen_dims 2, ResNet 'tiny', D
dis_dims 2 n_layers 3, batch 4 = 2 chunks): the same random JAX
`TrainState` goes through the jitted JAX step and, carried across by
`folding.load_train_state_from_flax`, through the port's step; the JAX
result, carried across by the same bridge, is compared with the port's.
Then the port alone: the checkpoint round trip, and `Trainer.train`
against `train_step` called by hand.

Tolerances of the step (`state_differences`), float32: at this size the
train-mode BatchNorms normalise over 4 elements per channel at the 1x2
bottleneck, which amplifies rounding: the port's own float32 step
differs from its float64 step by some 1e-4 of the largest first Adam
moment (0.5 g after one step; chip_smoke phase 7b prints this for its
batch). So: the moments 1e-3 of the
largest moment of the model, the metrics (the gradient norms among them)
rtol 1e-3; parameters, after Adam's first steps of about lr * sign(g),
atol 1e-5 where |first moment| >= 1e-3 of the largest (below that the
sign of a gradient within its rounding error of 0 is noise, and those
elements are counted, not compared); BatchNorm statistics and u 1e-5.
The JAX step is jitted as the layer tests jit theirs.
"""

import functools
import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from se3ds_torch.data import tfrecord
from se3ds_torch.models import discriminator as disc_t
from se3ds_torch.models import folding as folding_t
from se3ds_torch.models import generator as gen_t
from se3ds_torch.train import checkpoints as ckpt_t
from se3ds_torch.train import losses as losses_t
from se3ds_torch.train import state as state_t
from se3ds_torch.train import trainer as trainer_t
from se3ds_tpu.models import discriminator as disc_j
from se3ds_tpu.models import generator as gen_j
from se3ds_tpu.train import losses as losses_j
from se3ds_tpu.train import state as state_j
from test_torch_train_layers import _compiled
from test_torch_train_layers import _random_variables
from test_torch_serving import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures('one_torch_thread')

SIZE = 32
G_CONFIG = dict(gen_dims=2, z_dim=2, resnet_version='tiny')
D_CONFIG = dict(n_dis=2, dis_dims=2, n_layers=3)
OPT = dict(g_lr=1e-4, d_lr=4e-4, beta1=0.5, beta2=0.999)
HP = dict(d_step_per_g_step=2, num_batched_steps=2)
TOLERANCES = {'params': 1e-5, 'stats': 1e-5, 'u': 1e-5, 'exp_avg': 1e-3,
              'exp_avg_sq': 1e-3, 'adam_steps': 0.0}
METRIC_RTOL = 1e-3


def _batch(seed, n=4, size=SIZE):
  """A numpy train batch: depth in [-0.1, 1.1] (outside (0, 1) is
  invalid), 0/1 guidance and blurred masks."""
  rs = np.random.RandomState(seed)
  h, w = size, 2 * size
  batch = {'image': rs.rand(n, h, w, 3), 'depth': rs.uniform(-.1, 1.1,
                                                              (n, h, w, 1)),
           'proj_image': rs.rand(n, h, w, 3), 'proj_depth': rs.rand(n, h, w, 1),
           'proj_mask': rs.rand(n, h, w, 1) > 0.3,
           'blurred_mask': rs.rand(n, h, w, 1) > 0.8}
  return {k: v.astype(np.float32) for k, v in batch.items()}


def _torch(batch):
  return {k: torch.from_numpy(v) for k, v in batch.items()}


def _port_models():
  return (gen_t.ResNetGenerator(spectral_fold=False, **G_CONFIG),
          disc_t.SNMultiScaleDiscriminator(**D_CONFIG))


def _port_state(flax_state):
  state = state_t.create_train_state(*_port_models(), **OPT)
  folding_t.load_train_state_from_flax(state, flax_state)
  return state


def _numpy_state(state):
  """A JAX TrainState as the bridge reads it (numpy trees)."""
  state = jax.device_get(state)
  adam = lambda opt: {'mu': opt[0].mu, 'nu': opt[0].nu, 'count': opt[0].count}
  return {'step': state.step, 'g_params': state.g_params,
          'g_state': state.g_state, 'd_params': state.d_params,
          'd_state': state.d_state, 'ema_params': state.ema_params,
          'ema_state': state.ema_state,
          'g_opt_state': adam(state.g_opt_state),
          'd_opt_state': adam(state.d_opt_state)}


@pytest.fixture(scope='module')
def steps():
  """(port state after its step, JAX state after its step carried across,
  port metrics, JAX metrics)."""
  batch = _batch(1)
  generator = gen_j.ResNetGenerator(image_size=SIZE, **G_CONFIG)
  discriminator = disc_j.SNMultiScaleDiscriminator(**D_CONFIG)
  cond = {k: batch[k][:1] for k in ('proj_image', 'proj_depth', 'proj_mask',
                                    'blurred_mask')}
  g_vars = _random_variables(generator, 0, cond)
  d_vars = _random_variables(discriminator, 1, np.zeros((2, SIZE, 2 * SIZE, 4),
                                                        np.float32))
  g_tx, d_tx = state_j.make_optimizers(OPT['g_lr'], OPT['d_lr'],
                                       OPT['beta1'], OPT['beta2'])
  g_state = {k: v for k, v in g_vars.items() if k != 'params'}
  start = state_j.TrainState(
      step=jnp.zeros((), jnp.int32), g_params=g_vars['params'],
      g_state=g_state, d_params=d_vars['params'],
      d_state={'spectral': d_vars['spectral']}, ema_params=g_vars['params'],
      ema_state=g_state, g_opt_state=g_tx.init(g_vars['params']),
      d_opt_state=d_tx.init(d_vars['params']))
  step = functools.partial(state_j.train_step, generator=generator,
                           discriminator=discriminator, g_tx=g_tx, d_tx=d_tx,
                           hp=state_j.GANHParams(**HP))
  jax_state, jax_metrics = _compiled(step, start, batch)(start, batch)

  port = _port_state(_numpy_state(start))
  metrics = state_t.train_step(port, _torch(batch), state_t.GANHParams(**HP))
  return (port, _port_state(_numpy_state(jax_state)),
          {k: float(v) for k, v in metrics.items()},
          {k: float(v) for k, v in jax_metrics.items()})


def test_train_step_metrics_match_jax(steps):
  _, _, metrics, jax_metrics = steps
  assert metrics.keys() == jax_metrics.keys()
  for key, want in jax_metrics.items():
    np.testing.assert_allclose(metrics[key], want, rtol=METRIC_RTOL,
                               atol=1e-7, err_msg=key)


@pytest.mark.parametrize('part', ['g', 'd', 'ema'])
def test_train_step_state_matches_jax(steps, part):
  """Parameters, BatchNorm statistics, u and both Adam moments of G, of
  D and of the EMA generator (assigned in this first step)."""
  port, jax_state, _, _ = steps
  diffs = state_t.state_differences(port, jax_state)
  checked = {k: v for k, v in diffs.items() if k.startswith(part + '_')}
  assert checked
  for key, value in checked.items():
    assert value <= TOLERANCES[key.split('_', 1)[-1]], (key, value)
  # The gradient floor leaves out under half of the elements.
  assert diffs['excluded'] < diffs['compared']


def test_train_step_moves_like_jax(steps):
  """One step: step 1, both Adam counts (G one update, D two), and the
  EMA equal to G after the assign step."""
  port, jax_state, _, _ = steps
  assert port.step == jax_state.step == 1
  g_steps = {float(s['step']) for s in port.g_opt.state.values()}
  d_steps = {float(s['step']) for s in port.d_opt.state.values()}
  assert g_steps == {1.0} and d_steps == {2.0}
  for e, g in zip(port.ema.state_dict().values(),
                  port.generator.state_dict().values()):
    assert torch.equal(e, g)


# -- losses and schedule -----------------------------------------------------


def _maps(seed, shapes):
  rs = np.random.RandomState(seed)
  return [[rs.normal(size=s).astype(np.float32) for s in sub]
          for sub in shapes]


def test_losses_match_jax():
  """kld, wc, both hinge losses and the multiscale split; rtol 1e-6."""
  rs = np.random.RandomState(3)
  mu, logvar = (rs.normal(size=(2, 3, 4, 5)).astype(np.float32)
                for _ in range(2))
  gen, real = (rs.rand(3, 8, 16, 3).astype(np.float32) for _ in range(2))
  mask = (rs.rand(3, 8, 16, 1) > 0.5).astype(np.float32)
  mask[1] = 0.0  # an example without valid pixels
  cases = [
      (losses_t.kld_loss(torch.from_numpy(mu), torch.from_numpy(logvar)),
       losses_j.kld_loss(mu, logvar)),
      (losses_t.wc_loss(*map(torch.from_numpy, (gen, real, mask))),
       losses_j.wc_loss(gen, real, mask))]
  maps = _maps(4, [[(4, 5, 6, 2), (4, 3, 3, 1)], [(4, 3, 3, 2), (4, 2, 2, 1)]])
  fake_t, real_t = losses_t.split_disc_outputs(
      [[torch.from_numpy(m) for m in sub] for sub in maps])
  fake_j, real_j = losses_j.split_disc_outputs(maps)
  for a, b in zip(losses_t.multiscale_gan_losses(fake_t, real_t),
                  losses_j.multiscale_gan_losses(fake_j, real_j)):
    cases.append((a, b))
  for got, want in cases:
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
  assert [[tuple(m.shape) for m in sub] for sub in real_t] == [
      [tuple(m.shape) for m in sub] for sub in real_j]


def test_clip_and_mean_norm_match_jax():
  """Per-tensor clip_by_norm (one tensor above the clip, one below, one
  all-zero) and the mean of norms, NaN -> 0; rtol 1e-6."""
  rs = np.random.RandomState(5)
  grads = [rs.normal(size=(3, 4)).astype(np.float32) * 10,
           rs.normal(size=(5,)).astype(np.float32) * 0.1,
           np.zeros((2, 2), np.float32)]
  clipped = losses_t.clip_grad_per_leaf([torch.from_numpy(g) for g in grads],
                                        5.0)
  want = losses_j.clip_grad_per_leaf(grads, 5.0)
  for got, ref in zip(clipped, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6)
  np.testing.assert_allclose(float(losses_t.mean_leaf_norm(clipped)),
                             float(losses_j.mean_leaf_norm(want)), rtol=1e-6)
  nan = [torch.tensor([float('nan'), 1.0])]
  assert float(losses_t.mean_leaf_norm(nan)) == 0.0
  assert float(losses_j.mean_leaf_norm([np.array([np.nan, 1.0])])) == 0.0


def _arrays(named):
  return {name: t.detach().numpy().copy() for name, t in named}


@pytest.mark.parametrize('step', [0, 1, 2, 5])
def test_update_ema_matches_jax(step):
  """ema_init_step 1, num_batched_steps 2: step 0 leaves the EMA, steps
  1-2 assign, later steps decay; parameters and buffers alike (the
  discriminator's u stands in for the generator's state). Exact."""
  hp = dict(ema_init_step=1, num_batched_steps=2, ema_decay=0.9)
  ema, new = (disc_t.SNMultiScaleDiscriminator(**D_CONFIG) for _ in range(2))
  for seed, model in enumerate((ema, new)):
    folding_t.init_random_(model, torch.Generator().manual_seed(seed))
  want_params, want_buffers = state_j.update_ema(
      jnp.asarray(step), _arrays(ema.named_parameters()),
      _arrays(ema.named_buffers()), _arrays(new.named_parameters()),
      _arrays(new.named_buffers()), state_j.GANHParams(**hp))
  state_t.update_ema(step, ema, new, state_t.GANHParams(**hp))
  for want, got in ((want_params, ema.named_parameters()),
                    (want_buffers, ema.named_buffers())):
    for name, value in got:
      np.testing.assert_array_equal(value.detach().numpy(),
                                    np.asarray(want[name]), err_msg=name)


# -- checkpoints and the trainer (port only) ----------------------------------


def _tiny_trainer(model_dir, **kwargs):
  return trainer_t.Trainer(
      str(model_dir), image_size=SIZE, seed=0, train_batch_size=2,
      predict_depth=True, mask_blurred=True,
      generator_fn=lambda image_size: gen_t.ResNetGenerator(
          spectral_fold=False, **G_CONFIG),
      discriminator_fn=lambda image_size: disc_t.SNMultiScaleDiscriminator(
          **D_CONFIG),
      device='cpu', **{**OPT, **HP, **kwargs})


def test_checkpoint_round_trip(tmp_path):
  """save -> restore into a fresh state is bit-equal (modules, both
  optimizers, the step); saves are idempotent per step, the oldest go
  beyond max_to_keep, and the TRAIN_DONE sentinel."""
  trainer = _tiny_trainer(tmp_path)
  state = trainer.create_state()
  manager = ckpt_t.CheckpointManager(str(tmp_path), max_to_keep=2)
  assert manager.restore(state) is None and manager.latest_step() is None
  for _ in range(3):
    state_t.train_step(state, trainer.device_batch(_batch(state.step + 7)),
                       trainer.hp)
    manager.save(state.step, state)
  manager.save(state.step, state)  # a no-op
  assert manager.all_steps() == [2, 3] and manager.latest_step() == 3
  restored = trainer.create_state()
  assert manager.restore(restored) is restored
  assert ckpt_t.bundles_equal(ckpt_t.state_bundle(state),
                        ckpt_t.state_bundle(restored))
  assert restored.step == 3
  assert not ckpt_t.is_training_done(str(tmp_path))
  ckpt_t.mark_training_done(str(tmp_path))
  assert ckpt_t.is_training_done(str(tmp_path))


def _batches(seed):
  while True:
    yield _batch(seed)
    seed += 1


def test_trainer_train_equals_train_step_by_hand(tmp_path):
  """Trainer.train for 2 steps (log every step, save and image grid at
  step 2, then the final save) equals create_state + train_step twice on
  the same batches, bit for bit; it leaves one checkpoint, an event file
  with the scalars and the grid, and TRAIN_DONE."""
  trainer = _tiny_trainer(tmp_path / 'run', num_batched_steps=1,
                          log_every_steps=1, save_every_steps=2)
  state = trainer.train(_batches(10), num_train_steps=2)
  by_hand = _tiny_trainer(tmp_path / 'hand', num_batched_steps=1)
  expected = by_hand.create_state()
  for seed in (10, 11):
    state_t.train_step(expected, by_hand.device_batch(_batch(seed)),
                       by_hand.hp)
  assert ckpt_t.bundles_equal(ckpt_t.state_bundle(state),
                        ckpt_t.state_bundle(expected))
  run = str(tmp_path / 'run')
  assert ckpt_t.CheckpointManager(run).all_steps() == [2]
  assert ckpt_t.is_training_done(run)
  (events,) = glob.glob(os.path.join(run, 'events.out.tfevents.*'))
  records = list(tfrecord.read_records(events, verify_crc=True))
  # The version record, 2 x 13 scalars, 9 grid images.
  assert len(records) == 1 + 2 * 13 + 9
  # A second train() restores step 2 and has nothing left to do.
  again = trainer.train(_batches(10), num_train_steps=2)
  assert again.step == 2


# -- the framework-free helpers the trainer keeps copies of -------------------


def test_parameter_overview_matches_jax():
  """The table of a module's parameters equals the JAX package's table
  of the same arrays under the same '/'-joined names."""
  from se3ds_torch.utils import parameter_overview as overview_t
  from se3ds_tpu.utils import parameter_overview as overview_j
  model = disc_t.SNMultiScaleDiscriminator(**D_CONFIG)
  folding_t.init_random_(model, torch.Generator().manual_seed(0))
  tree = {}
  for name, param in model.named_parameters():
    *path, leaf = name.split('.')
    node = tree
    for part in path:
      node = node.setdefault(part, {})
    node[leaf] = param.detach().numpy()
  assert (overview_t.get_parameter_overview(model, include_stats=False)
          == overview_j.get_parameter_overview(tree, include_stats=False))
  assert overview_t.count_parameters(model) == overview_j.count_parameters(
      tree)


def test_image_grid_and_event_encoding_match_jax(tmp_path):
  """The grid images and the scalar/image Summary encodings are the JAX
  package's bytes; the event file reads back with valid checksums."""
  from se3ds_torch.utils import image_grid as grid_t
  from se3ds_torch.utils import logger as logger_t
  from se3ds_tpu.utils import image_grid as grid_j
  from se3ds_tpu.utils import logger as logger_j
  images = np.random.RandomState(6).rand(7, 4, 6, 3).astype(np.float32)
  got = grid_t.get_grid_image_dict(images, 5, 'train_x')
  want = grid_j.get_grid_image_dict(images, 5, 'train_x')
  assert got.keys() == want.keys()
  for key in got:
    np.testing.assert_array_equal(got[key], want[key])
  image = got['train_x'][0]
  assert (logger_t._encode_summary_value_image('g', image)
          == logger_j._encode_summary_value_image('g', image))
  assert (logger_t._encode_summary_value_scalar('gen/gen_loss', 1.25)
          == logger_j._encode_summary_value_scalar('gen/gen_loss', 1.25))
  log = logger_t.UniversalLogger(str(tmp_path), step=0)
  log.log_scalars(3, a=1.0, b=2.0)
  log.log_images(3, g=got['train_x'])
  log.close()
  (events,) = glob.glob(str(tmp_path / 'events.out.tfevents.*'))
  assert len(list(tfrecord.read_records(events, verify_crc=True))) == (
      1 + 2 + 1)


def test_trainer_runs_on_the_card_unless_asked(tmp_path, monkeypatch):
  """Without a device the trainer wants the card, and raises where there
  is none; no fallback to the CPU."""
  monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
  with pytest.raises(RuntimeError, match='CUDA'):
    trainer_t.Trainer(str(tmp_path))
  assert trainer_t.Trainer(str(tmp_path), device='cpu').device.type == 'cpu'
