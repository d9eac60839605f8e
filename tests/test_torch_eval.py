"""Port parity: the FID-eval slice (rollout, augment, InceptionV3, FID).

The same numpy inputs (made from seeds) go through the JAX functions and
their counterparts in the port, both on the CPU (the port's exact splat
runs its plain version there). Tolerances are stated per test.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from se3ds_torch import tracing
from se3ds_torch.eval import fid as fid_t
from se3ds_torch.eval import inception as inception_t
from se3ds_torch.eval import metrics as metrics_t
from se3ds_torch.models import folding as folding_t
from se3ds_torch.models import generator as generator_t
from se3ds_torch.ops import geometry as geometry_t
from se3ds_tpu.eval import fid as fid_j
from se3ds_tpu.eval import inception as inception_j
from se3ds_tpu.eval import metrics as metrics_j
from se3ds_tpu.models import generator as generator_j
from se3ds_tpu.models import model_config as config_j
from se3ds_tpu.ops import geometry as geometry_j
from test_torch_serving import random_flax_variables
from test_torch_serving import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures('one_torch_thread')

DEPTH_SCALE = 10.0


def _compiled(fn, *args):
  """`fn` jitted for `args` at XLA's lowest backend optimisation level:
  the compile is most of these one-shot comparisons' time on one core,
  and the tolerances cover the order of float operations."""
  return jax.jit(fn).lower(*args).compile(
      compiler_options={'xla_backend_optimization_level': 0})


# -- pole crop and augmentation ---------------------------------------------


def test_crop_pano_matches_jax():
  """4-D and 3-D panos; tolerance: none for the crop. Resized back to the
  original size (antialiased bilinear): atol 1e-6 on values in [0, 1],
  the two libraries sum the filter taps in different orders."""
  rs = np.random.RandomState(0)
  for shape in ((2, 20, 40, 3), (20, 40, 1)):
    pano = rs.rand(*shape).astype(np.float32)
    got = geometry_t.crop_pano(torch.from_numpy(pano)).numpy()
    want = np.asarray(geometry_j.crop_pano(jnp.asarray(pano)))
    np.testing.assert_array_equal(got, want)
    got = geometry_t.crop_pano(torch.from_numpy(pano),
                               resize_to_original=True).numpy()
    want = np.asarray(geometry_j.crop_pano(jnp.asarray(pano),
                                           resize_to_original=True))
    assert got.shape == pano.shape and got.dtype == want.dtype
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_augment_crop_matches_jax_draws():
  """Roll and flips fed from JAX's own draws for a key whose flips are
  mixed; tolerance: none."""
  n, h, w = 8, 16, 32
  images = np.random.RandomState(1).rand(n, h, w, 3).astype(np.float32)
  for seed in range(20):
    key = jax.random.PRNGKey(seed)
    k1, k2 = jax.random.split(key)
    flips = np.asarray(jax.random.bernoulli(k2, shape=(n,)))
    if 0 < flips.sum() < n:
      break
  roll = int(jax.random.randint(k1, (), -w // 2, w // 2))
  want = metrics_j._augment_crop_for_inception(jnp.asarray(images), key)
  got = metrics_t.augment_crop(torch.from_numpy(images), roll,
                               torch.from_numpy(flips.copy()))
  np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_augment_draws_come_from_the_generator():
  images = torch.rand((6, 16, 32, 3),
                      generator=torch.Generator().manual_seed(0))
  out = [metrics_t._augment_crop_for_inception(
      images, torch.Generator().manual_seed(5)) for _ in range(2)]
  assert torch.equal(out[0], out[1]) and out[0].shape == (6, 12, 32, 3)
  rng = torch.Generator().manual_seed(5)
  roll, flips = metrics_t.draw_augment(6, 32, rng)
  assert -16 <= roll < 16 and flips.shape == (6,)
  assert torch.equal(out[0], metrics_t.augment_crop(images, roll, flips))


# -- InceptionV3 --------------------------------------------------------------


@pytest.mark.parametrize('shape', [(2, 40, 80, 3), (1, 384, 1024, 3)],
                         ids=['upsample', 'downsample 1024x384'])
def test_resize_matches_jax_linear(shape):
  """`jax.image.resize(..., 'linear')` antialiases when it downsamples.

  Tolerance: atol 1e-5 on values in [0, 1]; the two libraries sum the
  filter taps in different orders (measured <= 4.6e-6).
  """
  images = np.random.RandomState(2).rand(*shape).astype(np.float32)
  want = jax.image.resize(jnp.asarray(images), (shape[0], 299, 299, 3),
                          'linear')
  got = inception_t.resize_for_inception(torch.from_numpy(images))
  np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                             atol=1e-5)


def _flax_inception_variables(seed):
  """Random Flax InceptionV3 variables from `jax.eval_shape` (an eager or
  jitted Flax init would take tens of seconds on one core)."""
  shapes = jax.eval_shape(inception_j.InceptionV3().init,
                          jax.random.PRNGKey(0), jnp.zeros((1, 75, 75, 3)))
  rs = np.random.RandomState(seed)

  def fill(path, leaf):
    name, shape = path[-1].key, leaf.shape
    if name == 'kernel':
      fan = np.prod(shape[:-2]) * (shape[-2] + shape[-1])
      value = rs.uniform(-1, 1, shape) * np.sqrt(6.0 / fan)
    elif name == 'var':
      value = rs.uniform(0.5, 1.5, shape)
    else:  # bias, mean
      value = rs.normal(0.0, 0.1, shape)
    return value.astype(np.float32)

  return jax.tree_util.tree_map_with_path(fill, shapes)


def test_inception_matches_jax():
  """75x75, batch 2, float32: the 'SAME' pads of the 1x7/7x1/1x3/3x1
  kernels, the count-excluding average pool and the branch order.

  Tolerance: atol 1e-4 on the pool and the softmax (measured 2.2e-7 and
  3.5e-10), and rtol 1e-3 on the softmax, whose values are ~1e-3.
  """
  variables = _flax_inception_variables(0)
  x = np.random.RandomState(3).uniform(-1, 1, (2, 75, 75, 3)).astype(
      np.float32)
  x_j = jnp.asarray(x)
  want_pool, want_pred = _compiled(inception_j.InceptionV3().apply,
                                   variables, x_j)(variables, x_j)
  model = inception_t.InceptionV3()
  state = inception_t.torch_state_dict_from_flax_inception(variables)
  assert set(state) == set(model.state_dict())
  model.load_state_dict(state)
  with torch.no_grad():
    pool, pred = model.eval()(torch.from_numpy(x))
  assert pool.shape == (2, 2048) and pred.shape == (2, 1000)
  np.testing.assert_allclose(pool.numpy(), np.asarray(want_pool), rtol=0,
                             atol=1e-4)
  np.testing.assert_allclose(pred.numpy(), np.asarray(want_pred), rtol=1e-3,
                             atol=1e-4)


def test_init_inception_and_get_inception():
  """Seeded random weights; get_inception resizes to 299, renormalises
  [0, 1] to [-1, 1] and runs the model."""
  a = inception_t.init_inception(torch.Generator().manual_seed(4))
  b = inception_t.init_inception(torch.Generator().manual_seed(4))
  for (ka, va), (kb, vb) in zip(a.state_dict().items(),
                                b.state_dict().items()):
    assert ka == kb and torch.equal(va, vb)
  images = torch.rand((1, 32, 64, 3),
                      generator=torch.Generator().manual_seed(6))
  pool, pred = inception_t.get_inception(images, a)
  assert torch.isfinite(pool).all() and pool.shape == (1, 2048)
  np.testing.assert_allclose(pred.sum(-1).numpy(), 1.0, atol=1e-5)
  seen = inception_t.get_inception(images, lambda x: (x, None))[0]
  assert torch.equal(seen, torch.clamp(
      inception_t.resize_for_inception(images) * 2 - 1, -1, 1))


# -- FID and IS ---------------------------------------------------------------


def test_fid_and_inception_score_equal_jax():
  """The same numpy/scipy code: equal, also on the rank-deficient eps
  path (fewer samples than dimensions); tolerance: none."""
  rs = np.random.RandomState(4)
  for n, dim in ((40, 16), (5, 64)):
    a, b = rs.rand(n, dim), rs.rand(n, dim) + 0.1
    assert fid_t.calculate_fid(a, b) == fid_j.calculate_fid(a, b)
  preds = rs.dirichlet(np.ones(10), size=24)
  assert (fid_t.calculate_inception_score(preds, 4)
          == fid_j.calculate_inception_score(preds, 4))


# -- the rollout --------------------------------------------------------------


def _video(n, t, h, seed):
  """A video batch: random RGB, smooth depth in (0.05, 0.9), a short
  pose walk."""
  rs = np.random.RandomState(seed)
  w = 2 * h
  yy, xx = np.meshgrid(np.linspace(0, np.pi, h),
                       np.linspace(0, 2 * np.pi, w), indexing='ij')
  base = np.clip((2.0 + 0.6 * np.sin(3 * xx) + 0.4 * np.cos(2 * yy))
                 / DEPTH_SCALE, 0.05, 0.9).astype(np.float32)
  position = np.zeros((n, t, 4), np.float32)
  position[..., :3] = np.cumsum(rs.uniform(-0.05, 0.05, (n, t, 3)), axis=1)
  image = rs.rand(n, t, h, w, 3).astype(np.float32)
  return base, {
      'image': image,
      'original_image': image,
      'depth': np.broadcast_to(base[None, None, ..., None],
                               (n, t, h, w, 1)).copy(),
      'position': position,
  }


def _stub_generators(base):
  """The stub of tests/test_eval_metrics.py: RGB from the guidance and a
  predicted depth 0.08 m inside frame 0's surface, so every re-observed
  pixel's window holds points of two frames. One for each package."""
  def jax_stub(variables, inputs):
    del variables
    generated = jnp.clip(
        inputs['prev_image'] * 0.7 + inputs['proj_image'] * 0.29 + 0.007,
        0.0, 1.0)
    depth_out = jnp.clip(inputs['proj_depth'] * 0.0
                         + jnp.asarray(base)[None, ..., None]
                         + 0.08 / DEPTH_SCALE, 0.0, 1.0)
    return [None, None, None, depth_out, None, None, generated]

  base_t = torch.from_numpy(base)

  def port_stub(inputs):
    generated = torch.clamp(
        inputs['prev_image'] * 0.7 + inputs['proj_image'] * 0.29 + 0.007,
        0.0, 1.0)
    depth_out = torch.clamp(inputs['proj_depth'] * 0.0
                            + base_t[None, ..., None] + 0.08 / DEPTH_SCALE,
                            0.0, 1.0)
    return [None, None, None, depth_out, None, None, generated]

  return jax_stub, port_stub


def _run_both(jax_apply, variables, port_generator, batch, t):
  """JAX `rollout_generated` ('scatter', op by op) and the port's (its
  default mode, 'sorted', which is exact) on the same batch."""
  gen_j, rmse_j, aux_j = metrics_j.rollout_generated(
      jax_apply, variables, {k: jnp.asarray(v) for k, v in batch.items()},
      eval_seq_len=t, depth_scale=DEPTH_SCALE, splat_mode='scatter')
  gen_t, rmse_t, aux_t = metrics_t.rollout_generated(
      port_generator, batch, t, DEPTH_SCALE, device='cpu')
  as_np = lambda d: [np.asarray(d[i]) for i in range(t)]
  return ((as_np(gen_j), as_np(rmse_j), {k: as_np(v) for k, v in
                                          aux_j.items()}),
          (as_np(gen_t), as_np(rmse_t), {k: as_np(v) for k, v in
                                          aux_t.items()}))


def test_rollout_with_the_stub_generator_matches_jax():
  """Guidance, masks, generated frames and fed-back depth equal; RMSE
  within rtol 1e-5 (a float32 sum over the image, which the two
  libraries take in different orders; measured 3.0e-6). The exact window
  decides the guidance here: both frames' points collide at every
  re-observed pixel.
  """
  n, t, h = 2, 3, 32
  base, batch = _video(n, t, h, seed=5)
  jax_stub, port_stub = _stub_generators(base)
  (gen_j, rmse_j, aux_j), (gen_t, rmse_t, aux_t) = _run_both(
      jax_stub, None, port_stub, batch, t)
  assert 0 < aux_j['proj_mask'][1].mean() < 1
  for key in ('projected', 'proj_mask', 'pred_depth', 'blurred_mask'):
    for i in range(t):
      np.testing.assert_array_equal(aux_t[key][i], aux_j[key][i])
  for i in range(t):
    np.testing.assert_array_equal(gen_t[i], gen_j[i])
    np.testing.assert_allclose(rmse_t[i], rmse_j[i], rtol=1e-5, atol=0)
  assert tracing.count('splat.exact_launches') == 0


# Guidance pixels allowed to differ per frame with the tiny generator: its
# float32 outputs differ by ~1e-7 between XLA's and PyTorch's CPU convs,
# which can move a fed-back point across a pixel edge or a truncation to
# the next RGB byte. Measured at this size: 0 pixels moved, generated
# frames within 1.2e-7, fed-back depth within 1.4e-7.
MOVED_GUIDANCE = 0.005


def test_rollout_with_the_tiny_generator_matches_jax():
  """The test config's generator (random Flax variables carried over by
  `folding.torch_state_dict_from_flax`) rolled out T=3 frames.

  Budget: at most MOVED_GUIDANCE of the guidance pixels differ per
  frame; generated frames and fed-back depth within atol 1e-4 elsewhere.
  """
  cfg = config_j.get_test_config()
  n, t, h = 2, 3, cfg.image_height
  _, batch = _video(n, t, h, seed=6)
  variables = random_flax_variables(cfg, seed=7)
  flax_model = generator_j.ResNetGenerator(
      image_size=h, resnet_version=cfg.resnet_version, gen_dims=cfg.gen_dims,
      use_blurred_mask=cfg.use_blurred_mask, spectral_fold=True)
  cond = {k: jnp.zeros((n, h, 2 * h, c)) for k, c in (
      ('prev_image', 3), ('proj_image', 3), ('proj_mask', 1),
      ('proj_depth', 1), ('blurred_mask', 1))}
  jax_apply = _compiled(lambda v, c: flax_model.apply(v, c, train=False),
                        variables, cond)
  model = generator_t.ResNetGenerator(
      gen_dims=cfg.gen_dims, resnet_version=cfg.resnet_version,
      use_blurred_mask=cfg.use_blurred_mask)
  model.load_state_dict(folding_t.torch_state_dict_from_flax(variables,
                                                             model))
  (gen_j, rmse_j, aux_j), (gen_t, rmse_t, aux_t) = _run_both(
      jax_apply, variables, model.eval(), batch, t)
  for i in range(t):
    moved = ((aux_t['projected'][i] != aux_j['projected'][i]).any(-1)
             | (aux_t['proj_mask'][i] != aux_j['proj_mask'][i])[..., 0])
    assert moved.mean() <= MOVED_GUIDANCE, (i, moved.mean())
    same = ~moved[..., None]
    np.testing.assert_allclose(np.where(same, gen_t[i], 0),
                               np.where(same, gen_j[i], 0), atol=1e-4)
    np.testing.assert_allclose(rmse_t[i], rmse_j[i], rtol=1e-4, atol=1e-6)
  assert 0 < aux_j['proj_mask'][2].mean() < 1


def test_rollout_default_is_exact_and_needs_a_device(monkeypatch):
  import inspect
  assert inspect.signature(metrics_t.rollout_generated).parameters[
      'splat_mode'].default == 'sorted'
  assert inspect.signature(metrics_t.EvalMetric).parameters[
      'splat_mode'].default == 'sorted'
  monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
  base, batch = _video(1, 2, 16, seed=8)
  _, port_stub = _stub_generators(base)
  with pytest.raises(RuntimeError, match="device='cpu'"):
    metrics_t.rollout_generated(port_stub, batch, 2, DEPTH_SCALE)
  with pytest.raises(RuntimeError, match="device='cpu'"):
    metrics_t.EvalMetric(lambda: iter([batch]), eval_num=1, batch_size=1)


class _TinyInception(torch.nn.Module):
  """Stands in for InceptionV3: a 16-d pool and a softmax over 4."""

  def forward(self, images):
    pool = images.mean(dim=(1, 2)).repeat(1, 6)[:, :16]
    pool = pool + torch.arange(16) * images.std(dim=(1, 2, 3))[:, None]
    return pool, torch.softmax(pool[:, :4], dim=-1)


def test_eval_metric_counts_and_trims():
  """eval_num // batch_size + 1 batches, the data restarted when it runs
  out, pools trimmed to eval_num; finite FID, RMSE and IS per frame."""
  base, batch = _video(2, 3, 16, seed=9)
  _, port_stub = _stub_generators(base)
  calls = []

  def ds_factory():
    calls.append(1)
    return iter([batch])

  metric = metrics_t.EvalMetric(
      ds_factory, eval_num=3, batch_size=2, avg_num=2, eval_seq_len=3,
      depth_scale=DEPTH_SCALE, inception_model=_TinyInception(),
      rng=torch.Generator().manual_seed(0), device='cpu')
  assert len(calls) == 2  # two batches from a one-batch dataset
  assert {k: v.shape for k, v in metric._pool.items()} == {
      1: (3, 16), 2: (3, 16)}
  fid, fid_std, rmse, inception_score = metric.calculate_fid_score(
      port_stub)
  for d in (fid, fid_std, rmse, inception_score):
    assert set(d) == {1, 2} and all(np.isfinite(v) for v in d.values())
  assert rmse[1] > 0 and all(v >= 1.0 for v in inception_score.values())
