"""`EvalMetric.calculate_fid_score` of the port against the JAX package's,
one call each, with the JAX package's augmentation draws fed to the port.

The two packages draw the Inception crops' roll and flips from different
generators (threefry keys against a `torch.Generator`); here the JAX
draws are replayed in JAX's order (`_next_rng`, then one key per frame,
split into roll and flips) through the port's `metrics.draw_augment`,
so both packages pool the same augmented frames. The generator is the
stub of test_torch_eval.py (its rollouts are equal in both packages),
and Inception is replaced in both by one small shared feature map: the
per-column mean luminance (which a roll or a flip permutes), centred,
through a
fixed random projection to 4 features and a softmax over 5 classes.
InceptionV3 itself is held to JAX in test_torch_eval.py. With 8 samples
of 4 features the covariances are full rank, so the FID is well posed.

Tolerances: FID rtol 1e-4, Inception score and RMSE rtol 1e-5 (float32
features and depth errors summed in different orders, then the same
float64 host math; measured relative differences: FID 8e-7, RMSE 3e-6,
Inception score 1e-7).
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from se3ds_torch.eval import metrics as metrics_t
from se3ds_tpu.eval import metrics as metrics_j
from test_torch_eval import DEPTH_SCALE
from test_torch_eval import _stub_generators
from test_torch_eval import _video
from test_torch_serving import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures('one_torch_thread')

EVAL_NUM, BATCH, FRAMES, HEIGHT = 8, 4, 3, 32
_rs = np.random.RandomState(3)
PROJECT = _rs.normal(0, 3, (2 * HEIGHT, 4)).astype(np.float32)
CLASSES = _rs.normal(0, 1, (4, 5)).astype(np.float32)


def _jax_features(images, variables):
  del variables
  columns = images.mean(-1).mean(1) - 0.5
  pool = jnp.tanh(columns @ PROJECT)
  return pool, jax.nn.softmax(pool @ CLASSES, axis=-1)


def _port_features(images, model):
  del model
  columns = images.mean(-1).mean(1) - 0.5
  pool = torch.tanh(columns @ torch.from_numpy(PROJECT))
  return pool, torch.softmax(pool @ torch.from_numpy(CLASSES), dim=-1)


def _jax_draws(calls, batch_size, width):
  """JAX EvalMetric's (roll, flips) per pooled frame, in its order."""
  rng, draws = jax.random.PRNGKey(0), []
  for _ in range(calls):
    rng, key = jax.random.split(rng)
    keys = jax.random.split(key, FRAMES)
    for i in range(1, FRAMES):
      k1, k2 = jax.random.split(keys[i])
      roll = jax.random.randint(k1, (), -width // 2, width // 2)
      flips = jax.random.bernoulli(k2, shape=(batch_size,))
      draws.append((int(roll), torch.from_numpy(np.array(flips))))
  return draws


def test_fid_and_inception_score_equal_jax_on_jax_draws(monkeypatch):
  base, first = _video(BATCH, FRAMES, HEIGHT, seed=11)
  _, second = _video(BATCH, FRAMES, HEIGHT, seed=12)
  for batch in (first, second):  # one surface for the stub's depth
    batch['depth'] = first['depth']
  batches = [first, second]
  jax_stub, port_stub = _stub_generators(base)

  monkeypatch.setattr(metrics_j, 'inception_lib', types.SimpleNamespace(
      get_inception=_jax_features, init_variables=lambda: None))
  metric_j = metrics_j.EvalMetric(
      lambda: iter(batches), eval_num=EVAL_NUM, batch_size=BATCH, avg_num=1,
      eval_seq_len=FRAMES, depth_scale=DEPTH_SCALE, splat_mode='scatter')
  want = metric_j.calculate_fid_score(jax_stub, None)

  batches_per_pool = EVAL_NUM // BATCH + 1
  draws = _jax_draws(2 * batches_per_pool, BATCH, 2 * HEIGHT)

  def replay(batch_size, width, rng):
    del rng
    assert (batch_size, width) == (BATCH, 2 * HEIGHT)
    return draws.pop(0)

  monkeypatch.setattr(metrics_t, 'draw_augment', replay)
  monkeypatch.setattr(metrics_t, 'inception_lib', types.SimpleNamespace(
      get_inception=_port_features))
  metric_t = metrics_t.EvalMetric(
      lambda: iter(batches), eval_num=EVAL_NUM, batch_size=BATCH, avg_num=1,
      eval_seq_len=FRAMES, depth_scale=DEPTH_SCALE, inception_model=object(),
      device='cpu')
  got = metric_t.calculate_fid_score(port_stub)
  assert not draws

  fid, fid_std, rmse, inception_score = got
  for i in range(1, FRAMES):
    assert fid[i] > 0 and inception_score[i] > 1.0
    np.testing.assert_allclose(fid[i], want[0][i], rtol=1e-4)
    np.testing.assert_allclose(rmse[i], want[2][i], rtol=1e-5)
    np.testing.assert_allclose(inception_score[i], want[3][i], rtol=1e-5)
    assert fid_std[i] == want[1][i] == 0.0
