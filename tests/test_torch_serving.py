"""Port parity for the serving slice as a whole, and the port's API.

The JAX `SE3DSModel(get_test_config(), variables=v)` and the port's
`SE3DSModel(..., variables=v, device='cpu')` get the same random Flax
variables and the same RGB-D pano (numpy, from seeds), then run
`add_to_memory` and two `add_preds_to_memory=True` steps. The variables
are in folded form (no 'spectral' collection), so neither package spends
test time folding; test_torch_generator.py covers the fold. One JAX
model per file; test_torch_serving_compact.py runs the pole-compacted
layout.

Tolerances, with their reasons:
* Guidance (proj_rgb, proj_semantic, proj_mask) is equal except at a few
  pixels: the point coordinates differ by float ULPs (XLA's trig and FMA
  contraction vs PyTorch's), which can move a point across a pixel edge
  or a depth bucket. At most GUIDANCE_PIXELS (0.5%) pixels may differ.
* proj_depth: the same pixels, and elsewhere within 1e-6 (XLA divides
  the depth by depth_scale as a multiply by the reciprocal).
* pred_rgb: at most 1 level of 255 off, at most PRED_PIXELS (2%) of the
  values. Generator floats differ by ~1e-6, which moves the truncation to
  uint8 near level edges; the second step also splats the first step's
  (slightly different) prediction.
Measured at this size (both layouts): 0 pixels moved, pred_rgb equal,
proj_depth within 5.3e-7, pred_depth within 6.9e-7.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from se3ds_torch import tracing
from se3ds_torch.models import inference as inference_t
from se3ds_torch.models import model_config as config_t
from se3ds_tpu.models import generator as generator_j
from se3ds_tpu.models import inference as inference_j
from se3ds_tpu.models import model_config as config_j

GUIDANCE_PIXELS = 0.005
PRED_PIXELS = 0.02
POSITIONS = ([[0.4, 0.1, 0.0]], [[0.8, -0.2, 0.05]])


@pytest.fixture(scope='module')
def one_torch_thread():
  """One PyTorch thread for a module's tests: at the test size each op is
  tiny, and with the suite's parallel workers a thread pool per worker
  oversubscribes the cores, which slows such ops by an order of magnitude
  (an OpenMP barrier waits for descheduled threads)."""
  threads = torch.get_num_threads()
  torch.set_num_threads(1)
  yield
  torch.set_num_threads(threads)


pytestmark = pytest.mark.usefixtures('one_torch_thread')


def random_flax_variables(config, seed):
  """Random folded generator variables ({'params', 'batch_stats'}) for
  `config`, made from the Flax shapes without compiling anything."""
  h = config.image_height
  cond = {k: np.zeros((1, h, 2 * h, c), np.float32)
          for k, c in (('proj_image', 3), ('proj_depth', 1),
                       ('proj_mask', 1), ('blurred_mask', 1))}
  model = generator_j.ResNetGenerator(
      image_size=h, resnet_version=config.resnet_version,
      gen_dims=config.gen_dims, use_blurred_mask=config.use_blurred_mask)
  shapes = jax.eval_shape(
      lambda: model.init(jax.random.PRNGKey(0), cond, train=False))
  rs = np.random.RandomState(seed)

  def fill(path, leaf):
    name, shape = path[-1].key, leaf.shape
    if name == 'kernel':
      fan = np.prod(shape[:-2]) * (shape[-2] + shape[-1])
      value = rs.uniform(-1, 1, shape) * np.sqrt(6.0 / fan)
    elif name in ('scale', 'var'):
      value = rs.uniform(0.5, 1.5, shape)
    else:  # bias, mean
      value = rs.normal(0.0, 0.1, shape)
    return value.astype(np.float32)

  return jax.tree_util.tree_map_with_path(
      fill, {k: v for k, v in shapes.items() if k != 'spectral'})


def random_pano(height, seed):
  """An RGB-D pano with invalid depths (0 and >= 1) sprinkled in."""
  rs = np.random.RandomState(seed)
  w = 2 * height
  rgb = rs.randint(0, 256, (1, height, w, 3)).astype(np.int32)
  sem = rs.randint(0, 42, (1, height, w, 1)).astype(np.int32)
  depth = rs.uniform(0.05, 0.6, (1, height, w)).astype(np.float32)
  depth[rs.rand(1, height, w) < 0.05] = 0.0
  depth[rs.rand(1, height, w) < 0.02] = 1.0
  return rgb, sem, depth


def serve_both(overrides, mask_blurred, seed=0):
  """Runs both packages; returns ([jax steps], [port steps]) of numpy
  OutputData dicts."""
  cfg_j = dataclasses.replace(config_j.get_test_config(), **overrides)
  cfg_t = dataclasses.replace(config_t.get_test_config(), **overrides)
  variables = random_flax_variables(cfg_j, seed)
  rgb, sem, depth = random_pano(cfg_j.image_height, seed + 1)
  origin = np.zeros((1, 3), np.float32)
  runs = []
  for model in (inference_j.SE3DSModel(cfg_j, variables=variables),
                inference_t.SE3DSModel(cfg_t, variables=variables,
                                       device='cpu')):
    model.add_to_memory(rgb, sem, depth, origin, mask_blurred=mask_blurred)
    steps = []
    for pos in POSITIONS:
      out = model(np.asarray(pos, np.float32), add_preds_to_memory=True)
      steps.append({k: np.asarray(v) for k, v in out._asdict().items()
                    if v is not None})
    runs.append(steps)
  return runs


def assert_serving_close(runs):
  for ref, got in zip(*runs):
    assert ref.keys() == got.keys()
    for k in ref:
      assert got[k].shape == ref[k].shape, k
      assert got[k].dtype == ref[k].dtype, k
    h, w = ref['proj_depth'].shape[1:]
    moved = ((got['proj_rgb'] != ref['proj_rgb']).any(-1)
             | (got['proj_semantic'] != ref['proj_semantic'])
             | (got['proj_mask'][..., 0] != ref['proj_mask'][..., 0]))
    depth_err = np.abs(got['proj_depth'] - ref['proj_depth'])
    moved |= depth_err > 1e-6
    assert moved.sum() <= GUIDANCE_PIXELS * h * w, moved.sum()
    assert 0 < ref['proj_mask'].mean() < 1
    rgb_err = np.abs(got['pred_rgb'].astype(int) - ref['pred_rgb'])
    assert rgb_err.max() <= 1
    assert (rgb_err > 0).mean() <= PRED_PIXELS, (rgb_err > 0).mean()
    np.testing.assert_allclose(got['pred_depth'], ref['pred_depth'],
                               rtol=0, atol=1e-5)
    np.testing.assert_array_equal(got['pred_semantic'], ref['pred_semantic'])
    np.testing.assert_array_equal(got['mu'], ref['mu'])


@pytest.fixture(scope='module')
def uncompacted_runs():
  return serve_both(dict(pole_compact=False), mask_blurred=False)


def test_serving_slice_matches_jax(uncompacted_runs):
  assert_serving_close(uncompacted_runs)


# -- the port's own API (no JAX model) --------------------------------------


def _port_model(**overrides):
  cfg = dataclasses.replace(config_t.get_test_config(), **overrides)
  return inference_t.SE3DSModel(cfg, device='cpu',
                                generator=torch.Generator().manual_seed(0))


def _outputs_equal(a, b):
  for x, y in zip(a, b):
    if x is not None:
      assert torch.equal(x, y)


def test_predict_trajectory_equals_single_steps():
  """T fused frames == T add_preds_to_memory calls, bit for bit."""
  rgb, sem, depth = random_pano(32, 3)
  positions = np.array([[0.3, 0, 0], [0.6, 0.1, 0]], np.float32)
  loop, traj = _port_model(), _port_model()
  for m in (loop, traj):
    m.add_to_memory(rgb, sem, depth, np.zeros((1, 3), np.float32))
  steps = [loop(p[None], add_preds_to_memory=True) for p in positions]
  fused = traj.predict_trajectory(positions)
  for t, step in enumerate(steps):
    _outputs_equal([f[t] for f in fused if f is not None],
                   [s for s in step if s is not None])
  a, b = loop.get_memory_state(), traj.get_memory_state()
  assert a.cursor == b.cursor == 3 * 32 * 64
  for x, y in zip(a[:4], b[:4]):
    assert torch.equal(x, y)


def test_memory_state_roundtrip_and_capacity():
  rgb, sem, depth = random_pano(32, 4)
  m = _port_model()
  m.add_to_memory(rgb, sem, depth, np.zeros((1, 3), np.float32))
  saved = m.get_memory_state()
  first = m(np.array([[0.2, 0, 0]], np.float32))
  m(np.array([[0.5, 0, 0]], np.float32), add_preds_to_memory=True)
  m.set_memory_state(saved)
  _outputs_equal(m(np.array([[0.2, 0, 0]], np.float32)), first)
  m.predict_trajectory(np.zeros((2, 3), np.float32))
  with pytest.raises(ValueError):
    m(np.zeros((1, 3), np.float32), add_preds_to_memory=True)
  with pytest.raises(ValueError):
    m.add_to_memory(rgb, sem, depth, np.zeros((1, 3), np.float32))


def test_pole_compact_rejects_unmasked_writes():
  rgb, sem, depth = random_pano(32, 5)
  m = _port_model(pole_compact=True)
  with pytest.raises(ValueError):
    m.add_to_memory(rgb, sem, depth, np.zeros((1, 3), np.float32),
                    mask_blurred=False)


def test_no_card_needs_an_explicit_cpu_device(monkeypatch):
  monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
  cfg = config_t.get_test_config()
  with pytest.raises(RuntimeError, match="device='cpu'"):
    inference_t.SE3DSModel(cfg)
  with pytest.raises(RuntimeError):
    inference_t.SE3DSModel(cfg, device='cuda')


def test_unported_options_raise(tmp_path):
  """A splat mode the JAX package does not have, and an Orbax checkpoint
  of the JAX package (the port reads only its own checkpoints; never
  random weights instead). Every JAX splat mode is served
  (tests/test_torch_splat_modes.py)."""
  base = config_t.get_test_config()
  with pytest.raises(ValueError, match='splat_mode'):
    inference_t.SE3DSModel(
        dataclasses.replace(base, splat_mode='sorted_fast'), device='cpu')
  (tmp_path / '_CHECKPOINT_METADATA').write_text('{}')
  with pytest.raises(ValueError, match='Orbax'):
    inference_t.SE3DSModel(
        dataclasses.replace(base, ckpt_path=str(tmp_path)), device='cpu')


def test_cpu_serving_never_launches_the_kernel():
  rgb, sem, depth = random_pano(32, 6)
  m = _port_model()
  m.add_to_memory(rgb, sem, depth, np.zeros((1, 3), np.float32))
  m(np.zeros((1, 3), np.float32), add_preds_to_memory=True)
  assert tracing.count('splat.fast_launches') == 0
