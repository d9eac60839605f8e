"""Port parity for the rest of the serving API: ring memory,
`predict_poses`, serving a checkpoint the port wrote, and `.ply` export.

The JAX `SE3DSModel` and the port's get the same random Flax variables
(test_torch_serving.py's helpers) and the same numpy panos. One module
fixture runs every JAX program once (its compiles take most of this
file's time): five ring writes (a wrap at memory_frames 3), a restored
wrapped state, `predict_poses` of K = 3, `sample_perturbed_views` (three
views, the same compiled batch), a fused trajectory across the wrap, and
a pole-compacted memory for the `.ply`. At 'pallas_exact' the splat is
the only difference from 'fast', so the port's guidance there is held to
JAX's eager `memory_project` with the exact splat.

Tolerances, with their reasons:
* Memory features (semantic and RGB), the cursor and the frame counters
  are equal. Memory coordinates come from the unprojection's trig, which
  XLA and PyTorch round differently: they are within COORD_ATOL (8
  float32 ULP of the 20 m depth scale; measured 5.5e-6) of JAX's, and
  equal, bit for bit, to the port's own strict-mode writes of the same
  frames in the slots JAX's ring put them in. Slots that both packages
  copied from one restored state are equal.
* Served outputs: `assert_serving_close` (test_torch_serving.py: at most
  0.5% of guidance pixels moved, pred_rgb within 1 level on at most 2%
  of values, pred_depth within 1e-5).
* `predict_poses` against K single calls of the port: the guidance is
  equal; the generator runs at batch K against batch 1, whose float sums
  differ by ~1e-6, so its outputs are held to `assert_serving_close`.
* `.ply`: byte-equal, both packages writing one memory state.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from se3ds_torch.inference import perturbation as perturbation_t
from se3ds_torch.models import folding
from se3ds_torch.models import generator as generator_t
from se3ds_torch.models import inference as inference_t
from se3ds_torch.models import model_config as config_t
from se3ds_torch.models import discriminator as discriminator_t
from se3ds_torch.ops import geometry as geometry_t
from se3ds_torch.train import checkpoints as checkpoints_t
from se3ds_torch.train import state as state_t
from se3ds_tpu.inference import perturbation as perturbation_j
from se3ds_tpu.models import inference as inference_j
from se3ds_tpu.models import model_config as config_j
from test_torch_serving import GUIDANCE_PIXELS
from test_torch_serving import assert_serving_close
from test_torch_serving import random_flax_variables
from test_torch_serving import random_pano
from test_torch_serving import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures('one_torch_thread')

COORD_ATOL = 8 * np.finfo(np.float32).eps * 20.0
POSES = np.array([[0.3, 0.1, 0.0], [-0.2, 0.25, 0.05], [0.1, -0.3, -0.02]],
                 np.float32)
TRAJECTORY = np.array([[0.2, 0.0, 0.0], [0.35, 0.1, 0.02]], np.float32)
ORIGIN = np.zeros((1, 3), np.float32)
PERTURBED_VIEWS, PERTURB_SEED = 3, 5


def _position(i):
  return np.array([[0.3 * i, -0.1 * i, 0.02 * i]], np.float32)


def _panos(count):
  return [random_pano(32, 20 + i) for i in range(count)]


def _configs(**overrides):
  return (dataclasses.replace(config_j.get_test_config(), **overrides),
          dataclasses.replace(config_t.get_test_config(), **overrides))


def _numpy_state(state):
  return {k: np.asarray(v) for k, v in state._asdict().items()}


def _torch_state(state):
  return inference_t.MemoryState(**{
      k: (int(v) if k == 'cursor' else torch.from_numpy(np.array(v)))
      for k, v in state.items()})


def _jax_state(state):
  """A numpy state dict as the JAX MemoryState."""
  return inference_j.MemoryState(**state)


def _counters(model):
  return (model._frames_written, model._total_frames,
          model._next_write_slot())


def _steps(out, lead):
  """OutputData -> list of numpy dicts, one per index of a leading axis
  (`lead`=True) or one for the whole batch."""
  d = {k: np.asarray(v) for k, v in out._asdict().items() if v is not None}
  if not lead:
    return [d]
  return [{k: v[t] for k, v in d.items()} for t in range(len(d['pred_rgb']))]


def _read_ply(model, path):
  model.write_memory_as_pointcloud(str(path))
  with open(path, 'rb') as f:
    return f.read()


@pytest.fixture(scope='module')
def variables():
  return random_flax_variables(config_j.get_test_config(), 0)


@pytest.fixture(scope='module')
def jax_runs(variables, tmp_path_factory):
  """Every JAX program of this file, run once; numpy results."""
  runs = {}
  cfg_j, _ = _configs(memory_mode='ring')
  ring = inference_j.SE3DSModel(cfg_j, variables=variables)
  panos = _panos(6)
  for i in range(5):
    ring.add_to_memory(*panos[i], _position(i))
  runs['wrapped'] = _numpy_state(ring.get_memory_state())
  runs['wrapped_counters'] = _counters(ring)
  ring.set_memory_state(ring.get_memory_state())
  runs['restored_counters'] = _counters(ring)
  ring.add_to_memory(*panos[5], _position(5))
  runs['restored_add'] = _numpy_state(ring.get_memory_state())
  runs['restored_add_counters'] = _counters(ring)

  ring.set_memory_state(_jax_state(runs['wrapped']))
  runs['ply_ring'] = _read_ply(ring, tmp_path_factory.mktemp('ply') / 'j')
  runs['poses'] = _steps(ring.predict_poses(POSES), lead=False)
  views = perturbation_j.sample_perturbed_views(
      ring, ORIGIN, panos[0][2][0], PERTURBED_VIEWS,
      np.random.RandomState(PERTURB_SEED))
  runs['perturbed'] = [(p, _steps(o, lead=False)[0]) for p, o in views]
  live = ring._live_memory(ring.get_memory_state(), 3, 3)
  live = live._replace(**{k: np.broadcast_to(v, (len(POSES),) + v.shape[1:])
                          for k, v in live._asdict().items() if k != 'cursor'})
  runs['exact_guidance'] = [np.asarray(x) for x in inference_j.memory_project(
      live, POSES, 32, 64, cfg_j.depth_scale, splat_mode='scatter')]

  ring.reset_memory()
  for i in range(2):
    ring.add_to_memory(*panos[i], _position(i))
  runs['trajectory'] = _steps(ring.predict_trajectory(TRAJECTORY), lead=True)
  runs['trajectory_counters'] = _counters(ring)

  cfg_j, _ = _configs(pole_compact=True)
  compact = inference_j.SE3DSModel(cfg_j, variables=variables)
  for i in range(2):
    compact.add_to_memory(*panos[i], _position(i), mask_blurred=True)
  runs['compact'] = _numpy_state(compact.get_memory_state())
  runs['ply_compact'] = _read_ply(compact,
                                  tmp_path_factory.mktemp('ply') / 'c')
  return runs


def _port(variables, **overrides):
  _, cfg = _configs(**overrides)
  return inference_t.SE3DSModel(cfg, variables=variables, device='cpu')


def _assert_memory(got, want):
  """Features and cursor equal, coordinates within COORD_ATOL."""
  got = {k: (v if k == 'cursor' else v.numpy())
         for k, v in got._asdict().items()}
  assert got['cursor'] == int(want['cursor'])
  for key in ('feats', 'rgb'):
    np.testing.assert_array_equal(got[key], want[key])
  for key in ('coords', 'rgb_coords'):
    np.testing.assert_allclose(got[key], want[key], rtol=0, atol=COORD_ATOL)


def _states_equal(a, b):
  assert a.cursor == b.cursor
  for x, y in zip(a[:4], b[:4]):
    assert torch.equal(x, y)


# -- ring memory ------------------------------------------------------------


def test_ring_below_capacity_equals_strict(variables):
  """Until the first wrap a ring model is a strict one, bit for bit."""
  rgb, sem, depth = random_pano(32, 3)
  outs, states = [], []
  for mode in ('strict', 'ring'):
    m = _port(variables, memory_mode=mode)
    m.add_to_memory(rgb, sem, depth, ORIGIN)
    step = m(TRAJECTORY[:1], add_preds_to_memory=True)
    traj = m.predict_trajectory(TRAJECTORY[1:2])
    outs.append([x for x in (*step, *traj) if x is not None])
    states.append(m.get_memory_state())
    assert _counters(m) == (3, 3, 0)
  for x, y in zip(*outs):
    assert torch.equal(x, y)
  _states_equal(*states)


def test_ring_wrap_and_restore_match_jax(variables, jax_runs):
  panos = _panos(6)
  ring = _port(variables, memory_mode='ring')
  for i in range(5):
    ring.add_to_memory(*panos[i], _position(i))
  assert _counters(ring) == jax_runs['wrapped_counters'] == (3, 5, 2)
  _assert_memory(ring.get_memory_state(), jax_runs['wrapped'])
  # The port's own strict writes of the frames JAX's ring holds in slots
  # 0, 1, 2 (frames 3, 4 and 2).
  strict = _port(variables)
  for i in (3, 4, 2):
    strict.add_to_memory(*panos[i], _position(i))
  _states_equal(ring.get_memory_state(), strict.get_memory_state())

  # A wrapped state restores as full; the next write lands in slot 0.
  ring.set_memory_state(_torch_state(jax_runs['wrapped']))
  assert _counters(ring) == jax_runs['restored_counters'] == (3, 3, 0)
  ring.add_to_memory(*panos[5], _position(5))
  assert _counters(ring) == jax_runs['restored_add_counters']
  got, want = ring.get_memory_state(), jax_runs['restored_add']
  _assert_memory(got, want)
  frame = 32 * 64
  for key in ('coords', 'rgb_coords'):
    np.testing.assert_array_equal(getattr(got, key).numpy()[..., frame:],
                                  want[key][..., frame:])
  # Strict mode still refuses a fourth frame.
  with pytest.raises(ValueError):
    strict.add_to_memory(*panos[5], _position(5))


def test_ring_trajectory_across_the_wrap(variables, jax_runs):
  """Two real frames, then a trajectory into slot 2 and over the first
  real frame in slot 0: equal to per-frame calls, and close to JAX's
  fused trajectory."""
  panos = _panos(2)
  fused, loop = (_port(variables, memory_mode='ring') for _ in range(2))
  for m in (fused, loop):
    for i in range(2):
      m.add_to_memory(*panos[i], _position(i))
  traj = fused.predict_trajectory(TRAJECTORY)
  steps = [loop(p[None], add_preds_to_memory=True) for p in TRAJECTORY]
  for t, step in enumerate(steps):
    for x, y in zip(traj, step):
      if x is not None:
        assert torch.equal(x[t], y)
  _states_equal(fused.get_memory_state(), loop.get_memory_state())
  assert (_counters(fused) == _counters(loop)
          == jax_runs['trajectory_counters'] == (3, 4, 1))
  # The real frame in slot 0 was overwritten by a predicted one.
  assert fused._sem_real == loop._sem_real == [False, True, False]
  assert_serving_close((jax_runs['trajectory'], _steps(traj, lead=True)))


# -- predict_poses ----------------------------------------------------------


@pytest.mark.parametrize('mode', ['fast', 'pallas_exact'])
def test_predict_poses_matches_jax_and_single_calls(variables, jax_runs,
                                                    mode, monkeypatch):
  model = _port(variables, splat_mode=mode)
  model.add_to_memory(*random_pano(32, 20), ORIGIN)
  model.set_memory_state(_torch_state(jax_runs['wrapped']))
  before = model.get_memory_state()

  strides = []
  project = geometry_t.project_memory_equirect

  def recording(feats, xyz1, *args, **kwargs):
    strides.append((feats.stride(0), xyz1.stride(0), xyz1.shape[0]))
    return project(feats, xyz1, *args, **kwargs)

  monkeypatch.setattr(geometry_t, 'project_memory_equirect', recording)
  out = model.predict_poses(POSES)
  monkeypatch.setattr(geometry_t, 'project_memory_equirect', project)
  assert strides == [(0, 0, 3), (0, 0, 3)]  # semantic and RGB splats
  _states_equal(model.get_memory_state(), before)
  assert out.pred_rgb.shape == (3, 32, 64, 3)
  if mode == 'fast':
    assert_serving_close((jax_runs['poses'], _steps(out, lead=False)))
  else:
    _assert_exact_guidance_close(out, jax_runs['exact_guidance'])

  singles = [model(p[None]) for p in POSES]
  for key in ('proj_rgb', 'proj_semantic', 'proj_depth', 'proj_mask'):
    assert torch.equal(getattr(out, key),
                       torch.cat([getattr(s, key) for s in singles]))
  single = {k: np.concatenate([np.asarray(getattr(s, k)) for s in singles])
            for k in _steps(out, lead=False)[0]}
  assert_serving_close(([single], _steps(out, lead=False)))


def _assert_exact_guidance_close(out, want):
  """The served guidance against JAX's exact `memory_project` outputs,
  with `assert_serving_close`'s guidance tolerances."""
  semantic, depth, rgb, mask = want
  rgb = (np.clip(rgb / 255.0, 0.0, 1.0) * 255).astype(np.uint8)
  moved = ((out.proj_rgb.numpy() != rgb).any(-1)
           | (out.proj_semantic.numpy() != semantic[..., 0].astype(np.uint8))
           | (out.proj_mask.numpy() != mask)[..., 0]
           | (np.abs(out.proj_depth.numpy() - depth) > 1e-6))
  assert moved.sum() <= GUIDANCE_PIXELS * 32 * 64, moved.sum()
  assert 0 < mask.mean() < 1


def test_sample_perturbed_views_matches_jax(variables, jax_runs):
  """The same candidates from the same RandomState, served in one
  `predict_poses` chunk."""
  model = _port(variables, memory_mode='ring')
  model.add_to_memory(*random_pano(32, 20), ORIGIN)
  model.set_memory_state(_torch_state(jax_runs['wrapped']))
  views = perturbation_t.sample_perturbed_views(
      model, ORIGIN, random_pano(32, 20)[2][0], PERTURBED_VIEWS,
      np.random.RandomState(PERTURB_SEED))
  assert len(views) == len(jax_runs['perturbed']) == PERTURBED_VIEWS
  for (position, out), (want_position, want) in zip(views,
                                                    jax_runs['perturbed']):
    np.testing.assert_array_equal(position, want_position)
    assert out.pred_rgb.shape == (1, 32, 64, 3)
    assert_serving_close(([want], _steps(out, lead=False)))


def test_predict_poses_needs_one_scene(variables):
  model = _port(variables, batch_size=2)
  model.add_to_memory(*[np.repeat(x, 2, 0) for x in random_pano(32, 1)],
                      np.zeros((2, 3), np.float32))
  with pytest.raises(ValueError, match='ONE scene'):
    model.predict_poses(POSES)
  with pytest.raises(ValueError, match=r'\(K, 3\)'):
    _port(variables).predict_poses(POSES[None])


# -- checkpoints ------------------------------------------------------------


def _trainable_generator(seed):
  cfg = config_t.get_test_config()
  gen = generator_t.ResNetGenerator(
      gen_dims=cfg.gen_dims, resnet_version=cfg.resnet_version,
      spectral_fold=False)
  folding.init_random_(gen, torch.Generator().manual_seed(seed))
  return gen


def _train_state(seed):
  """A TrainState at step 7 whose EMA generator differs from its
  generator."""
  disc = discriminator_t.SNMultiScaleDiscriminator(dis_dims=2, n_layers=3)
  folding.init_random_(disc, torch.Generator().manual_seed(seed + 2))
  state = state_t.create_train_state(_trainable_generator(seed), disc, 1e-3,
                                     1e-3, 0.9, 0.999)
  state.ema.load_state_dict(_trainable_generator(seed + 1).state_dict())
  state.step = 7
  return state


def test_ema_generator_checkpoints_round_trip_and_serve(tmp_path):
  state = _train_state(3)
  want = folding.serving_state_dict(state.ema)
  path = str(tmp_path / 'ema.pt')
  checkpoints_t.save_ema_generator(path, state.ema)
  model_dir = str(tmp_path / 'model')
  checkpoints_t.CheckpointManager(model_dir).save(state.step, state)
  target = generator_t.ResNetGenerator(gen_dims=4, resnet_version='tiny')
  for source in (path, model_dir, os.path.join(model_dir, '7')):
    got = checkpoints_t.restore_ema_generator(source, target=target)
    assert got.keys() == want.keys()
    for key in want:
      assert got[key].dtype == want[key].dtype
      assert torch.equal(got[key], want[key]), (source, key)

  pano = random_pano(32, 9)
  outs = []
  for source in (path, model_dir):
    cfg = dataclasses.replace(config_t.get_test_config(), ckpt_path=source)
    m = inference_t.SE3DSModel(cfg, device='cpu')
    for key, value in m.model.state_dict().items():
      assert torch.equal(value, want[key]), key
    m.add_to_memory(*pano, ORIGIN)
    outs.append([x for x in m(POSES[:1], add_preds_to_memory=True)
                 if x is not None])
  for x, y in zip(*outs):
    assert torch.equal(x, y)


def test_checkpoint_paths_that_cannot_serve_raise(tmp_path):
  base = config_t.get_test_config()
  serve = lambda path: inference_t.SE3DSModel(
      dataclasses.replace(base, ckpt_path=str(path)), device='cpu')
  with pytest.raises(FileNotFoundError):
    serve(tmp_path / 'missing')
  with pytest.raises(FileNotFoundError):
    serve(tmp_path)  # a directory without a checkpoint
  orbax = tmp_path / 'orbax'
  (orbax / '4').mkdir(parents=True)
  (orbax / '4' / '_CHECKPOINT_METADATA').write_text('{}')
  for path in (orbax, orbax / '4'):
    with pytest.raises(ValueError, match='Orbax'):
      serve(path)
  bundle_dir = tmp_path / 'bundle'
  checkpoints_t.CheckpointManager(str(bundle_dir)).save(1, _train_state(0))
  with pytest.raises(ValueError, match='target='):
    checkpoints_t.restore_ema_generator(str(bundle_dir))


# -- .ply -------------------------------------------------------------------


@pytest.mark.parametrize('layout', ['ring', 'compact'])
def test_pointcloud_file_is_byte_equal_to_jax(variables, jax_runs, layout,
                                              tmp_path):
  if layout == 'ring':
    model = _port(variables, memory_mode='ring')
    state, want = jax_runs['wrapped'], jax_runs['ply_ring']
  else:
    model = _port(variables, pole_compact=True)
    state, want = jax_runs['compact'], jax_runs['ply_compact']
  model.set_memory_state(_torch_state(state))
  got = _read_ply(model, tmp_path / 'memory.ply')
  assert got.count(b'\n') > 1000
  assert got == want
