"""The CUDA kernels on the card, against their plain versions, and the
training slice on the card against the CPU.

These tests need an NVIDIA card and nvcc (a CUDA kernel has no CPU mode)
and skip elsewhere. They import no JAX, so they run where the port runs:

    python -m pytest --noconftest -q tests/test_torch_cuda.py
"""

import dataclasses

import numpy as np
import pytest
import torch

from se3ds_torch import tracing
from se3ds_torch.eval import metrics
from se3ds_torch.models import discriminator as discriminator_lib
from se3ds_torch.models import folding
from se3ds_torch.models import generator as generator_lib
from se3ds_torch.models import inference
from se3ds_torch.models import layers
from se3ds_torch.models import model_config
from se3ds_torch.ops import geometry
from se3ds_torch.ops import splat
from se3ds_torch.ops import splat_cuda
from se3ds_torch.train import checkpoints
from se3ds_torch.train import state as state_lib
from se3ds_torch.train import trainer as trainer_lib

FAST, EXACT = 'splat.fast_launches', 'splat.exact_launches'


@pytest.fixture
def card():
  if not torch.cuda.is_available():
    pytest.skip('needs an NVIDIA card: the CUDA splat has no CPU mode')
  return torch.device('cuda')


def _cloud(seed, batch, num_points, channels, device, fractional=False):
  rs = np.random.RandomState(seed)
  z = rs.uniform(-1.0, 25.0, (batch, num_points)).astype(np.float32)
  xy = rs.uniform(-1.3, 1.3, (batch, 2, num_points)).astype(np.float32)
  coords = np.concatenate([xy * z[:, None], z[:, None],
                           np.ones_like(z)[:, None]], axis=1)
  feats = rs.randint(-1, 256, (batch, num_points, channels))
  if fractional:  # negative, fractional, non-void values too
    feats = feats + rs.randint(-8, 8, feats.shape) / 4.0
  feats = feats.astype(np.float32)
  return (torch.from_numpy(coords).to(device),
          torch.from_numpy(feats).to(device))


@pytest.mark.cuda
@pytest.mark.parametrize('batch,num_points,channels', [
    (1, 200000, 3), (2, 100000, 1), (1, 0, 3), (3, 5000, 2)])
def test_kernel_equals_plain_version(card, batch, num_points, channels):
  """Tolerance: none (torch.equal); min and max are order-free."""
  coords, feats = _cloud(batch + num_points, batch, num_points, channels,
                         card)
  before = tracing.count(FAST)
  zk, pk = splat_cuda.splat_fast(coords, feats, 64, 256, 20.0, -1.0)
  zp, pp = splat_cuda.splat_fast_plain(coords, feats, 64, 256, 20.0, -1.0)
  torch.cuda.synchronize()
  assert tracing.count(FAST) == before + (1 if num_points else 0)
  assert torch.equal(zk, zp) and torch.equal(pk, pp)


@pytest.mark.cuda
def test_strided_inputs_reach_the_kernel(card):
  """A batch slice of a larger memory buffer (non-contiguous batch)."""
  coords, feats = _cloud(5, 2, 30000, 3, card)
  coords, feats = coords[:, :, :20000], feats[:, :20000]
  zk, pk = splat_cuda.splat_fast(coords, feats, 32, 128, 20.0, -1.0)
  zp, pp = splat_cuda.splat_fast_plain(coords, feats, 32, 128, 20.0, -1.0)
  assert torch.equal(zk, zp) and torch.equal(pk, pp)


@pytest.mark.cuda
def test_cuda_tensors_never_take_the_plain_version(card):
  coords, feats = _cloud(6, 1, 1000, 3, card)
  before = tracing.count(FAST)
  splat.project_to_feat_fast(coords, feats, 32, 64, 20.0, -1.0)
  assert tracing.count(FAST) == before + 1
  with pytest.raises(TypeError):
    splat.project_to_feat_fast(coords.double(), feats, 32, 64, 20.0, -1.0)


@pytest.mark.cuda
def test_model_serves_on_the_card_by_default(card):
  model = inference.SE3DSModel(model_config.get_test_config())
  assert model.device.type == 'cuda'
  rs = np.random.RandomState(0)
  model.add_to_memory(rs.randint(0, 256, (1, 32, 64, 3)),
                      rs.randint(0, 42, (1, 32, 64, 1)),
                      rs.uniform(0.1, 0.8, (1, 32, 64)).astype(np.float32),
                      np.zeros((1, 3), np.float32))
  before = tracing.count(FAST)
  out = model(np.array([[0.3, 0, 0]], np.float32), add_preds_to_memory=True)
  assert tracing.count(FAST) == before + 2
  assert out.pred_rgb.is_cuda and out.pred_rgb.dtype == torch.uint8


@pytest.mark.cuda
@pytest.mark.parametrize('batch,num_points,channels,fractional', [
    (1, 200000, 3, False), (2, 100000, 1, True), (1, 0, 3, False),
    (3, 5000, 5, True)])
def test_exact_kernel_equals_plain_version(card, batch, num_points, channels,
                                           fractional):
  """Tolerance: none (torch.equal); min and max are order-free."""
  coords, feats = _cloud(batch + num_points, batch, num_points, channels,
                         card, fractional)
  before = tracing.count(EXACT)
  zk, fk = splat_cuda.splat_exact(coords, feats, 64, 256, 20.0, -1.0, -1.0)
  zp, fp = splat_cuda.splat_exact_plain(coords, feats, 64, 256, 20.0, -1.0,
                                        -1.0)
  torch.cuda.synchronize()
  # Both passes are one cooperative launch.
  assert tracing.count(EXACT) == before + (1 if num_points else 0)
  assert torch.equal(zk, zp) and torch.equal(fk, fp)


@pytest.mark.cuda
def test_exact_splat_never_takes_the_plain_version(card):
  coords, feats = _cloud(7, 1, 1000, 3, card)
  before = tracing.count(EXACT)
  splat.project_to_feat(coords, feats, 32, 64, 20.0, -1.0)
  assert tracing.count(EXACT) == before + 1
  with pytest.raises(TypeError):
    splat.project_to_feat(coords.double(), feats, 32, 64, 20.0, -1.0)


@pytest.mark.cuda
def test_rollout_runs_on_the_card_by_default(card):
  cfg = model_config.get_test_config()
  with torch.device(card):
    generator = generator_lib.ResNetGenerator(
        gen_dims=cfg.gen_dims, resnet_version=cfg.resnet_version).eval()
  # The layers allocate their weights uninitialised; fill them from a seed.
  folding.init_random_(generator, torch.Generator(device=card).manual_seed(0))
  rs = np.random.RandomState(1)
  batch = {'image': rs.rand(1, 2, 32, 64, 3).astype(np.float32),
           'depth': rs.uniform(0.1, 0.8, (1, 2, 32, 64, 1)).astype(
               np.float32),
           'position': np.zeros((1, 2, 4), np.float32)}
  before = tracing.count(EXACT)
  generated, _, _ = metrics.rollout_generated(generator, batch, 2, 20.0)
  assert tracing.count(EXACT) == before + 2  # one per frame
  assert generated[1].is_cuda and torch.isfinite(generated[1]).all()


def _world_cloud(seed, batch, num_points, channels, device):
  """World points around a camera, some voids, and the (B, 4) offset."""
  rs = np.random.RandomState(seed)
  xyz = rs.uniform(-6.0, 6.0, (batch, 4, num_points)).astype(np.float32)
  xyz[:, 3] = 1.0
  xyz[:, :3, :8] = 0.0  # at the world origin
  feats = rs.randint(-1, 256, (batch, num_points, channels)).astype(
      np.float32)
  offset = np.zeros((batch, 4), np.float32)
  offset[:, :3] = rs.uniform(-1.0, 1.0, (batch, 3))
  offset[0, :3] = 0.0  # points at the camera: rad 0
  return (torch.from_numpy(xyz).to(device),
          torch.from_numpy(feats).to(device),
          torch.from_numpy(offset).to(device))


# (splat_mode, channels, need_depth): the semantic and RGB clouds of the
# serving splat, and the rollout's exact splat.
EQUIRECT_CASES = [('fast', 1, False), ('fast', 3, True), ('sorted', 3, True)]


@pytest.mark.cuda
@pytest.mark.parametrize('mode,channels,need_depth', EQUIRECT_CASES)
@pytest.mark.parametrize('strided', [False, True])
def test_equirect_kernels_equal_plain_version(card, mode, channels,
                                              need_depth, strided):
  """World points and a camera offset through the fused prelude against
  the plain path (translate, equirect_view_coords, plain splat) on the
  same card tensors; with `strided`, a batch slice of a larger memory.
  Tolerance: none (torch.equal)."""
  xyz, feats, offset = _world_cloud(channels, 2, 60000, channels, card)
  if strided:
    xyz, feats = xyz[:, :, :40000], feats[:, :40000]
  counter = FAST if mode == 'fast' else EXACT
  before = tracing.count(counter)
  depth, feat = geometry.project_memory_equirect(
      feats, xyz, offset, 64, 128, -1.0, 20.0, mode, need_depth=need_depth)
  plain_depth, plain_feat = geometry.project_memory_equirect_plain(
      feats, xyz, offset, 64, 128, -1.0, 20.0, mode)
  torch.cuda.synchronize()
  assert tracing.count(counter) == before + 1
  assert torch.equal(feat, plain_feat)
  if need_depth:
    assert torch.equal(depth, plain_depth)
  else:
    assert depth is None


def _forbid(monkeypatch, module, *names):
  def refuse(*args, **kwargs):
    raise AssertionError('the plain path ran on the card')
  for name in names:
    monkeypatch.setattr(module, name, refuse)


@pytest.mark.cuda
def test_card_paths_never_run_the_plain_prelude_or_splat(card, monkeypatch):
  """Serving and the rollout on the card reach the kernels only: neither
  `equirect_view_coords` nor a plain splat runs. Launch counts: 2 'fast'
  point passes per served frame, 1 exact launch per rollout frame."""
  _forbid(monkeypatch, geometry, 'equirect_view_coords')
  _forbid(monkeypatch, splat_cuda, 'splat_fast_plain', 'splat_exact_plain')
  model = inference.SE3DSModel(dataclasses.replace(
      model_config.get_test_config(), memory_frames=4))
  rs = np.random.RandomState(0)
  model.add_to_memory(rs.randint(0, 256, (1, 32, 64, 3)),
                      rs.randint(0, 42, (1, 32, 64, 1)),
                      rs.uniform(0.1, 0.8, (1, 32, 64)).astype(np.float32),
                      np.zeros((1, 3), np.float32))
  fast, exact = tracing.count(FAST), tracing.count(EXACT)
  model(np.array([[0.3, 0, 0]], np.float32), add_preds_to_memory=True)
  model.predict_trajectory(np.array([[0.5, 0, 0], [0.6, 0.1, 0]],
                                    np.float32))
  assert tracing.count(FAST) == fast + 2 * 3
  assert tracing.count(EXACT) == exact
  generator = model.model
  batch = {'image': rs.rand(2, 3, 32, 64, 3).astype(np.float32),
           'depth': rs.uniform(0.1, 0.8, (2, 3, 32, 64, 1)).astype(
               np.float32),
           'position': rs.uniform(-0.2, 0.2, (2, 3, 4)).astype(np.float32)}
  fast = tracing.count(FAST)
  metrics.rollout_generated(generator, batch, 3, 20.0)
  assert tracing.count(EXACT) == exact + 3
  assert tracing.count(FAST) == fast


@pytest.mark.cuda
def test_serving_proj_depth_equals_the_cpu_on_unmoved_pixels(card):
  """The serving splat stage on one memory, on the card and on the CPU:
  proj_depth, a square root and a divide, is bit-equal on every pixel
  that no point entered or left (trigonometry differs by ULPs between the
  card and the CPU) and that holds no point whose radius the CPU's
  torch.sqrt rounds off the correctly rounded one; the guidance moves on
  at most 0.5% of the pixels."""
  model = inference.SE3DSModel(model_config.get_test_config(), device=card)
  rs = np.random.RandomState(2)
  model.add_to_memory(rs.randint(0, 256, (1, 32, 64, 3)),
                      rs.randint(0, 42, (1, 32, 64, 1)),
                      rs.uniform(0.1, 0.8, (1, 32, 64)).astype(np.float32),
                      np.zeros((1, 3), np.float32))
  model(np.array([[0.2, 0.05, 0.0]], np.float32), add_preds_to_memory=True)
  live = model._live_memory(model.get_memory_state(), 2, 1)
  host = live._replace(**{k: v.cpu() for k, v in live._asdict().items()
                          if k != 'cursor'})
  position = torch.tensor([[0.3, -0.1, 0.05]])
  ref = inference.memory_project(host, position, 32, 64, 20.0)
  got = inference.memory_project(live, position.to(card), 32, 64, 20.0)
  moved = ((got[2].cpu() != ref[2]).any(-1) | (got[0].cpu() != ref[0])[..., 0]
           | (got[3].cpu() != ref[3])[..., 0])
  # The pixels an RGB point enters or leaves between the two devices' view
  # coordinates, and those of the points whose radius the CPU's torch.sqrt
  # does not round correctly (numpy's float32 sqrt, as the card's, does).
  offset = torch.cat([position, torch.zeros((1, 1))], 1)
  flats = [splat.pixel_coords(geometry.equirect_view_coords(
      x - offset.to(x.device)[..., None]), f, 32, 64, -1.0)[0].cpu()
           for x, f in ((live.rgb_coords, live.rgb), (host.rgb_coords,
                                                      host.rgb))]
  rel = host.rgb_coords - offset[..., None]
  sq = rel[:, 0] * rel[:, 0] + rel[:, 1] * rel[:, 1] + rel[:, 2] * rel[:, 2]
  sqrt_off = torch.sqrt(sq) != torch.from_numpy(np.sqrt(sq.numpy()))
  apart = torch.zeros((1, 32 * 64 + 1), dtype=torch.bool)
  for points, sources in ((flats[0] != flats[1], flats),
                          (sqrt_off, flats[1:])):
    for flat in sources:
      apart.scatter_(1, torch.where(points, flat, 32 * 64), True)
  print(f'moved {int(moved.sum())} of {moved.numel()} pixels')
  assert moved.float().mean() <= 0.005
  moved |= apart[:, :-1].reshape(1, 32, 64)
  assert torch.equal(got[1].cpu()[~moved], ref[1][~moved])


# -- training -----------------------------------------------------------------


def _tiny_trainer(model_dir, device=None):
  """The trainer at the sizes of tests/test_train.py."""
  return trainer_lib.Trainer(
      str(model_dir), image_size=32, seed=0, beta1=0.5, g_lr=1e-4, d_lr=4e-4,
      train_batch_size=2, d_step_per_g_step=2, num_batched_steps=2,
      predict_depth=True, mask_blurred=True,
      generator_fn=lambda image_size: generator_lib.ResNetGenerator(
          gen_dims=2, z_dim=2, resnet_version='tiny', spectral_fold=False),
      discriminator_fn=lambda image_size: (
          discriminator_lib.SNMultiScaleDiscriminator(n_dis=2, dis_dims=2,
                                                      n_layers=3)),
      device=device)


def _train_batch(seed):
  rs = np.random.RandomState(seed)
  batch = {'image': rs.rand(4, 32, 64, 3),
           'depth': rs.uniform(-0.1, 1.1, (4, 32, 64, 1)),
           'proj_image': rs.rand(4, 32, 64, 3),
           'proj_depth': rs.rand(4, 32, 64, 1),
           'proj_mask': rs.rand(4, 32, 64, 1) > 0.3,
           'blurred_mask': rs.rand(4, 32, 64, 1) > 0.9}
  return {k: v.astype(np.float32) for k, v in batch.items()}


@pytest.mark.cuda
def test_train_step_on_the_card_matches_the_cpu(card, tmp_path, monkeypatch):
  """One tiny train step from the same state on the card (TF32 off) and
  on the CPU. Tolerances as chip_smoke.py's TINY_TOLERANCES (the port's
  own float32 step differs from its float64 step by up to ~1e-3 of the
  largest first Adam moment on this batch): metrics rtol 1e-3, Adam
  moments 3e-3 of the largest, parameters 1e-5 where |first moment| >=
  1e-3 of the largest, BatchNorm statistics and u 1e-5."""
  monkeypatch.setattr(torch.backends.cudnn, 'allow_tf32', False)
  trainers = [_tiny_trainer(tmp_path, d) for d in ('cpu', card)]
  assert trainers[1].device.type == 'cuda'
  states = [t.create_state() for t in trainers]
  checkpoints.load_bundle(states[1], checkpoints.state_bundle(states[0]))
  batch = _train_batch(1)
  metrics = [state_lib.train_step(s, t.device_batch(batch), t.hp)
             for s, t in zip(states, trainers)]
  for key, value in metrics[0].items():
    np.testing.assert_allclose(float(metrics[1][key]), float(value),
                               rtol=1e-3, atol=1e-7, err_msg=key)
  tolerances = {'params': 1e-5, 'stats': 1e-5, 'u': 1e-5, 'exp_avg': 3e-3,
                'exp_avg_sq': 3e-3, 'adam_steps': 0.0}
  diffs = state_lib.state_differences(states[1], states[0])
  for key, value in diffs.items():
    kind = key.split('_', 1)[-1]
    assert value <= tolerances.get(kind, float('inf')), (key, value)


@pytest.mark.cuda
def test_checkpoint_round_trip_on_the_card(card, tmp_path):
  """A trainer on the card by default; its state after a step saved and
  restored into a fresh state is bit-equal, tensors on the same devices
  (the optimizers' step counts stay on the CPU)."""
  trainer = _tiny_trainer(tmp_path)
  assert trainer.device.type == 'cuda'
  state = trainer.create_state()
  state_lib.train_step(state, trainer.device_batch(_train_batch(2)),
                       trainer.hp)
  manager = checkpoints.CheckpointManager(str(tmp_path))
  manager.save(state.step, state)
  restored = trainer.create_state()
  manager.restore(restored)
  assert checkpoints.bundles_equal(checkpoints.state_bundle(state),
                                   checkpoints.state_bundle(restored))
  step_devices = {s['step'].device.type for s in restored.g_opt.state.values()}
  assert step_devices == {'cpu'}


@pytest.mark.cuda
def test_remat_equals_stored_activations_on_the_card(card, tmp_path,
                                                     monkeypatch):
  """One tiny step with remat and one storing activations, from one
  state, cuDNN deterministic and TF32 off: metrics and the whole bundle
  (G, D, the EMA, both Adam states) torch.equal."""
  monkeypatch.setattr(torch.backends.cudnn, 'allow_tf32', False)
  monkeypatch.setattr(torch.backends.cudnn, 'deterministic', True)
  monkeypatch.setattr(torch.backends.cudnn, 'benchmark', False)
  trainer = _tiny_trainer(tmp_path)
  batch = trainer.device_batch(_train_batch(3))
  metrics, bundles = [], []
  for remat in (False, True):
    state = trainer.create_state()
    metrics.append(state_lib.train_step(state, batch,
                                        trainer.hp._replace(remat=remat)))
    bundles.append(checkpoints.state_bundle(state))
  for key, value in metrics[0].items():
    assert torch.equal(metrics[1][key], value), key
  assert checkpoints.bundles_equal(*bundles)


def _float64_state(trainer):
  generator, discriminator = (m.to(trainer.device)
                              for m in trainer._build_models())
  rng = torch.Generator(device=trainer.device).manual_seed(trainer.seed)
  folding.init_random_(generator, rng)
  folding.init_random_(discriminator, rng)
  generator.double().dtype = torch.float64
  return state_lib.create_train_state(
      generator, discriminator.double(), trainer.g_lr, trainer.d_lr,
      trainer.beta1, trainer.beta2, trainer.data)


@pytest.mark.cuda
def test_world_one_nccl_group_step(card, tmp_path, monkeypatch):
  """A float64 step through a world-1 NCCL group (`file://` rendezvous:
  the synced BatchNorm, the gradient all_reduce) against the step
  without a group; tolerances of tests/test_torch_distributed.py."""
  import torch.distributed as dist
  monkeypatch.setattr(torch.backends.cudnn, 'deterministic', True)
  batch = {k: v.double() for k, v in _tiny_trainer(tmp_path).device_batch(
      _train_batch(4)).items()}
  alone_trainer = _tiny_trainer(tmp_path / 'alone')
  alone = _float64_state(alone_trainer)
  want = state_lib.train_step(alone, batch, alone_trainer.hp)
  dist.init_process_group('nccl', init_method=f'file://{tmp_path}/rv',
                          world_size=1, rank=0)
  try:
    trainer = _tiny_trainer(tmp_path / 'group')
    assert dist.get_backend() == 'nccl' and trainer.data.world_size == 1
    state = _float64_state(trainer)
    got = state_lib.train_step(state, batch, trainer.hp)
  finally:
    dist.destroy_process_group()
  for key, value in want.items():
    np.testing.assert_allclose(float(got[key]), float(value), rtol=1e-6,
                               atol=1e-9, err_msg=key)
  tolerances = {'params': 1e-8, 'stats': 1e-7, 'u': 1e-9, 'exp_avg': 1e-6,
                'exp_avg_sq': 1e-6, 'adam_steps': 0.0}
  for key, value in state_lib.state_differences(state, alone).items():
    assert value <= tolerances.get(key.split('_', 1)[-1], float('inf')), (
        key, value)


@pytest.mark.cuda
def test_cli_train_then_test_on_the_card(card, tmp_path):
  """`python -m se3ds_torch.main` TRAIN then TEST with configs/tiny_test.gin
  on fixture records, on the card by default (no --device): the eval's
  rollouts launch the exact CUDA splat, and every score in
  scores_val_seen.csv is finite."""
  import csv
  import os
  from se3ds_torch import main as main_lib
  from se3ds_torch.data import synthetic
  repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
  data = tmp_path / 'data'
  data.mkdir()
  synthetic.write_image_fixture(str(data / 'train-0.tfrecord'),
                                num_examples=8, height=64)
  synthetic.write_video_fixture(str(data / 'val_seen-0.tfrecord'),
                                num_examples=2, height=64)
  argv = ['--model_dir', str(tmp_path / 'model'), '--gin_config',
          os.path.join(repo, 'configs', 'tiny_test.gin')]
  for binding in (f"R2RImageDataset.data_dir = '{data}/'",
                  f"R2RVideoDataset.data_dir = '{data}/'",
                  'GAN.num_epochs = 1',
                  "R2RImageDataset.num_examples_override = {'train': 8}"):
    argv += ['--gin_bindings', binding]
  assert main_lib.main(argv + ['--mode', 'TRAIN']) == 0
  before = tracing.count(EXACT)
  assert main_lib.main(argv + ['--mode', 'TEST']) == 0
  assert tracing.count(EXACT) > before
  with open(tmp_path / 'model' / 'scores_val_seen.csv') as f:
    (row,) = list(csv.DictReader(f))
  scores = {k: float(v) for k, v in row.items() if '/eval_image/' in k}
  assert len(scores) == 6
  assert all(np.isfinite(v) for v in scores.values()), scores


def _recording_stage(monkeypatch):
  """Records every call of the splat stage (cloned inputs and outputs)."""
  calls = []
  stage = geometry.project_memory_equirect

  def recording(feats, xyz1, offset, *args, **kwargs):
    out = stage(feats, xyz1, offset, *args, **kwargs)
    # Clones: the memory is written in place by later steps.
    calls.append((tuple(a.clone() if torch.is_tensor(a) else a
                        for a in (feats, xyz1, offset) + args), kwargs,
                  [o if o is None else o.clone() for o in out],
                  (feats.stride(0), xyz1.stride(0))))
    return out

  monkeypatch.setattr(geometry, 'project_memory_equirect', recording)
  return calls


def _assert_stage_equals_plain(calls):
  """Each recorded kernel stage torch.equal to the plain version on the
  card, on the same inputs."""
  assert calls
  for args, kwargs, out, _ in calls:
    kwargs = {k: v for k, v in kwargs.items() if k != 'need_depth'}
    plain = geometry.project_memory_equirect_plain(*args, **kwargs)
    for got, want in zip(out, plain):
      if got is not None:
        assert torch.equal(got, want)


@pytest.mark.cuda
def test_ring_steps_across_the_wrap_equal_the_plain_splat(card, monkeypatch):
  """Ring memory of 3 frames: one real frame, 4 feedback steps (the write
  wraps at the third) and a trajectory of 2; every splat torch.equal to
  its plain version."""
  # The recording stage runs in Python, which a replayed graph does not:
  # this holds the eager path, and test_graph_serving_equals_eager holds
  # the graphs to it.
  model = inference.SE3DSModel(dataclasses.replace(
      model_config.get_test_config(), memory_mode='ring'), cuda_graphs=False)
  rs = np.random.RandomState(1)
  model.add_to_memory(rs.randint(0, 256, (1, 32, 64, 3)),
                      rs.randint(0, 42, (1, 32, 64, 1)),
                      rs.uniform(0.1, 0.8, (1, 32, 64)).astype(np.float32),
                      np.zeros((1, 3), np.float32))
  calls = _recording_stage(monkeypatch)
  for i in range(4):
    model(np.array([[0.2 * i, 0.05, 0]], np.float32),
          add_preds_to_memory=True)
  model.predict_trajectory(np.array([[0.5, 0, 0], [0.6, 0.1, 0]],
                                    np.float32))
  assert (model._frames_written, model._total_frames) == (3, 7)
  assert len(calls) == 2 * 6
  _assert_stage_equals_plain(calls)


@pytest.mark.cuda
def test_predict_poses_on_a_stride_0_memory_equals_the_plain_splat(
    card, monkeypatch):
  """K = 4 poses read the memory at batch stride 0; the guidance equals
  the plain version's and K single calls'."""
  model = inference.SE3DSModel(model_config.get_test_config(),
                               cuda_graphs=False)  # as the ring test
  rs = np.random.RandomState(2)
  model.add_to_memory(rs.randint(0, 256, (1, 32, 64, 3)),
                      rs.randint(0, 42, (1, 32, 64, 1)),
                      rs.uniform(0.1, 0.8, (1, 32, 64)).astype(np.float32),
                      np.zeros((1, 3), np.float32))
  poses = rs.uniform(-0.4, 0.4, (4, 3)).astype(np.float32)
  calls = _recording_stage(monkeypatch)
  out = model.predict_poses(poses)
  assert [c[3] for c in calls] == [(0, 0), (0, 0)]
  _assert_stage_equals_plain(calls)
  singles = [model(p[None]) for p in poses]
  for key in ('proj_rgb', 'proj_semantic', 'proj_depth', 'proj_mask'):
    assert torch.equal(getattr(out, key),
                       torch.cat([getattr(s, key) for s in singles]))


@pytest.mark.cuda
def test_re10k_cloud_equals_the_plain_splat(card, monkeypatch):
  """The RE10K config's unmasked, uncompacted cloud, from a perspective
  source warped on the card."""
  cfg = dataclasses.replace(model_config.get_re10k_config(), ckpt_path=None,
                            image_height=32, gen_dims=4,
                            resnet_version='tiny', memory_frames=3)
  model = inference.SE3DSModel(cfg, cuda_graphs=False)  # as the ring test
  rs = np.random.RandomState(3)
  fov = torch.tensor([0.8, 0.8], device=card)
  rgb = geometry.project_perspective_image(
      torch.from_numpy(rs.rand(32, 32, 3).astype(np.float32) * 255).to(card),
      fov, 32, pad_value=-1.0)
  depth = geometry.project_perspective_image(
      torch.from_numpy(rs.uniform(0.1, 0.5, (32, 32, 1)).astype(
          np.float32)).to(card), fov, 32)[..., 0]
  model.add_to_memory(torch.clamp(rgb, 0, 255).int()[None],
                      torch.zeros((1, 32, 64, 1), dtype=torch.int32,
                                  device=card),
                      torch.clamp(depth, 0, 1)[None],
                      np.zeros((1, 3), np.float32), mask_blurred=False)
  calls = _recording_stage(monkeypatch)
  for i in range(2):
    model(np.array([[0.1 * i, 0.05, 0]], np.float32),
          add_preds_to_memory=True)
  _assert_stage_equals_plain(calls)


@pytest.mark.cuda
def test_perspective_functions_on_the_card_equal_the_cpu(card):
  """Warps and resizes on the card against the CPU. Tolerance: atol 0.02
  on values in [0, 255] (the card's and the CPU's trig round by an ULP
  apart; a bilinear sample moves by up to ~255 ULP of its coordinate),
  1e-3 for the resizes (float32 sums in other orders)."""
  from se3ds_torch.ops import image
  rs = np.random.RandomState(4)
  persp = torch.from_numpy(rs.rand(24, 24, 3).astype(np.float32) * 255)
  pano = torch.from_numpy(rs.rand(16, 32, 3).astype(np.float32) * 255)
  rotation = torch.from_numpy(np.linalg.qr(rs.randn(3, 3))[0].astype(
      np.float32))
  intrinsics = torch.tensor([[30., 0, 12], [0, 28, 11], [0, 0, 1]])
  fov = torch.tensor([0.8, 0.9])
  cases = {
      'project_perspective_image': lambda d: geometry.project_perspective_image(
          persp.to(d), fov.to(d), 16, rotations=(0.1, 0.4), pad_value=-1.0),
      'get_perspective_from_equirectangular_image':
          lambda d: geometry.get_perspective_from_equirectangular_image(
              pano.to(d), intrinsics.to(d), rotation.to(d), 20, 24),
      'rotate_pano': lambda d: geometry.rotate_pano(
          pano[None].to(d), rotation[None].to(d)),
      'resize cubic': lambda d: image.resize(pano.to(d), (40, 80), 'bicubic'),
      'resize linear antialias': lambda d: image.resize(
          pano.to(d), (9, 18), 'bilinear', antialias=True),
  }
  for name, fn in cases.items():
    got, want = fn(card).cpu(), fn(torch.device('cpu'))
    atol = 1e-3 if name.startswith('resize') else 2e-2
    assert got.shape == want.shape, name
    assert float((got - want).abs().max()) <= atol, name


@pytest.mark.cuda
@pytest.mark.parametrize('channels', [1, 3, 5])
def test_split_exact_passes_equal_the_cooperative_launch(card, channels):
  """`exact_pass` 1 then 2 (two ordinary launches) gives the words of the
  one cooperative launch, and each counts one launch; tolerance: none."""
  coords, feats = _cloud(40 + channels, 2, 150000, channels, card,
                         fractional=True)
  args = (coords, feats, 64, 128, 20.0, -1.0)
  coop = splat_cuda.exact_words(*args)
  before = tracing.count(EXACT)
  words = splat_cuda.exact_pass(*args, 1)
  words = splat_cuda.exact_pass(*args, 2, words=words)
  torch.cuda.synchronize()
  assert tracing.count(EXACT) == before + 2
  assert torch.equal(words, coop)


@pytest.mark.cuda
@pytest.mark.parametrize('mode', ['fast', 'fast_exact', 'scatter'])
def test_sharded_splat_at_world_one_equals_the_unsharded(card, mode,
                                                         tmp_path):
  """The point-sharded splat on a world-1 NCCL group (the kernels' split
  entry points and the words' unsigned-minimum combine), world points
  at a camera offset, 3 and 5 channels; tolerance: none."""
  import torch.distributed as dist
  from se3ds_torch.parallel import mesh as mesh_lib
  from se3ds_torch.parallel import splat_shard
  dist.init_process_group('nccl', init_method=f'file://{tmp_path}/rv',
                          world_size=1, rank=0)
  try:
    group = mesh_lib.create_mesh(1, 1).get_group('data')
    for channels in (3, 5):
      xyz, feats = _cloud(50 + channels, 2, 120000, channels, card)
      offset = torch.tensor([[0.3, -0.2, 0.1, 0.0]], device=card)
      got = splat_shard.project_memory_equirect_sharded(
          feats, xyz, offset, 64, 128, -1.0, 20.0, group=group,
          splat_mode=mode)
      want = geometry.project_memory_equirect(feats, xyz, offset, 64, 128,
                                              -1.0, 20.0, mode)
      assert all(torch.equal(a, b) for a, b in zip(got, want)), channels
  finally:
    dist.destroy_process_group()


# -- the serving API as captured CUDA graphs ---------------------------------


def _serve(model, rs_seed=4, passes=2, pano=None, mask_blurred=True):
  """add_to_memory, 3 feedback steps, 2 read-only calls, a trajectory of
  2 and 2 poses, `passes` times from an emptied memory (a graph model
  warms each key up in the first pass and replays it after); every
  OutputData."""
  rs = np.random.RandomState(rs_seed)
  if pano is None:
    pano = (rs.randint(0, 256, (1, 32, 64, 3)),
            rs.randint(0, 42, (1, 32, 64, 1)),
            rs.uniform(0.1, 0.8, (1, 32, 64)).astype(np.float32))
  outs = []
  for _ in range(passes):
    model.reset_memory()
    model.add_to_memory(*pano, np.zeros((1, 3), np.float32),
                        mask_blurred=mask_blurred)
    for i in range(3):
      outs.append(model(np.array([[0.2 * i, 0.05, 0]], np.float32),
                        add_preds_to_memory=True))
    for i in range(2):
      outs.append(model(np.array([[0.1, 0.1 * i, 0]], np.float32)))
    outs.append(model.predict_trajectory(
        np.array([[0.5, 0, 0], [0.6, 0.1, 0]], np.float32)))
    outs.append(model.predict_poses(
        np.array([[0.3, 0.1, 0], [-0.2, 0.2, 0]], np.float32)))
  return outs


def _re10k_pano(card):
  """A pano warped on the card from a random perspective source, as the
  RE10K flow writes it (no semantics)."""
  rs = np.random.RandomState(3)
  fov = torch.tensor([0.8, 0.8], device=card)
  rgb = geometry.project_perspective_image(
      torch.from_numpy(rs.rand(32, 32, 3).astype(np.float32) * 255).to(card),
      fov, 32, pad_value=-1.0)
  depth = geometry.project_perspective_image(
      torch.from_numpy(rs.uniform(0.1, 0.5, (32, 32, 1)).astype(
          np.float32)).to(card), fov, 32)[..., 0]
  return (torch.clamp(rgb, 0, 255).int()[None],
          torch.zeros((1, 32, 64, 1), dtype=torch.int32, device=card),
          torch.clamp(depth, 0, 1)[None])


@pytest.mark.cuda
@pytest.mark.parametrize('config,mode', [('test', m) for m in
                                         geometry.SPLAT_MODES]
                         + [('re10k', 'fast')])
def test_graph_serving_equals_eager(card, config, mode):
  """In every splat mode, and on the RE10K config's perspective path,
  every entry point replayed from a captured graph gives the eager
  model's bits (torch.equal), and the launch counters count the replays'
  point passes (the exact modes' cooperative launch is captured too)."""
  serve = _serve
  if config == 're10k':
    cfg = dataclasses.replace(model_config.get_re10k_config(),
                              ckpt_path=None, image_height=32, gen_dims=4,
                              resnet_version='tiny', memory_frames=8)
    pano = _re10k_pano(card)
    serve = lambda m: _serve(m, pano=pano, mask_blurred=False)
  else:
    cfg = dataclasses.replace(model_config.get_test_config(),
                              memory_frames=8, splat_mode=mode)
  eager = inference.SE3DSModel(cfg, cuda_graphs=False)
  graph = inference.SE3DSModel(cfg)
  graph.model.load_state_dict(eager.model.state_dict())
  assert eager.graphs is None and graph.uncaptured is None
  launches, replays = [], tracing.count('serve.replays')
  for model in (eager, graph):
    before = tracing.count(FAST) + tracing.count(EXACT)
    outs = serve(model)
    launches.append(tracing.count(FAST) + tracing.count(EXACT) - before)
    model.outs = outs
  kernel = mode in geometry._SPLATS and geometry._SPLATS[mode][0]
  assert launches[0] == launches[1] == (2 * 2 * (3 + 2 + 2 + 1) if kernel
                                        else 0)
  assert tracing.count('serve.replays') - replays >= 8
  assert len(graph.graphs.graphs) >= 6
  for a, b in zip(eager.outs, graph.outs):
    _outputs_equal(a, b)


def _outputs_equal(a, b):
  for x, y in zip(a, b):
    if x is not None:
      assert torch.equal(x, y)


@pytest.mark.cuda
def test_replayed_outputs_are_fresh(card):
  """A replay overwrites the graph's outputs, never what a caller holds."""
  model = inference.SE3DSModel(dataclasses.replace(
      model_config.get_test_config(), memory_frames=8))
  outs = _serve(model, passes=1)
  kept = [[t.clone() for t in o if t is not None] for o in outs]
  _serve(model, passes=2)
  for o, k in zip(outs, kept):
    _outputs_equal([t for t in o if t is not None], k)


@pytest.mark.cuda
def test_debug_splat_refuses_a_capture(card, monkeypatch):
  """SE3DS_DEBUG_SPLAT's byte check reads back to the host: under a
  capture it raises instead."""
  monkeypatch.setenv('SE3DS_DEBUG_SPLAT', '1')
  model = inference.SE3DSModel(dataclasses.replace(
      model_config.get_test_config(), splat_mode='sorted_packed'))
  rs = np.random.RandomState(5)
  model.add_to_memory(rs.randint(0, 256, (1, 32, 64, 3)),
                      rs.randint(0, 42, (1, 32, 64, 1)),
                      rs.uniform(0.1, 0.8, (1, 32, 64)).astype(np.float32),
                      np.zeros((1, 3), np.float32))
  position = np.array([[0.3, 0, 0]], np.float32)
  model(position)  # the warm-up runs eagerly and checks
  with pytest.raises(RuntimeError, match='SE3DS_DEBUG_SPLAT'):
    model(position)


@pytest.mark.cuda
@pytest.mark.parametrize('height', [32, 512])
def test_unprojection_grid_on_the_card_is_numpys(card, height):
  half = 0.5 * np.pi / height
  for start, stop, num in ((half, np.pi - half, height),
                           (1.5 * np.pi - half, -0.5 * np.pi + half,
                            2 * height)):
    got = geometry._linspace_f32(start, stop, num, card).cpu().numpy()
    t = np.arange(num, dtype=np.float32) / np.float32(num - 1)
    want = (np.float32(start) * (np.float32(1) - t)
            + np.float32(stop) * t).astype(np.float32)
    want[-1] = np.float32(stop)
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.cuda
@pytest.mark.parametrize('every_s,pairs', [(0.0, 3), (60.0, 1)])
def test_timed_spans_read_their_device_time(card, monkeypatch, every_s,
                                            pairs):
  """A timed span's event pair is read at a later pair's recording once
  it has completed, or at `snapshot()`; its device time covers the work
  enqueued inside it; a name records a pair at most once in
  `TIMED_EVERY_S`."""
  monkeypatch.setattr(tracing, 'TIMED_EVERY_S', every_s)
  tracing.reset()
  x = torch.randn(4096, 4096, device=card)
  for _ in range(3):
    with tracing.span('serve.call', timed=True):
      with tracing.span('replay'):
        for _ in range(8):
          x = x @ x
          x = x / x.norm()
    torch.cuda.synchronize()
  spans = tracing.snapshot()['spans']
  device = spans['serve.call']['device_ms']
  assert spans['serve.call']['count'] == 3
  assert len(device) == pairs and min(device) > 0
  assert spans['serve.call.replay']['device_ms'] == []
  tracing.reset()


@pytest.mark.cuda
def test_served_step_runs_no_layout_transposes(card):
  """The released model's widths in bfloat16: a replayed served step keeps
  the generator in channels_last memory, so no convolution counts as NCHW
  and cuDNN transposes no operand into NHWC. The one NHWC-to-NCHW kernel
  it launches belongs to the depth head's last convolution, which has one
  output channel (the same memory in both layouts): cuDNN computes it with
  the channels padded to eight and copies channel 0 out with that kernel."""
  cfg = dataclasses.replace(model_config.get_config(), ckpt_path=None,
                            compute_dtype='bfloat16')
  model = inference.SE3DSModel(cfg)
  h, w = cfg.image_height, 2 * cfg.image_height
  rs = np.random.RandomState(6)
  model.add_to_memory(rs.randint(0, 256, (1, h, w, 3)),
                      rs.randint(0, 42, (1, h, w, 1)),
                      rs.uniform(0.1, 0.8, (1, h, w)).astype(np.float32),
                      np.zeros((1, 3), np.float32))
  position = np.array([[0.3, 0.1, 0]], np.float32)
  for _ in range(2):  # the eager warm-up, then the capture
    model(position)
  names = ('serve.replays', 'generator.convs', 'generator.nchw_convs')
  before = [tracing.count(n) for n in names]
  with torch.profiler.profile(
      activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
    model(position)
    torch.cuda.synchronize()
  moved = [tracing.count(n) - b for n, b in zip(names, before)]
  assert moved[0] == 1 and moved[1] > 0 and moved[2] == 0
  kernels = {e.key: e.count for e in prof.key_averages()}
  assert any('gemm' in k.lower() or 'conv' in k.lower() for k in kernels)
  assert not [k for k in kernels if 'nchwToNhwc' in k]
  one_channel = [m for m in model.model.modules()
                 if isinstance(m, layers._Conv) and m.weight.shape[0] == 1]
  assert [m.weight.shape for m in one_channel] == [(1, cfg.gen_dims, 3, 3)]
  assert sum(n for k, n in kernels.items()
             if 'nhwcToNchw' in k) <= len(one_channel)
