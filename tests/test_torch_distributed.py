"""Data-parallel training (`se3ds_torch.parallel.mesh`) on the CPU.

* Two gloo ranks (spawned processes, a `file://` rendezvous) step on
  their halves of every chunk of one global batch; the step must equal
  the world-1 step on the whole batch. Both run in float64: in float32
  at this size (BatchNorms over 8 elements per channel) either step
  differs from its float64 self by ~1e-2 of the largest Adam moment,
  which would hide a small fault. In float64 the two differ by what is
  still float32 in both: the clip's norms (tf.clip_by_norm's, which can
  move a clipped gradient by a float32 ulp, 6e-8) and the world-1
  BatchNorm's running statistics (taken in float32; the synced one takes
  them from the global sums in float64). So: Adam moments 1e-6 of the
  largest, parameters 1e-8, statistics 1e-7, u 1e-9, metrics rtol 1e-6.
  An unsynced BatchNorm or an unreduced gradient moves the state by more
  than 1e-3.
* The checkpoint rank 0 writes holds the consolidated ZeRO-1 shards in
  the bundle format of a world-1 run: it restores at world 1 and serves
  through `SE3DSModel(ckpt_path=...)`.
* `zero1_axis` over the port's tensors picks the axis JAX's
  `shard_leaf_zero1` picks on every leaf of the tiny state.
* The full lowres state at 8 ranks, built on the meta device: per-rank
  resident bytes against the JAX accounting of tests/test_memory_budget.py
  through `train_state_shardings`.
"""

import dataclasses
import os
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from se3ds_torch.models import discriminator as disc_t
from se3ds_torch.models import folding
from se3ds_torch.models import generator as gen_t
from se3ds_torch.models import inference as inference_t
from se3ds_torch.models import model_config as config_t
from se3ds_torch.parallel import mesh
from se3ds_torch.train import checkpoints as ckpt_t
from se3ds_torch.train import state as state_t
from se3ds_torch.train import trainer as trainer_t
from test_torch_serving import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures('one_torch_thread')

WORLD = 2
SERVE = config_t.get_test_config()
G_CONFIG = dict(gen_dims=SERVE.gen_dims, z_dim=SERVE.z_dim,
                resnet_version=SERVE.resnet_version)
D_CONFIG = dict(n_dis=2, dis_dims=2, n_layers=3)
# Float64 (see the docstring).
TOLERANCES = {'params': 1e-8, 'stats': 1e-7, 'u': 1e-9, 'exp_avg': 1e-6,
              'exp_avg_sq': 1e-6, 'adam_steps': 0.0}
METRIC_RTOL = 1e-6
TIMEOUT_S = 240


def _trainer(model_dir):
  return trainer_t.Trainer(
      model_dir, image_size=SERVE.image_height, seed=0, beta1=0.5, g_lr=1e-4,
      d_lr=4e-4, train_batch_size=4, d_step_per_g_step=2,
      num_batched_steps=1, predict_depth=True, mask_blurred=True,
      generator_fn=lambda image_size: gen_t.ResNetGenerator(
          spectral_fold=False, **G_CONFIG),
      discriminator_fn=lambda image_size: disc_t.SNMultiScaleDiscriminator(
          **D_CONFIG),
      device='cpu')


def _global_batch():
  """2 chunks of 4: each rank's share of a chunk is 2 examples."""
  return next(trainer_t.synthetic_batches(8, SERVE.image_height, 3))


def _float64_state(trainer):
  """`trainer.create_state()` in float64 (the same seeded weights)."""
  generator, discriminator = trainer._build_models()
  rng = torch.Generator().manual_seed(trainer.seed)
  folding.init_random_(generator, rng)
  folding.init_random_(discriminator, rng)
  generator.double().dtype = torch.float64
  return state_t.create_train_state(
      generator, discriminator.double(), trainer.g_lr, trainer.d_lr,
      trainer.beta1, trainer.beta2, trainer.data)


def _float64_batch(trainer, batch):
  return {k: v.double() for k, v in trainer.device_batch(batch).items()}


def _worker(rank, root):
  """One rank: a step on its slice, the checkpoint, the ZeRO-1 layout."""
  torch.set_num_threads(1)
  dist.init_process_group('gloo', init_method=f'file://{root}/rendezvous',
                          world_size=WORLD, rank=rank)
  try:
    trainer = _trainer(os.path.join(root, 'model'))
    state = _float64_state(trainer)
    local = trainer.data.local_batch(_global_batch(), 2)
    metrics = state_t.train_step(state, _float64_batch(trainer, local),
                                 trainer.hp)
    ckpt_t.CheckpointManager(trainer.model_dir).save(state.step, state)
    moments = sum(s['exp_avg'].numel() + s['exp_avg_sq'].numel()
                  for opt in (state.g_opt, state.d_opt)
                  for s in opt.state.values())
    try:  # no gloo on the card: the group must be NCCL there
      mesh.init_from_env(torch.device('cuda'))
      refused = False
    except RuntimeError:
      refused = True
    result = {'metrics': {k: float(v) for k, v in metrics.items()},
              'world': (trainer.data.world_size, trainer.data.rank),
              'local_examples': int(local['image'].shape[0]),
              'sharded_axes': sum(a is not None for a in state.g_opt.axes),
              'ema_numel': sum(p.numel() for p in state.ema.parameters()),
              'moment_numel': moments, 'refused_gloo_on_card': refused}
    torch.save(result, os.path.join(root, f'rank{rank}.pt'))
  finally:
    dist.destroy_process_group()


@pytest.fixture(scope='module')
def two_ranks(tmp_path_factory):
  """The world-2 run's per-rank results and model_dir, and the world-1
  state after the same step."""
  root = str(tmp_path_factory.mktemp('dp'))
  context = mp.start_processes(_worker, args=(root,), nprocs=WORLD,
                               join=False, start_method='spawn')
  deadline = time.monotonic() + TIMEOUT_S
  try:
    while not context.join(timeout=5):
      if time.monotonic() > deadline:
        raise TimeoutError(f'the {WORLD} ranks did not finish')
  finally:
    for process in context.processes:
      if process.is_alive():
        process.kill()
  ranks = [torch.load(os.path.join(root, f'rank{r}.pt')) for r in
           range(WORLD)]
  single = _trainer(os.path.join(root, 'single'))
  state = _float64_state(single)
  metrics = state_t.train_step(state, _float64_batch(single, _global_batch()),
                               single.hp)
  return ranks, os.path.join(root, 'model'), state, metrics


def test_ranks_split_the_batch_and_shard(two_ranks):
  ranks, _, single, _ = two_ranks
  full_params = sum(p.numel() for p in single.generator.parameters())
  full_moments = 2 * sum(p.numel() for m in (single.generator,
                                             single.discriminator)
                         for p in m.parameters())
  for rank, result in enumerate(ranks):
    assert result['world'] == (WORLD, rank)
    assert result['local_examples'] == 4  # 2 of each chunk of 4
    assert result['sharded_axes'] > 0
    # Nearly every tensor's channels divide by 2: about half of the EMA
    # and of the moments live on each rank.
    assert result['ema_numel'] < 0.55 * full_params
    assert result['moment_numel'] < 0.55 * full_moments
    assert result['refused_gloo_on_card']


def test_two_rank_metrics_equal_one_rank(two_ranks):
  ranks, _, _, metrics = two_ranks
  for result in ranks:
    assert result['metrics'].keys() == metrics.keys()
    for key, want in metrics.items():
      np.testing.assert_allclose(result['metrics'][key], float(want),
                                 rtol=METRIC_RTOL, atol=1e-7, err_msg=key)


def test_two_rank_checkpoint_restores_at_world_one(two_ranks, tmp_path):
  """The consolidated bundle loads into a world-1 state, which equals the
  world-1 step's state (BatchNorm statistics, u, parameters, both Adam
  moments, G, D and the EMA) within the tolerances."""
  _, model_dir, single, _ = two_ranks
  manager = ckpt_t.CheckpointManager(model_dir)
  assert manager.all_steps() == [1]
  restored = _float64_state(_trainer(str(tmp_path)))
  assert manager.restore(restored) is restored and restored.step == 1
  bundle = torch.load(os.path.join(model_dir, '1', ckpt_t.STATE_FILE),
                      weights_only=True)
  assert ckpt_t.bundles_equal(
      {k: v.keys() if isinstance(v, dict) else v for k, v in bundle.items()},
      {k: v.keys() if isinstance(v, dict) else v
       for k, v in ckpt_t.state_bundle(single).items()})
  diffs = state_t.state_differences(restored, single)
  for key, value in diffs.items():
    if key not in ('compared', 'excluded'):
      assert value <= TOLERANCES[key.split('_', 1)[-1]], (key, value)
  assert diffs['excluded'] < diffs['compared']


def test_two_rank_checkpoint_serves(two_ranks):
  _, model_dir, _, _ = two_ranks
  model = inference_t.SE3DSModel(
      dataclasses.replace(SERVE, ckpt_path=model_dir), device='cpu')
  want = ckpt_t.restore_ema_generator(model_dir, model.model)
  for key, value in model.model.state_dict().items():  # float64 -> 32
    assert torch.equal(value, want[key].to(value.dtype)), key


def test_world_one_without_world_size(monkeypatch):
  monkeypatch.delenv('WORLD_SIZE', raising=False)
  assert mesh.init_from_env(torch.device('cpu')) == torch.device('cpu')
  assert not dist.is_initialized()
  assert mesh.DataParallel.current() == mesh.DataParallel(1, 0)


def test_a_loaded_state_steps_on_its_own(tmp_path):
  """A bundle of one live state loaded into another (as at a restore)
  shares no tensor with it: both then take the same step, Adam's step
  counts included (torch's Adam keeps a loaded step tensor as given)."""
  trainer = _trainer(str(tmp_path))
  states = [trainer.create_state() for _ in range(2)]
  ckpt_t.load_bundle(states[1], ckpt_t.state_bundle(states[0]))
  batch = trainer.device_batch(_global_batch())
  for state in states:
    state_t.train_step(state, batch, trainer.hp)
  for state in states:
    assert {float(s['step']) for s in state.d_opt.state.values()} == {2.0}
  assert ckpt_t.bundles_equal(*(ckpt_t.state_bundle(s) for s in states))


def test_local_batch_spreads_every_chunk():
  batch = {'x': np.arange(8)[:, None]}
  shares = [mesh.DataParallel(2, r).local_batch(batch, 2)['x'][:, 0]
            for r in range(2)]
  assert shares[0].tolist() == [0, 1, 4, 5]
  assert shares[1].tolist() == [2, 3, 6, 7]
  with pytest.raises(RuntimeError):  # world 2 without a group
    mesh.DataParallel(2, 0).average([torch.ones(2)])


# -- ZeRO-1 against the JAX package ------------------------------------------


def _axis_markers(tree, num_data, mesh_j):
  """Each Flax leaf replaced by a marker that varies along the axis JAX
  shards (arange along it), or zeros where JAX replicates."""
  import jax
  from se3ds_tpu.parallel import mesh as mesh_j_lib

  def marker(leaf):
    spec = mesh_j_lib.shard_leaf_zero1(mesh_j, leaf).spec
    shape = np.shape(leaf)
    out = np.zeros(shape, np.float32)
    if 'data' in spec:
      axis = list(spec).index('data')
      view = [1] * len(shape)
      view[axis] = shape[axis]
      out = out + np.arange(shape[axis], dtype=np.float32).reshape(view)
    return out
  return jax.tree_util.tree_map(marker, tree)


def _varying_axis(tensor):
  for axis in range(tensor.dim()):
    if tensor.shape[axis] > 1 and not torch.equal(
        tensor, tensor.narrow(axis, 0, 1).expand_as(tensor)):
      return axis
  return None


@pytest.mark.parametrize('num_data', [2, 4, 8])
def test_zero1_axes_match_jax(num_data):
  """On every parameter of the tiny G and D (the optimizer moments and
  the EMA are shaped like them): the JAX axis, carried into the port's
  layout by the folding bridge, is the port's axis."""
  import jax
  from se3ds_tpu.models import discriminator as disc_j
  from se3ds_tpu.models import generator as gen_j
  from se3ds_tpu.parallel import mesh as mesh_j_lib
  from test_torch_train_layers import _random_variables
  mesh_j = mesh_j_lib.create_mesh(num_data=num_data, num_spatial=1,
                                  devices=jax.devices()[:num_data])
  h, w = 32, 64
  cond = {'proj_image': np.zeros((1, h, w, 3), np.float32),
          'proj_depth': np.zeros((1, h, w, 1), np.float32),
          'proj_mask': np.ones((1, h, w, 1), np.float32),
          'blurred_mask': np.zeros((1, h, w, 1), np.float32)}
  cases = [
      (gen_j.ResNetGenerator(image_size=h, gen_dims=2, z_dim=2,
                             resnet_version='tiny'), cond,
       gen_t.ResNetGenerator(spectral_fold=False, gen_dims=2, z_dim=2,
                             resnet_version='tiny')),
      (disc_j.SNMultiScaleDiscriminator(**D_CONFIG),
       np.zeros((2, h, w, 4), np.float32),
       disc_t.SNMultiScaleDiscriminator(**D_CONFIG))]
  for model_j, example, model_t in cases:
    params = _random_variables(model_j, 0, example)['params']
    markers = folding.torch_tensors_from_flax(
        _axis_markers(params, num_data, mesh_j))
    axes = mesh.param_axes(model_t, num_data)
    assert axes.keys() == markers.keys()
    for name, axis in axes.items():
      assert axis == _varying_axis(markers[name]), name
    assert any(a is not None for a in axes.values())


def _meta_state(world, rank):
  """The lowres recipe's state (G gen_dims 128 ResNet-101, D dis_dims 128
  n_dis 2 n_layers 6) on the meta device, as rank `rank` of `world`
  holds it."""
  with torch.device('meta'):
    generator = gen_t.ResNetGenerator(gen_dims=128, resnet_version='101',
                                      spectral_fold=False)
    discriminator = disc_t.SNMultiScaleDiscriminator(dis_dims=128, n_dis=2,
                                                     n_layers=6)
  return state_t.create_train_state(generator, discriminator, 1e-4, 4e-4,
                                    0.5, 0.999,
                                    mesh.DataParallel(world, rank))


def _resident_bytes(state):
  tensors = [*state.generator.state_dict().values(),
             *state.discriminator.state_dict().values(),
             *state.ema.state_dict().values(),
             *(t for opt in (state.g_opt, state.d_opt)
               for s in opt.state.values() for t in s.values())]
  return sum(t.numel() * t.element_size() for t in tensors)


def test_zero1_bytes_at_8_ranks_match_jax_accounting():
  """Per-rank resident bytes of the full lowres state at 8 ranks: within
  0.5% of the JAX package's per-chip bytes through train_state_shardings
  (tests/test_memory_budget.py). The port's state holds the same tensors
  (G and D replicated, the EMA's parameters and both Adam chains sharded
  by the same rule, BatchNorm statistics and u replicated); what differs
  is small: Adam's step count is one scalar per tensor here and one per
  chain in optax."""
  import jax
  from se3ds_tpu.parallel import mesh as mesh_j_lib
  from test_memory_budget import _abstract_production_state
  abstract = _abstract_production_state()
  mesh_j = mesh_j_lib.create_mesh(num_data=8, num_spatial=1,
                                  devices=jax.devices()[:8])
  shardings = mesh_j_lib.train_state_shardings(abstract, mesh_j,
                                               shard_opt_state=True)
  jax_bytes = 0
  for leaf, sharding in zip(
      jax.tree_util.tree_leaves(abstract),
      jax.tree_util.tree_leaves(
          shardings, is_leaf=lambda x: hasattr(x, 'shard_shape'))):
    jax_bytes += (int(np.prod(sharding.shard_shape(tuple(leaf.shape))))
                  * leaf.dtype.itemsize)
  port = _resident_bytes(_meta_state(8, 0))
  whole = _resident_bytes(_meta_state(1, 0))
  assert abs(port - jax_bytes) <= 0.005 * jax_bytes, (port, jax_bytes)
  assert port < 0.5 * whole, (port, whole)
