"""`SE3DSModel(mesh=...)` and `Trainer.test` across 4 gloo ranks, on the
CPU (tests/test_inference.py:524-620 hold the JAX package's mesh model
so).

One spawned group of 4 ranks (a `file://` rendezvous; the ranks import
torch and the port only) serves on three meshes over it: (4 data x 1
spatial): the splat's points spread over 4 ranks; (2 x 2): 2 ranks split
the points and 2 the generator's rows; (1 x 4): the rows over 4 ranks,
where the deepest maps of the 32-row test pano (1 row at 1/32) hold
fewer rows than ranks. The test process runs the meshless model on the
same seeded weights and inputs; JAX's bounds hold between them: the
guidance equal (proj_depth within 1e-6), pred_depth within 1e-4 without
and 2e-3 with the rows spread, pred_rgb within one level. On (2 x 2)
the feedback paths go through the mesh too: ring memory across a wrap
(`predict_trajectory`) and `predict_poses`. The mode renames ('pallas' ->
'fast', 'pallas_exact' -> 'scatter') and the "no sharded path" error
are JAX's.

The same group runs `Trainer.test` at world 4 as the CLI's TEST job
runs it: every rank polls a model_dir holding one checkpoint (step 2 of
a world-1 trainer's seeded state, TRAIN_DONE), restores it into its
ZeRO-1 shards and rolls out its share of each eval batch of 3 (rank 0
rolls out no row, the others one each). Against world 1 on a copy of
the directory: the event file's scores, FID rtol 1e-4
(tests/test_torch_fid_score.py's), IS and RMSE rtol 1e-5; one event
file and one CSV row, which only rank 0 writes. Inception is a small
stand-in registered for `inception_model` (3 pooled features, so the
Frechet distance of 6 samples is well posed and takes no 2048-d matrix
root): the test holds the data-parallel bookkeeping, and the network is
tests/test_torch_eval.py's.
"""

import csv
import dataclasses
import glob
import os
import struct
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp
import torch.nn.functional as F
from torch import nn

from se3ds_torch import config as config_t
from se3ds_torch import tracing as tracing_t
from se3ds_torch.data import example_pb as example_pb_t
from se3ds_torch.data import synthetic as synthetic_t
from se3ds_torch.data import tfrecord as tfrecord_t
from se3ds_torch.eval import inception as inception_t
from se3ds_torch.models import inference as inference_t
from se3ds_torch.models import model_config as config_m
from se3ds_torch.parallel import mesh as mesh_t
from se3ds_torch.train import checkpoints as ckpt_t
from se3ds_torch.train import trainer as trainer_t  # noqa: F401 (GAN)
from se3ds_torch.utils import task_manager as task_manager_t
from test_torch_serving import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures('one_torch_thread')

WORLD = 4
MESHES = ((4, 1), (2, 2), (1, 4))
TIMEOUT_S = 300
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = os.path.join(REPO, 'configs', 'tiny_test.gin')
VIDEOS, TEST_BATCH = 6, 3
FID_RTOL, SCORE_RTOL = 1e-4, 1e-5
GUIDANCE = ('proj_rgb', 'proj_semantic', 'proj_mask')


class StandInInception(nn.Module):
  """(pool, predictions) of images (N, 299, 299, 3): the channel means
  and a softmax of a fixed map of them."""

  def __init__(self):
    super().__init__()
    self.register_buffer('weights', torch.tensor(
        [[1.0, -2.0, 0.5, 3.0], [0.5, 1.0, -1.0, 2.0],
         [-1.5, 0.5, 2.0, 1.0]]))

  def forward(self, images):
    pool = images.mean(dim=(1, 2))
    return pool, F.softmax(4.0 * pool @ self.weights, dim=-1)


def stand_in_inception(version='V3', path=None):
  del version, path
  return StandInInception()


def _pano(seed):
  h = config_m.get_test_config().image_height
  rs = np.random.RandomState(seed)
  rgb = rs.randint(0, 256, (1, h, 2 * h, 3)).astype(np.int32)
  sem = rs.randint(1, 42, (1, h, 2 * h, 1)).astype(np.int32)
  depth = rs.uniform(0.05, 0.6, (1, h, 2 * h)).astype(np.float32)
  return rgb, sem, depth


TARGET = np.asarray([[0.3, -0.1, 0.05]], np.float32)
TRAJECTORY = np.asarray([[0.1, 0.0, 0.0], [0.2, 0.1, 0.0], [0.3, 0.1, 0.05]],
                        np.float32)
POSES = np.asarray([[0.2, 0.1, -0.05], [-0.1, 0.3, 0.0]], np.float32)


def _serve(mesh, mode, feedback):
  """One call (the JAX test's), and with `feedback` ring memory across a
  wrap (memory_frames 2, 3 trajectory frames) and predict_poses."""
  config = dataclasses.replace(config_m.get_test_config(), splat_mode=mode,
                               memory_frames=2 if feedback else 3,
                               memory_mode='ring' if feedback else 'strict')
  model = inference_t.SE3DSModel(config, device='cpu', mesh=mesh)
  model.add_to_memory(*_pano(11), np.zeros((1, 3), np.float32))
  outs = {'mode': model.config.splat_mode, 'convs': {}}

  def run(key, call, *args):
    """outs[key] = call(*args), and the convolutions it ran."""
    before = tracing_t.count('generator.convs')
    outs[key] = call(*args)
    outs['convs'][key] = tracing_t.count('generator.convs') - before

  run('call', model, TARGET)
  if feedback:
    run('trajectory', model.predict_trajectory, TRAJECTORY)
    run('poses', model.predict_poses, POSES)
  return outs


SERVED = [((4, 1), 'fast', False), ((4, 1), 'scatter', False),
          ((4, 1), 'fast_exact', False), ((4, 1), 'pallas', False),
          ((4, 1), 'pallas_exact', False), ((2, 2), 'fast', True),
          ((1, 4), 'fast', False)]


def _bindings(data_dir):
  return [f"R2RVideoDataset.data_dir = '{data_dir}/'",
          f'GAN.test_batch_size = {TEST_BATCH}', f'GAN.eval_size = {VIDEOS}']


def _trainer(model_dir, data_dir):
  config_t.clear_config()
  config_t.parse_config_files_and_bindings([TINY], _bindings(data_dir))
  return config_t.apply_config('GAN', model_dir=model_dir, device='cpu')


def _run_test(model_dir, data_dir):
  """Trainer.test on tiny_test.gin with the stand-in Inception (the
  registration restored after)."""
  config_t.register('inception_model', stand_in_inception)
  try:
    _trainer(model_dir, data_dir).test()
  finally:
    config_t.register('inception_model', inception_t.inception_model)
    config_t.clear_config()


def _worker(rank, root):
  torch.set_num_threads(1)
  dist.init_process_group('gloo', init_method=f'file://{root}/rendezvous',
                          world_size=WORLD, rank=rank)
  try:
    meshes = {shape: mesh_t.create_mesh(*shape, device='cpu')
              for shape in MESHES}
    served = [_serve(meshes[shape], mode, feedback)
              for shape, mode, feedback in SERVED]
    try:
      inference_t.SE3DSModel(dataclasses.replace(
          config_m.get_test_config(), splat_mode='sorted'), device='cpu',
                             mesh=meshes[(4, 1)])
      refused = None
    except ValueError as e:
      refused = str(e)
    _run_test(os.path.join(root, 'model'), os.path.join(root, 'data'))
    torch.save({'served': served, 'refused': refused},
               os.path.join(root, f'rank{rank}.pt'))
  finally:
    dist.destroy_process_group()


@pytest.fixture(scope='module')
def ranks(tmp_path_factory):
  root = str(tmp_path_factory.mktemp('mesh_serving'))
  os.makedirs(os.path.join(root, 'data'))
  synthetic_t.write_video_fixture(
      os.path.join(root, 'data', 'val_seen-0.tfrecord'),
      num_examples=VIDEOS, height=64)
  for name in ('model', 'single'):  # world 4's directory, world 1's
    model_dir = os.path.join(root, name)
    trainer = _trainer(model_dir, os.path.join(root, 'data'))
    ckpt_t.CheckpointManager(model_dir).save(2, trainer.create_state())
    task_manager_t.TaskManager(model_dir).mark_training_done()
  config_t.clear_config()
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
  return root, [torch.load(os.path.join(root, f'rank{r}.pt'),
                           weights_only=False) for r in range(WORLD)]


def _assert_within_bounds(got, want, spatial, what):
  for field in GUIDANCE:
    np.testing.assert_array_equal(getattr(got, field).numpy(),
                                  getattr(want, field).numpy(),
                                  err_msg=f'{what} {field}')
  np.testing.assert_allclose(got.proj_depth.numpy(), want.proj_depth.numpy(),
                             rtol=0, atol=1e-6, err_msg=f'{what} proj_depth')
  np.testing.assert_allclose(got.pred_depth.numpy(), want.pred_depth.numpy(),
                             rtol=0, atol=2e-3 if spatial else 1e-4,
                             err_msg=f'{what} pred_depth')
  rgb_off = np.abs(got.pred_rgb.numpy().astype(np.int32)
                   - want.pred_rgb.numpy().astype(np.int32))
  assert rgb_off.max() <= 1, what
  assert got.mu.shape == want.mu.shape, what


@pytest.mark.parametrize('index', range(len(SERVED)))
def test_mesh_model_matches_the_meshless_model(ranks, index):
  shape, mode, feedback = SERVED[index]
  want = _serve(None, {'pallas': 'fast', 'pallas_exact': 'scatter'}.get(
      mode, mode), feedback)
  for rank, result in enumerate(ranks[1]):
    got = result['served'][index]
    what = f'{shape} {mode} rank {rank}'
    for key in ('call',) + (('trajectory', 'poses') if feedback else ()):
      _assert_within_bounds(got[key], want[key], shape[1] > 1,
                            f'{what} {key}')
    # Every rank runs the generator's own layers, whole or on its rows.
    assert got['convs'] == want['convs'], what
  assert min(want['convs'].values()) > 0


def test_mesh_renames_the_kernel_modes(ranks):
  for result in ranks[1]:
    modes = [served['mode'] for served in result['served']]
    assert modes[3] == 'fast' and modes[4] == 'scatter'
    assert 'no sharded path' in result['refused']


def _event_scalars(model_dir):
  """{tag: value} of the scalar summaries in the event files (the
  reader of tests/test_torch_cli.py)."""
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


def test_trainer_test_at_world_4_equals_world_1(ranks):
  root, _ = ranks
  _run_test(os.path.join(root, 'single'), os.path.join(root, 'data'))
  want = _event_scalars(os.path.join(root, 'single'))
  got = _event_scalars(os.path.join(root, 'model'))
  scores = [k for k in want if 'eval_image' in k]
  assert len(scores) == 6 and got.keys() == want.keys()
  for key in scores:
    rtol = FID_RTOL if 'fid' in key else SCORE_RTOL
    np.testing.assert_allclose(got[key], want[key], rtol=rtol, err_msg=key)
  model_dir = os.path.join(root, 'model')
  assert len(glob.glob(os.path.join(model_dir, 'events.out.tfevents.*'))) == 1
  with open(os.path.join(model_dir, 'scores_val_seen.csv')) as f:
    assert len(list(csv.DictReader(f))) == 1
  # The PNG dumps, under the restored state's own step (0: the seeded
  # state was saved as checkpoint 2).
  assert os.path.isdir(os.path.join(model_dir, 'images', 'val_seen', '0'))
