"""The memory splat with its points spread over 4 gloo ranks
(`se3ds_torch.parallel.splat_shard`), on the CPU.

Four spawned ranks (a `file://` rendezvous; they import torch and the
port only) each splat their share of the same clouds, for 'fast',
'fast_exact' and 'scatter', and return the combined images; the test
process holds every rank's images BIT-equal to the unsharded port splat
and to the JAX package's single-device mode on the same view
coordinates (tests/test_splat_shard.py holds JAX's sharded splat so).
Minimum and maximum are associative and commutative, so no tolerance.
Clouds of 2047 points (not divisible by 4): random points, and a shell
of ~16 points per pixel inside one 0.1 m window; 3 channels, scalar
features, 5 channels (the packed modes then run 'scatter'), the semantic
splat without its depth, and a stride-0 `expand` of one memory. The
kernels' u32 words combine by their unsigned minimum: a test holds
`splat_cuda.all_reduce_unsigned_min` to it on words that a signed
minimum gets wrong.
"""

import os
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from se3ds_torch.ops import geometry as geometry_t
from se3ds_torch.ops import splat as t_splat
from se3ds_torch.ops import splat_cuda
from se3ds_torch.parallel import mesh as mesh_t
from se3ds_torch.parallel import splat_shard
from test_torch_serving import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures('one_torch_thread')

WORLD = 4
H, W = 16, 32
DEPTH_SCALE = 20.0
POINTS = 2047
TIMEOUT_S = 240
# (mode, cloud, channels (0: scalar), need_depth, expand to a batch of 2)
CASES = [
    ('fast', 'random', 3, True, False),
    ('fast', 'shell', 3, True, False),
    ('fast', 'shell', 0, False, False),
    ('fast', 'shell', 5, True, False),
    ('fast', 'shell', 3, True, True),
    ('fast_exact', 'random', 3, True, False),
    ('fast_exact', 'shell', 3, True, False),
    ('fast_exact', 'shell', 0, True, False),
    ('fast_exact', 'shell', 5, True, False),
    ('scatter', 'random', 3, True, False),
    ('scatter', 'shell', 3, True, False),
    ('scatter', 'shell', 0, False, False),
    ('scatter', 'shell', 1, True, True),
]
# Words as the kernels hold them: 0xFFFFFFFF (-1) is "no point", and
# depth bits and complemented keys with the top bit set are common.
WORDS = np.array([[-1, 0x3F800000, -0x20000000, 7, -1],
                  [0x40000000, -1, 0x7FFFFFFF, -5, -1],
                  [-1, -1, -1, 3, -1],
                  [0x10, 0x3F800001, -0x30000000, -1, -1]], np.int64)


def _clouds(cloud, channels, seed):
  """World points (2, 4, POINTS), features and a camera offset (2, 4)."""
  rs = np.random.RandomState(seed)
  if cloud == 'random':
    xyz = rs.uniform(-6, 6, (2, 3, POINTS))
  else:  # a shell 2.0-2.05 m from the camera: collisions everywhere
    direction = rs.normal(size=(2, 3, POINTS))
    direction /= np.linalg.norm(direction, axis=1, keepdims=True)
    xyz = direction * rs.uniform(2.0, 2.05, (2, 1, POINTS))
  xyz = np.concatenate([xyz, np.ones((2, 1, POINTS))], axis=1).astype(
      np.float32)
  offset = np.concatenate([rs.uniform(-0.2, 0.2, (2, 3)),
                           np.zeros((2, 1))], axis=1).astype(np.float32)
  feats = rs.randint(0, 256, (2, POINTS, max(channels, 1))).astype(
      np.float32)
  feats[rs.rand(2, POINTS) < 0.1] = -1.0
  if channels == 0:
    feats = feats[..., 0]
  return xyz, feats, offset


def _inputs(case, index):
  _, cloud, channels, _, expand = case
  xyz, feats, offset = (torch.from_numpy(a) for a in
                        _clouds(cloud, channels, index))
  if expand:  # one memory seen from two cameras, as predict_poses reads it
    xyz = xyz[:1].expand(2, -1, -1)
    feats = feats[:1].expand(2, *feats.shape[1:])
  return xyz, feats, offset


def _worker(rank, root):
  torch.set_num_threads(1)
  dist.init_process_group('gloo', init_method=f'file://{root}/rendezvous',
                          world_size=WORLD, rank=rank)
  try:
    mesh = mesh_t.create_mesh(device='cpu')
    group = mesh.get_group('data')
    results = []
    for index, case in enumerate(CASES):
      mode, _, _, need_depth, _ = case
      xyz, feats, offset = _inputs(case, index)
      results.append(splat_shard.project_memory_equirect_sharded(
          feats, xyz, offset, H, W, -1.0, DEPTH_SCALE, group=group,
          splat_mode=mode, need_depth=need_depth))
    # The JAX function's arguments: the points at a zero offset.
    xyz, feats, _ = _inputs(CASES[0], 0)
    zero_offset = splat_shard.project_feats_to_equirectangular_sharded(
        feats, xyz, H, W, -1.0, DEPTH_SCALE, mesh=mesh, splat_mode='fast')
    words = torch.from_numpy(WORDS[rank].astype(np.int32))
    unsigned = splat_cuda.all_reduce_unsigned_min(words.clone(), group)
    signed = words.clone()
    dist.all_reduce(signed, op=dist.ReduceOp.MIN, group=group)
    try:
      mesh_t.create_mesh(3, device='cpu')
      refused = False
    except ValueError:
      refused = True
    torch.save({'splats': results, 'zero_offset': zero_offset,
                'unsigned': unsigned, 'signed': signed,
                'shape': (tuple(mesh.shape), mesh.mesh_dim_names),
                'refused_3x1': refused},
               os.path.join(root, f'rank{rank}.pt'))
  finally:
    dist.destroy_process_group()


@pytest.fixture(scope='module')
def ranks(tmp_path_factory):
  root = str(tmp_path_factory.mktemp('splat_shard'))
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
  return [torch.load(os.path.join(root, f'rank{r}.pt')) for r in
          range(WORLD)]


def _assert_equal(got, want, what):
  for g, w in zip(got, want):
    if w is None:
      assert g is None, what
    else:
      np.testing.assert_array_equal(np.asarray(g), np.asarray(w),
                                    err_msg=what)


@pytest.mark.parametrize('index', range(len(CASES)))
def test_sharded_splat_bit_equal_to_unsharded_and_jax(ranks, index):
  import jax.numpy as jnp
  from se3ds_tpu.ops import splat as j_splat

  case = CASES[index]
  mode, _, channels, need_depth, _ = case
  xyz, feats, offset = _inputs(case, index)
  port = geometry_t.project_memory_equirect(
      feats, xyz, offset, H, W, -1.0, DEPTH_SCALE, splat_mode=mode,
      need_depth=need_depth)
  view = geometry_t.equirect_view_coords(xyz - offset[..., None])
  jax_fn = {'fast': j_splat.project_to_feat_fast,
            'fast_exact': j_splat.project_to_feat_fast_exact,
            'scatter': j_splat.project_to_feat}[mode]
  ref = jax_fn(jnp.asarray(view.numpy()), jnp.asarray(feats.numpy()), H, W,
               depth_scale=DEPTH_SCALE, input_void_class=-1.0)
  if not need_depth:
    ref = (None, ref[1])
  if channels == 5:  # the packed modes take the exact splat
    _assert_equal(port, t_splat.project_to_feat(
        view, feats, H, W, DEPTH_SCALE, -1.0), f'{case} exact')
  for rank, result in enumerate(ranks):
    got = result['splats'][index]
    _assert_equal(got, port, f'{case} rank {rank} vs unsharded port')
    _assert_equal(got, ref, f'{case} rank {rank} vs JAX')


def test_jax_signature_at_a_zero_offset(ranks):
  xyz, feats, _ = _inputs(CASES[0], 0)
  want = geometry_t.project_feats_to_equirectangular(
      feats, xyz, H, W, -1.0, DEPTH_SCALE, splat_mode='fast')
  for rank, result in enumerate(ranks):
    _assert_equal(result['zero_offset'], want, f'rank {rank}')


def test_words_combine_by_unsigned_minimum(ranks):
  """The combine of the kernels' words: elementwise unsigned minimum on
  every rank. The words are chosen so that a signed minimum differs."""
  unsigned = (WORDS & 0xFFFFFFFF).min(axis=0)
  want = np.where(unsigned >= 2**31, unsigned - 2**32, unsigned)
  signed = WORDS.min(axis=0)
  assert not np.array_equal(signed, want)
  for result in ranks:
    np.testing.assert_array_equal(result['unsigned'].numpy(), want)
    np.testing.assert_array_equal(result['signed'].numpy(), signed)


def test_mesh_shape(ranks):
  """create_mesh(device='cpu') over 4 gloo ranks is (4, 1) with JAX's dim
  names; a shape whose size is not the world size raises ValueError."""
  for result in ranks:
    assert result['shape'] == ((WORLD, 1), ('data', 'spatial'))
    assert result['refused_3x1']


def test_unsharded_modes_raise():
  with pytest.raises(ValueError, match='sharded'):
    splat_shard.project_memory_equirect_sharded(
        torch.zeros((1, 8, 3)), torch.zeros((1, 4, 8)), torch.zeros((1, 4)),
        H, W, -1.0, DEPTH_SCALE, splat_mode='sorted')


def test_point_shares_cover_the_points():
  for num_points in (0, 3, 2047, 2048):
    shares = [splat_shard.point_share(num_points, WORLD, r)
              for r in range(WORLD)]
    assert shares[0][0] == 0 and shares[-1][1] == num_points
    assert all(a[1] == b[0] for a, b in zip(shares, shares[1:]))
    assert max(b - a for a, b in shares) - min(b - a for a, b in shares) <= 1
