"""Port parity: every splat mode of the JAX package.

'fast_exact', 'sorted', 'sorted_packed', the dual splat and the
reference's pixel-0 pollution are plain PyTorch in the port
(`se3ds_torch.ops.splat`); each must be BIT-equal to its JAX function on
the same view coordinates (numpy, so both packages see the same floats):
they are per-pixel minima and maxima and a sort whose ties do not change
the result. Clouds: random ones with every edge of the pixel rule, and
collision-heavy ones (~16 points per pixel inside one 0.1 m window), with
byte and non-byte, scalar, 3- and 5-channel features. Tolerance: none.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from se3ds_torch import constants
from se3ds_torch.models import inference as inference_t
from se3ds_torch.models import model_config as config_t
from se3ds_torch.ops import geometry as geometry_t
from se3ds_torch.ops import splat as t_splat
from se3ds_tpu.ops import splat as j_splat
from test_torch_serving import one_torch_thread  # noqa: F401
from test_torch_splat import _cloud

pytestmark = pytest.mark.usefixtures('one_torch_thread')

H, W = 8, 16
DEPTH_SCALE = 20.0
BATCH, POINTS = 2, 2048
MODES = {
    'fast_exact': (t_splat.project_to_feat_fast_exact,
                   j_splat.project_to_feat_fast_exact),
    'sorted': (t_splat.project_to_feat_sorted, j_splat.project_to_feat_sorted),
    'sorted_packed': (t_splat.project_to_feat_sorted_packed,
                      j_splat.project_to_feat_sorted_packed),
    'fast': (t_splat.project_to_feat_fast, j_splat.project_to_feat_fast),
}


def _collisions(seed, channels, void):
  """~16 points per pixel, depths inside [2.0, 2.25): most windows hold
  several points; 10% void points, some behind the camera."""
  rs = np.random.RandomState(seed)
  z = rs.uniform(2.0, 2.25, (BATCH, POINTS)).astype(np.float32)
  z[rs.rand(BATCH, POINTS) < 0.05] = -1.0
  x = (rs.uniform(-1.0, 1.0, (BATCH, POINTS)) * z).astype(np.float32)
  y = (rs.uniform(-1.0, 1.0, (BATCH, POINTS)) * z).astype(np.float32)
  coords = np.stack([x, y, z, np.ones_like(z)], axis=1)
  feats = rs.randint(0, 256, (BATCH, POINTS, channels)).astype(np.float32)
  feats[rs.rand(BATCH, POINTS) < 0.1] = void
  return coords, feats


def _inputs(kind, seed, channels, void):
  """(coords, feats) of a cloud `kind`: 'random', 'collisions', or
  'non_byte' (collisions with features in [-20, 300) and fractions)."""
  if kind == 'random':
    return _cloud(seed, BATCH, POINTS, channels, void)
  coords, feats = _collisions(seed, channels, void)
  if kind == 'non_byte':
    rs = np.random.RandomState(seed + 100)
    feats = np.where(feats == void, feats, rs.uniform(
        -20.0, 300.0, feats.shape).astype(np.float32))
  return coords, feats


def _both(mode, coords, feats, void, out_void=0.0):
  port_fn, jax_fn = MODES[mode]
  port = port_fn(torch.from_numpy(coords), torch.from_numpy(feats), H, W,
                 depth_scale=DEPTH_SCALE, input_void_class=void,
                 output_void_class=out_void)
  ref = jax_fn(jnp.asarray(coords), jnp.asarray(feats), H, W,
               depth_scale=DEPTH_SCALE, input_void_class=void,
               output_void_class=out_void)
  return port, ref


def _assert_equal(port, ref):
  for p, r in zip(port, ref):
    np.testing.assert_array_equal(p.numpy(), np.asarray(r))


# (kind, seed, channels, void, scalar features)
CLOUDS = [('random', 0, 3, -1.0, False), ('collisions', 1, 3, -1.0, False),
          ('collisions', 2, 1, 0.0, True), ('non_byte', 3, 3, -1.0, False),
          ('non_byte', 4, 1, 0.0, True)]


@pytest.mark.parametrize('mode', ['fast_exact', 'sorted', 'sorted_packed'])
@pytest.mark.parametrize('kind,seed,channels,void,scalar', CLOUDS)
def test_mode_bit_equal_to_jax(mode, kind, seed, channels, void, scalar):
  """Non-byte features: 'sorted' keeps the floats, the packed modes clip
  and truncate them (validity tests the original values) as JAX does."""
  coords, feats = _inputs(kind, seed, channels, void)
  if scalar:
    feats = feats[..., 0]
  _assert_equal(*_both(mode, coords, feats, void, out_void=-1.0))


@pytest.mark.parametrize('mode', ['sorted', 'sorted_packed'])
def test_sorted_modes_equal_the_exact_splat(mode):
  """'sorted' on any floats and 'sorted_packed' on bytes are the exact
  splat: port against port, on collision-heavy clouds."""
  coords, feats = _inputs('non_byte' if mode == 'sorted' else 'collisions',
                          5, 3, -1.0)
  args = (torch.from_numpy(coords), torch.from_numpy(feats), H, W,
          DEPTH_SCALE, -1.0)
  _assert_equal(MODES[mode][0](*args), t_splat.project_to_feat(*args))


@pytest.mark.parametrize('mode', ['fast', 'fast_exact', 'sorted_packed'])
def test_five_channels_take_the_exact_splat(mode):
  """Five feature channels do not pack into a u32: each packed mode
  returns the exact splat, as in JAX (the 'fast' repair)."""
  coords, feats = _inputs('collisions', 6, 5, -1.0)
  port, ref = _both(mode, coords, feats, -1.0)
  _assert_equal(port, ref)
  exact = t_splat.project_to_feat(torch.from_numpy(coords),
                                  torch.from_numpy(feats), H, W, DEPTH_SCALE,
                                  -1.0)
  _assert_equal(port, exact)
  # The same through the geometry dispatch's plain path.
  xyz = torch.from_numpy(coords)
  out = geometry_t.project_memory_equirect_plain(
      torch.from_numpy(feats), xyz, torch.zeros((1, 4)), H, W, -1.0,
      DEPTH_SCALE, splat_mode=mode)
  want = t_splat.project_to_feat(geometry_t.equirect_view_coords(xyz),
                                 torch.from_numpy(feats), H, W, DEPTH_SCALE,
                                 -1.0)
  _assert_equal(out, want)


def test_sorted_packed_debug_trap(monkeypatch):
  """SE3DS_DEBUG_SPLAT=1 raises on non-byte features of valid points
  only (void points are exempt), as the JAX trap does."""
  coords, feats = _inputs('collisions', 7, 3, -1.0)
  args = lambda f: (torch.from_numpy(coords), torch.from_numpy(f), H, W,
                    DEPTH_SCALE, -1.0)
  monkeypatch.setenv('SE3DS_DEBUG_SPLAT', '1')
  t_splat.project_to_feat_sorted_packed(*args(feats))  # bytes, void -1
  bad = feats.copy()
  bad[0, np.argmax(feats[0, :, 0] >= 0), 0] = 3.5
  with pytest.raises(ValueError, match='sorted_packed'):
    t_splat.project_to_feat_sorted_packed(*args(bad))


def test_sort_ignores_depth_of_invalid_points():
  """Invalid points carry the sentinel pixel id: NaN, negative and
  infinite depths on them change nothing."""
  coords, feats = _inputs('collisions', 8, 3, -1.0)
  base = t_splat.project_to_feat_sorted_packed(
      torch.from_numpy(coords), torch.from_numpy(feats), H, W, DEPTH_SCALE,
      -1.0)
  invalid = np.all(feats == -1.0, axis=-1)
  noisy = coords.copy()
  fill = np.array([np.nan, -5.0, np.inf, -np.inf], np.float32)
  noisy[:, 2][invalid] = np.resize(fill, invalid.sum())
  _assert_equal(t_splat.project_to_feat_sorted_packed(
      torch.from_numpy(noisy), torch.from_numpy(feats), H, W, DEPTH_SCALE,
      -1.0), base)


def _dual_clouds(seed):
  sem, sem_feats = _collisions(seed, 1, float(constants.INVALID_SEM_VALUE))
  rgb, rgb_feats = _collisions(seed + 1, 3,
                               float(constants.INVALID_RGB_VALUE))
  return sem, sem_feats, rgb, rgb_feats


def test_dual_sorted_bit_equal_to_jax_and_the_exact_pair():
  sem, sem_feats, rgb, rgb_feats = _dual_clouds(9)
  kw = dict(depth_scale=DEPTH_SCALE,
            sem_void_class=float(constants.INVALID_SEM_VALUE),
            rgb_void_class=float(constants.INVALID_RGB_VALUE))
  port = t_splat.project_dual_sorted_packed(
      torch.from_numpy(sem), torch.from_numpy(sem_feats),
      torch.from_numpy(rgb), torch.from_numpy(rgb_feats), H, W, **kw)
  ref = j_splat.project_dual_sorted_packed(
      jnp.asarray(sem), jnp.asarray(sem_feats), jnp.asarray(rgb),
      jnp.asarray(rgb_feats), H, W, **kw)
  _assert_equal(port, ref)
  _, sem_img = t_splat.project_to_feat(
      torch.from_numpy(sem), torch.from_numpy(sem_feats), H, W, DEPTH_SCALE,
      kw['sem_void_class'])
  depth, rgb_img = t_splat.project_to_feat(
      torch.from_numpy(rgb), torch.from_numpy(rgb_feats), H, W, DEPTH_SCALE,
      kw['rgb_void_class'])
  _assert_equal(port, (depth, sem_img, rgb_img))


def _memory(seed):
  sem, sem_feats, rgb, rgb_feats = _dual_clouds(seed)
  # View coordinates stand in for world points here: memory_project
  # translates by the position and takes the equirect view.
  return inference_t.MemoryState(
      coords=torch.from_numpy(sem), feats=torch.from_numpy(sem_feats),
      rgb_coords=torch.from_numpy(rgb), rgb=torch.from_numpy(rgb_feats),
      cursor=0)


def test_memory_project_dual_sorted_matches_exact():
  """All four guidance outputs of 'dual_sorted' equal 'scatter''s."""
  memory = _memory(11)
  position = torch.tensor([[0.3, -0.2, 0.05], [0.0, 0.4, -0.1]])
  dual = inference_t.memory_project(memory, position, H, W, DEPTH_SCALE,
                                    splat_mode='dual_sorted')
  exact = inference_t.memory_project(memory, position, H, W, DEPTH_SCALE,
                                     splat_mode='scatter')
  _assert_equal(dual, exact)


def test_dual_sorted_rejects_its_contract_violations():
  memory = _memory(12)
  position = torch.zeros((1, 3))
  with pytest.raises(ValueError, match='project_semantics'):
    inference_t.memory_project(memory, position, H, W, DEPTH_SCALE,
                               splat_mode='dual_sorted',
                               project_semantics=False)
  with pytest.raises(ValueError, match='sharded'):
    inference_t.memory_project(memory, position, H, W, DEPTH_SCALE,
                               splat_mode='dual_sorted', mesh=object())
  with pytest.raises(ValueError, match='project_dual_to_equirectangular'):
    geometry_t.project_feats_to_equirectangular(
        memory.rgb, memory.rgb_coords, H, W, -1.0, DEPTH_SCALE,
        splat_mode='dual_sorted')


@pytest.mark.parametrize('scalar', [False, True])
def test_pollute_pixel0_bit_equal_to_jax(scalar):
  """The parity helper against JAX's, on a cloud with every class of
  index-0 contributor (tests/test_pollute_pixel0.py's); pixel (0, 0) of
  batch 0 changes and nothing else does."""
  rng = np.random.RandomState(0)
  n, m = 2, 300
  xyz1 = np.concatenate([rng.uniform(-6, 6, (n, 3, m)).astype(np.float32),
                         np.ones((n, 1, m), np.float32)], axis=1)
  feats = rng.randint(0, 256, (n, m, 3)).astype(np.float32)
  feats[:, ::7] = -1.0
  xyz1[:, 2, ::11] = -xyz1[:, 2, ::11]
  if scalar:
    feats = feats[..., 0]
  proj = geometry_t.equirect_view_coords(torch.from_numpy(xyz1))
  clean = t_splat.project_to_feat(proj, torch.from_numpy(feats), H, W,
                                  DEPTH_SCALE, -1.0)
  port = t_splat.reference_pollute_pixel0(
      *clean, proj, torch.from_numpy(feats), H, W, -1.0, DEPTH_SCALE)
  ref = j_splat.reference_pollute_pixel0(
      jnp.asarray(clean[0].numpy()), jnp.asarray(clean[1].numpy()),
      jnp.asarray(proj.numpy()), jnp.asarray(feats), H, W, -1.0, DEPTH_SCALE)
  _assert_equal(port, ref)
  for p, c in zip(port, clean):
    changed = (p != c).reshape(p.shape[0], -1, *p.shape[3:])
    assert not changed[1:].any() and not changed[0, 1:].any()


@pytest.mark.parametrize('mode', ['fast_exact', 'sorted_packed'])
def test_dispatch_runs_the_mode(mode):
  """`project_feats_to_equirectangular` (JAX's argument order, with the
  legacy `use_sorted_splat` 7th) runs the mode's function on the view
  coordinates; `use_sorted_splat=True` is 'sorted', the exact splat."""
  rs = np.random.RandomState(13)
  xyz = torch.from_numpy(rs.uniform(-3, 3, (BATCH, 4, POINTS)).astype(
      np.float32))
  feats = torch.from_numpy(rs.randint(0, 256, (BATCH, POINTS, 3)).astype(
      np.float32))
  view = geometry_t.equirect_view_coords(xyz)
  _assert_equal(
      geometry_t.project_feats_to_equirectangular(
          feats, xyz, H, W, -1.0, DEPTH_SCALE, False, mode),
      MODES[mode][0](view, feats, H, W, DEPTH_SCALE, -1.0))
  _assert_equal(
      geometry_t.project_feats_to_equirectangular(
          feats, xyz, H, W, -1.0, DEPTH_SCALE, True),
      t_splat.project_to_feat(view, feats, H, W, DEPTH_SCALE, -1.0))


def test_model_serves_every_mode():
  """SE3DSModel on the CPU accepts every JAX splat mode; the exact ones
  give 'scatter''s guidance, 'fast_exact' its depth."""
  base = config_t.get_test_config()
  rs = np.random.RandomState(14)
  h = base.image_height
  rgb = rs.randint(0, 256, (1, h, 2 * h, 3)).astype(np.int32)
  sem = rs.randint(1, 42, (1, h, 2 * h, 1)).astype(np.int32)
  depth = rs.uniform(0.05, 0.6, (1, h, 2 * h)).astype(np.float32)
  guidance = {}
  for mode in geometry_t.SPLAT_MODES:
    model = inference_t.SE3DSModel(
        dataclasses.replace(base, splat_mode=mode), device='cpu')
    model.add_to_memory(rgb, sem, depth, np.zeros((1, 3), np.float32))
    out = model(np.array([[0.2, -0.1, 0.05]], np.float32))
    guidance[mode] = (out.proj_depth, out.proj_rgb, out.proj_semantic,
                      out.proj_mask)
  for mode in ('sorted', 'pallas_exact', 'sorted_packed', 'dual_sorted'):
    _assert_equal(guidance[mode], guidance['scatter'])
  for mode in ('pallas',):
    _assert_equal(guidance[mode], guidance['fast'])
  np.testing.assert_array_equal(guidance['fast_exact'][0].numpy(),
                                guidance['scatter'][0].numpy())
