"""Port parity: the 'fast' z-buffer splat and its view geometry.

The port's `project_to_feat_fast` (on the CPU: the plain version of the
CUDA kernel) must be BIT-equal to the JAX `project_to_feat_fast` and to
the TPU kernel run in Pallas interpret mode: both are a per-pixel min and
max, which no summation order can change. Inputs are view coordinates
made with numpy, so both packages see the same floats.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from se3ds_torch import tracing
from se3ds_torch.ops import geometry as geometry_t
from se3ds_torch.ops import splat as t_splat
from se3ds_torch.ops import splat_cuda
from se3ds_tpu.ops import geometry as geometry_j
from se3ds_tpu.ops import splat as j_splat
from se3ds_tpu.ops import splat_pallas

H, W = 16, 32  # 512 pixels: a multiple of 128, so the Pallas kernel runs.
DEPTH_SCALE = 20.0


def _cloud(seed, batch, num_points, channels, void, keep=1.0):
  """View coordinates with every edge the pixel rule has; only a `keep`
  share of the points lies in front of the camera."""
  rs = np.random.RandomState(seed)
  z = rs.uniform(-1.0, 25.0, (batch, num_points)).astype(np.float32)
  z[rs.rand(batch, num_points) >= keep] = -1.0
  x = (rs.uniform(-1.3, 1.3, (batch, num_points)) * z).astype(np.float32)
  y = (rs.uniform(-1.3, 1.3, (batch, num_points)) * z).astype(np.float32)
  coords = np.stack([x, y, z, np.ones_like(z)], axis=1)
  if num_points >= 16:
    coords[:, 2, 0:2] = 0.0  # depth 0: divide-no-nan, invalid
    coords[:, 2, 2] = -3.0  # behind the camera
    coords[:, 0, 3] = 1e30  # far out of range
    coords[:, 0:2, 4] = -1e30
    coords[:, 0, 5] = coords[:, 2, 5]  # view x == 1: one past the edge
    coords[:, 0, 6] = -coords[:, 2, 6]  # view x == -1: pixel 0
    coords[:, 2, 7] = DEPTH_SCALE  # bucket edge
    coords[:, 2, 8] = 1e-30  # tiny positive depth
  feats = rs.randint(0, 256, (batch, num_points, channels)).astype(np.float32)
  hit = rs.rand(batch, num_points, channels) < 0.15
  feats[hit] = void  # void in some channels only, too
  return coords, feats


def _port(coords, feats, void):
  return t_splat.project_to_feat_fast(
      torch.from_numpy(coords), torch.from_numpy(feats), H, W,
      depth_scale=DEPTH_SCALE, input_void_class=void)


def _jax(fn, coords, feats, void, **kw):
  """The JAX function op by op, as its own tests call it.

  Not under jit: XLA then rewrites `x / depth_scale` as a multiply by
  the reciprocal, which moves the projected depth by an ULP.
  """
  return fn(jnp.asarray(coords), jnp.asarray(feats), H, W,
            depth_scale=DEPTH_SCALE, input_void_class=void, **kw)


# (seed, channels, void, scalar feats, share of points in front). One
# point count for all, so JAX compiles each op once per shape.
CASES = [
    (0, 3, -1.0, False, 1.0),  # RGB cloud, ~8 points per pixel
    (1, 1, 0.0, False, 1.0),  # semantic cloud
    (2, 1, 0.0, True, 1.0),  # scalar (N, M) features
    (3, 3, -1.0, False, 0.02),  # sparse: most pixels empty
]
BATCH, POINTS = 2, 2048


@pytest.mark.parametrize('seed,channels,void,scalar,keep', CASES)
def test_fast_splat_bit_equal_to_jax(seed, channels, void, scalar, keep):
  """Tolerance: none (array_equal); min/max are order-free."""
  coords, feats = _cloud(seed, BATCH, POINTS, channels, void, keep)
  if scalar:
    feats = feats[..., 0]
  pd, pf = _port(coords, feats, void)
  jd, jf = _jax(j_splat.project_to_feat_fast, coords, feats, void)
  np.testing.assert_array_equal(pd.numpy(), np.asarray(jd))
  np.testing.assert_array_equal(pf.numpy(), np.asarray(jf))


def test_fast_splat_empty_cloud():
  """M == 0: all-void image and depth 1, as in JAX; tolerance: none."""
  coords = np.zeros((1, 4, 0), np.float32)
  feats = np.zeros((1, 0, 3), np.float32)
  pd, pf = _port(coords, feats, -1.0)
  jd, jf = j_splat.project_to_feat_fast(
      jnp.asarray(coords), jnp.asarray(feats), H, W,
      depth_scale=DEPTH_SCALE, input_void_class=-1.0)
  np.testing.assert_array_equal(pd.numpy(), np.asarray(jd))
  np.testing.assert_array_equal(pf.numpy(), np.asarray(jf))
  np.testing.assert_array_equal(pd.numpy(), np.ones((1, H, W)))


@pytest.mark.parametrize('seed,channels,void,scalar,keep',
                         [CASES[0], CASES[2]])
def test_fast_splat_bit_equal_to_pallas_interpret(seed, channels, void,
                                                  scalar, keep):
  """The TPU kernel in interpret mode, as tests/test_geometry.py runs it.

  Tolerance: none (array_equal).
  """
  coords, feats = _cloud(seed, BATCH, POINTS, channels, void, keep)
  if scalar:
    feats = feats[..., 0]
  pd, pf = _port(coords, feats, void)
  jd, jf = _jax(splat_pallas.project_to_feat_pallas, coords, feats, void,
                interpret=True)
  np.testing.assert_array_equal(pd.numpy(), np.asarray(jd))
  np.testing.assert_array_equal(pf.numpy(), np.asarray(jf))


def test_pixel_coords_match_jax():
  """Flat index and validity per point; tolerance: none."""
  coords, feats = _cloud(5, BATCH, POINTS, 3, -1.0)
  flat, depth, valid = t_splat.pixel_coords(
      torch.from_numpy(coords), torch.from_numpy(feats), H, W, -1.0)
  jflat, jdepth, jvalid = j_splat.pixel_coords(
      jnp.asarray(coords), jnp.asarray(feats), H, W, -1.0)
  np.testing.assert_array_equal(flat.numpy(), np.asarray(jflat))
  np.testing.assert_array_equal(depth.numpy(), np.asarray(jdepth))
  np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))


def test_plain_buffers_decode_like_jax_packed_key():
  """The plain version's u32 keys are the JAX package's packed keys."""
  coords, feats = _cloud(6, 1, 500, 3, -1.0)
  zbuf, pbuf = splat_cuda.splat_fast(torch.from_numpy(coords),
                                     torch.from_numpy(feats), H, W,
                                     DEPTH_SCALE, -1.0)
  assert zbuf.dtype == torch.float32 and pbuf.dtype == torch.int64
  assert int(pbuf.min()) >= 0 and int(pbuf.max()) < 2**32
  got = pbuf != 0
  assert got.any() and (zbuf[got] <= DEPTH_SCALE).all()
  assert (zbuf[~got] == DEPTH_SCALE).all()
  # CPU tensors never reach the kernel.
  assert tracing.count('splat.fast_launches') == 0


def test_too_many_channels_raise():
  """Four channels do not pack into the u32 key: 'fast' returns the exact
  splat, bit-equal to JAX's 'fast' (which does the same) and to the
  port's exact splat."""
  coords, feats = _cloud(7, 1, 64, 3, -1.0)
  feats4 = np.concatenate([feats, feats[..., :1]], axis=-1)
  pd, pf = _port(coords, feats4, -1.0)
  jd, jf = _jax(j_splat.project_to_feat_fast, coords, feats4, -1.0)
  ed, ef = t_splat.project_to_feat(torch.from_numpy(coords),
                                   torch.from_numpy(feats4), H, W,
                                   DEPTH_SCALE, -1.0)
  for port, ref, exact in ((pd, jd, ed), (pf, jf, ef)):
    np.testing.assert_array_equal(port.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(port.numpy(), exact.numpy())


# -- geometry ---------------------------------------------------------------

F32_EPS = float(np.finfo(np.float32).eps)


def _assert_coords_close(port, ref, rad):
  """Coordinates within 8 float32 ULP of the point's radius.

  XLA evaluates sqrt/atan2/acos/sin/cos with its own approximations and
  contracts multiply-adds into FMAs; PyTorch rounds each op separately.
  Measured: <= 6e-7 * radius (5 ULP).
  """
  err = np.abs(port[:, :3] - ref[:, :3])
  bound = np.broadcast_to(8 * F32_EPS * rad, err.shape)
  assert np.all(err <= bound), np.max(err / np.maximum(bound, 1e-30))


def test_equirect_view_coords_close_to_jax():
  rs = np.random.RandomState(8)
  xyz = rs.uniform(-10, 10, (2, 4, 3000)).astype(np.float32)
  xyz[:, 3] = 1.0
  xyz[:, :3, :4] = 0.0  # the origin: elevation pi/2 by divide-no-nan
  port = geometry_t.equirect_view_coords(torch.from_numpy(xyz)).numpy()
  ref = np.asarray(geometry_j.equirect_view_coords(jnp.asarray(xyz)))
  _assert_coords_close(port, ref, ref[:, 2:3])
  np.testing.assert_array_equal(port[:, 3], ref[:, 3])


@pytest.mark.parametrize('method,channels', [('nearest', 0),
                                             ('bilinear', 3)])
def test_equirectangular_to_pointcloud_matches_jax(method, channels):
  """Features and the void mask exact; coordinates within 8 ULP."""
  rs = np.random.RandomState(9)
  depth = rs.uniform(-0.1, 1.1, (2, 16, 32)).astype(np.float32)
  depth[:, 0, :4] = [0.0, 1.0, 0.5, 0.999]
  shape = (2, 16, 32, channels) if channels else (2, 16, 32)
  feats = rs.randint(0, 256, shape).astype(np.int32)
  txyz, tfeats = geometry_t.equirectangular_to_pointcloud(
      torch.from_numpy(feats), torch.from_numpy(depth), -1, 20.0,
      interpolation_method=method)
  jxyz, jfeats = geometry_j.equirectangular_to_pointcloud(
      jnp.asarray(feats), jnp.asarray(depth), -1, 20.0,
      interpolation_method=method)
  jxyz = np.asarray(jxyz)
  assert tfeats.numpy().dtype == np.asarray(jfeats).dtype
  np.testing.assert_array_equal(tfeats.numpy(), np.asarray(jfeats))
  rad = np.sqrt((jxyz[:, :3].astype(np.float64) ** 2).sum(1, keepdims=True))
  _assert_coords_close(txyz.numpy(), jxyz, rad)
  np.testing.assert_array_equal(txyz.numpy()[:, 3], jxyz[:, 3])
  np.testing.assert_array_equal(txyz.numpy()[:, :3] == 0, jxyz[:, :3] == 0)


def test_mask_pano_matches_jax():
  rs = np.random.RandomState(10)
  pano = rs.randint(0, 256, (2, 16, 32, 3)).astype(np.int32)
  port = geometry_t.mask_pano(torch.from_numpy(pano), masked_region_value=-1)
  ref = geometry_j.mask_pano(jnp.asarray(pano), masked_region_value=-1)
  assert port.dtype == torch.int32
  np.testing.assert_array_equal(port.numpy(), np.asarray(ref))


def test_unported_splat_modes_raise():
  """Every single-cloud mode of the JAX package is ported; 'dual_sorted'
  splats two clouds (`project_dual_to_equirectangular`) and a name the
  JAX package does not have raises too."""
  xyz = torch.zeros((1, 4, 8))
  feats = torch.zeros((1, 8, 3))
  for mode in ('sorted_packed', 'fast_exact', 'sorted', 'pallas'):
    geometry_t.project_feats_to_equirectangular(feats, xyz, 8, 16, -1.0,
                                                20.0, splat_mode=mode)
  for mode in ('dual_sorted', 'sorted_fast'):
    with pytest.raises(ValueError, match='splat_mode'):
      geometry_t.project_feats_to_equirectangular(feats, xyz, 8, 16, -1.0,
                                                  20.0, splat_mode=mode)


@pytest.mark.parametrize('mode', ['fast', None])
def test_memory_splat_at_an_offset_is_subtract_then_project(mode):
  """`project_memory_equirect` on the CPU is the translated copy through
  `project_feats_to_equirectangular`, bit for bit; without the depth it
  returns None for it. Tolerance: none."""
  rs = np.random.RandomState(12)
  xyz = torch.from_numpy(rs.uniform(-5, 5, (BATCH, 4, 600)).astype(
      np.float32))
  xyz[:, 3] = 1.0
  feats = torch.from_numpy(rs.randint(-1, 256, (BATCH, 600, 3)).astype(
      np.float32))
  offset = torch.tensor([[0.5, -0.25, 0.1, 0.0], [-1.0, 0.3, 0.0, 0.0]])
  got = geometry_t.project_memory_equirect(feats, xyz, offset, H, W, -1.0,
                                           DEPTH_SCALE, mode)
  want = geometry_t.project_feats_to_equirectangular(
      feats, xyz - offset[..., None], H, W, -1.0, DEPTH_SCALE,
      splat_mode=mode)
  assert all(torch.equal(a, b) for a, b in zip(got, want))
  depth, feat = geometry_t.project_memory_equirect(
      feats, xyz, offset, H, W, -1.0, DEPTH_SCALE, mode, need_depth=False)
  assert depth is None and torch.equal(feat, want[1])
