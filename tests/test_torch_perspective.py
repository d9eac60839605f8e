"""Port parity for `ops/image.py` and the perspective, rotation and
resampling functions of `ops/geometry.py` (the RE10K flow).

The same numpy inputs, made from seeds, go through the JAX functions
(eagerly) and the port's on the CPU.

Tolerances, with their reasons (values in [0, 255] unless stated):
* `resize` linear and cubic: atol RESIZE_ATOL. Both build per-axis
  weight matrices and sum the taps in float32, in different orders
  (measured <= 2.2e-4). Nearest: equal, in the input dtype.
* `interpolate_bilinear`: equal (the same float32 ops in the same order).
* Rays, transforms and unprojected coordinates: XLA's and PyTorch's
  trig, `linalg.inv` and 3x3 products round differently by an ULP or
  so: rays atol 1e-6 (unit vectors; measured 5.7e-7), transforms atol
  1e-5 (entries up to ~40; measured 9.5e-7), coordinates within 8 ULP of
  the 20 m depth scale (measured 5.2e-6).
* Images sampled at those coordinates: atol SAMPLED_ATOL (a coordinate
  an ULP apart moves a bilinear sample by up to ~255 * the ULP of the
  coordinate; measured <= 4.8e-3). With `round_to_nearest` the samples
  are whole pixels: at most MOVED_PIXELS (0.5%) of them may differ,
  where a coordinate an ULP apart rounds the other way (measured 0); the
  rest are equal, but for the 'mean' padding, a float32 mean summed in
  another order (within SAMPLED_ATOL).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from se3ds_torch.ops import geometry as geometry_t
from se3ds_torch.ops import image as image_t
from se3ds_tpu.ops import geometry as geometry_j
from se3ds_tpu.ops import image as image_j
from test_torch_serving import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures('one_torch_thread')

RESIZE_ATOL = 1e-3
SAMPLED_ATOL = 2e-2
MOVED_PIXELS = 0.005
COORD_ATOL = 8 * np.finfo(np.float32).eps * 20.0
FOV = np.array([0.8, 0.9], np.float32)


def _close(got, want, atol):
  want = np.asarray(want)
  got = got.numpy()
  assert got.shape == want.shape and got.dtype == want.dtype
  np.testing.assert_allclose(got, want, rtol=0, atol=atol)


def _rotation(seed):
  q, _ = np.linalg.qr(np.random.RandomState(seed).randn(3, 3))
  return q.astype(np.float32)


@pytest.mark.parametrize('antialias', [False, True])
@pytest.mark.parametrize('method', ['bilinear', 'nearest', 'bicubic'])
def test_resize_matches_jax(method, antialias):
  rs = np.random.RandomState(0)
  images = (rs.rand(2, 17, 34, 3) * 255).astype(np.float32)
  if method == 'nearest':
    images = images.astype(np.int32)
  for size in ((9, 18), (40, 80), (17, 50)):
    want = image_j.resize(jnp.asarray(images), size, method, antialias)
    got = image_t.resize(torch.from_numpy(images), size, method, antialias)
    if method == 'nearest':
      assert got.dtype == torch.int32
      np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    else:
      _close(got, want, RESIZE_ATOL)
  with pytest.raises(ValueError):
    image_t.resize(torch.from_numpy(images), (4, 8), 'area')


@pytest.mark.parametrize('indexing', ['ij', 'xy'])
def test_interpolate_bilinear_matches_jax(indexing):
  """Queries well outside the grid clamp to the border neighbourhood."""
  rs = np.random.RandomState(1)
  grid = (rs.rand(2, 17, 34, 3) * 255).astype(np.float32)
  queries = rs.uniform(-3, 40, (2, 50, 2)).astype(np.float32)
  want = image_j.interpolate_bilinear(jnp.asarray(grid),
                                      jnp.asarray(queries), indexing)
  got = image_t.interpolate_bilinear(torch.from_numpy(grid),
                                     torch.from_numpy(queries), indexing)
  np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_crop_pano_resized_to_original_matches_jax():
  """Integer panos: resized in float32, cast back (truncation)."""
  pano = np.random.RandomState(2).randint(0, 256, (2, 16, 32, 3)).astype(
      np.int32)
  want = geometry_j.crop_pano(jnp.asarray(pano), resize_to_original=True)
  got = geometry_t.crop_pano(torch.from_numpy(pano), resize_to_original=True)
  assert got.dtype == torch.int32
  np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize('method,channels', [('nearest', 0),
                                             ('bilinear', 3)])
def test_equirectangular_to_pointcloud_at_size_mult_2(method, channels):
  rs = np.random.RandomState(3)
  depth = rs.uniform(-0.1, 1.1, (1, 8, 16)).astype(np.float32)
  shape = (1, 8, 16, channels) if channels else (1, 8, 16)
  feats = rs.randint(0, 40, shape).astype(np.int32)
  want = geometry_j.equirectangular_to_pointcloud(
      jnp.asarray(feats), jnp.asarray(depth), 0, 20.0, size_mult=2,
      interpolation_method=method)
  got = geometry_t.equirectangular_to_pointcloud(
      torch.from_numpy(feats), torch.from_numpy(depth), 0, 20.0,
      size_mult=2, interpolation_method=method)
  assert got[0].shape == (1, 4, 16 * 32)
  _close(got[0], want[0], COORD_ATOL)
  want_feats = np.asarray(want[1])
  assert got[1].numpy().dtype == want_feats.dtype
  np.testing.assert_array_equal(got[1].numpy(), want_feats)


def test_world_to_image_transform_matches_jax():
  intrinsics = np.array([[30, 0, 12], [0, 28, 11], [0, 0, 1]], np.float32)
  for kwargs in ({}, {'rotations': (0.3, -1.2)},
                 {'rotation_matrix': _rotation(4)},
                 {'camera_intrinsics': intrinsics,
                  'rotation_matrix': _rotation(5)}):
    want = geometry_j.get_world_to_image_transform(
        (20, 30), jnp.asarray(FOV),
        **{k: (v if k == 'rotations' else jnp.asarray(v))
           for k, v in kwargs.items()})
    got = geometry_t.get_world_to_image_transform((20, 30), FOV, **kwargs)
    _close(got, want, 1e-5)


def test_equirectangular_pixel_rays_match_jax():
  _close(geometry_t.equirectangular_pixel_rays(16),
         geometry_j.equirectangular_pixel_rays(16), 1e-6)


@pytest.mark.parametrize('output_height', [None, 8])
def test_rotate_pano_matches_jax(output_height):
  rs = np.random.RandomState(6)
  pano = (rs.rand(2, 16, 32, 3) * 255).astype(np.float32)
  matrices = np.stack([_rotation(7), _rotation(8)])
  want = geometry_j.rotate_pano(jnp.asarray(pano), jnp.asarray(matrices),
                                output_height)
  got = geometry_t.rotate_pano(torch.from_numpy(pano),
                               torch.from_numpy(matrices), output_height)
  _close(got, want, SAMPLED_ATOL)


@pytest.mark.parametrize('round_to_nearest', [False, True])
@pytest.mark.parametrize('pad_mode', ['constant', 'mean', 'reflect'])
def test_project_perspective_image_matches_jax(pad_mode, round_to_nearest):
  image = (np.random.RandomState(9).rand(24, 24, 3) * 255).astype(np.float32)
  kwargs = dict(pad_mode=pad_mode, pad_value=-1.0,
                round_to_nearest=round_to_nearest, rotations=(0.1, 0.4))
  want = np.asarray(geometry_j.project_perspective_image(
      jnp.asarray(image), jnp.asarray(FOV), 16, **kwargs))
  got = geometry_t.project_perspective_image(torch.from_numpy(image), FOV, 16,
                                             **kwargs)
  assert got.shape == want.shape == (16, 32, 3)
  if round_to_nearest:
    err = np.abs(got.numpy() - want)
    moved = (err > SAMPLED_ATOL).any(-1)
    assert moved.mean() <= MOVED_PIXELS, moved.sum()
    if pad_mode != 'mean':  # the mean pad value is a float32 sum
      np.testing.assert_array_equal(got.numpy()[~moved], want[~moved])
  else:
    _close(got, want, SAMPLED_ATOL)
  # The rays behind the camera read the padding.
  if pad_mode == 'constant':
    assert (want == -1.0).any()


def test_perspective_from_equirectangular_image_matches_jax():
  pano = (np.random.RandomState(10).rand(16, 32, 3) * 255).astype(np.float32)
  intrinsics = np.array([[30, 0, 12], [0, 28, 11], [0, 0, 1]], np.float32)
  rotation = _rotation(11)
  want = geometry_j.get_perspective_from_equirectangular_image(
      jnp.asarray(pano), jnp.asarray(intrinsics), jnp.asarray(rotation), 20,
      24)
  got = geometry_t.get_perspective_from_equirectangular_image(
      torch.from_numpy(pano), intrinsics, rotation, 20, 24)
  _close(got, want, SAMPLED_ATOL)


def test_intrinsic_matrix_matches_jax():
  for hfov in (geometry_t.constants.HFOV, 1.1):
    np.testing.assert_array_equal(
        geometry_t.get_intrinsic_matrix(hfov).numpy(),
        np.asarray(geometry_j.get_intrinsic_matrix(hfov)))


@pytest.mark.parametrize('channels', [0, 3])
def test_filtered_coords_and_feats_match_jax(channels):
  """Scalar (integer) and vector (float) features; invalid depths zeroed."""
  rs = np.random.RandomState(12)
  depth = rs.uniform(-0.1, 1.2, (2, 12, 16)).astype(np.float32)
  feats = (rs.randint(0, 5, (2, 12, 16)).astype(np.int32) if not channels
           else rs.rand(2, 12, 16, channels).astype(np.float32))
  want = geometry_j.get_filtered_coords_and_feats(
      jnp.asarray(feats), jnp.asarray(depth), 20.0)
  got = geometry_t.get_filtered_coords_and_feats(
      torch.from_numpy(feats), torch.from_numpy(depth), 20.0)
  _close(got[0], want[0], COORD_ATOL)
  assert got[1].dtype == torch.float32
  np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
