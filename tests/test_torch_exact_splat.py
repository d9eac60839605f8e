"""Port parity: the exact z-buffer splat ('scatter' semantics) and its modes.

The port's `project_to_feat` (on the CPU: the plain version of the exact
CUDA kernel) must be BIT-equal to the JAX `project_to_feat` ('scatter'),
to its 'sorted' mode and, for byte features, to the TPU kernel
`_exact_splat_kernel` run in Pallas interpret mode: each is a per-pixel
min, an f32 window test and a per-channel max, which no summation order
can change. Inputs are view coordinates made with numpy, so both
packages see the same floats. Every cloud has the same shape (batch 2,
1024 points, 16x32 pixels), so JAX compiles each eager op once.
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

H, W = 16, 32
BATCH, POINTS = 2, 1024


def _random(seed, low, high, byte_feats=True, keep=1.0, channels=3):
  rs = np.random.RandomState(seed)
  coords = rs.uniform(low, high, (BATCH, 4, POINTS)).astype(np.float32)
  coords[:, 3] = 1.0
  coords[:, 2][rs.rand(BATCH, POINTS) >= keep] = -1.0
  if byte_feats:
    feats = rs.randint(-1, 256, (BATCH, POINTS, channels))
  else:  # negative and fractional features that are not void
    feats = rs.randint(-20, 20, (BATCH, POINTS, channels)) / 4.0
  return coords, feats.astype(np.float32)


def _collisions():
  """Batch 0: a dense cloud, ~2 points per pixel, many deeper than the
  depth_scale of 5. Batch 1: a sparse cloud (2% of the points in front of
  the camera) and the window's semantics, one pixel each:

  * (5, 3): two in-window points mix channels, (10, 200, 7) and
    (200, 10, 7) give (200, 200, 7); a point 0.2 m deeper is out.
  * (6, 3): f32(2.0) + f32(0.1) rounds to the float32 below f32(2.1),
    so a point at f32(2.1) is OUT of the window (in float64 it is in).
  * (7, 3): a point one float32 below that sum is in.
  * (1, 1): the minimum is the CLIPPED depth (5.0) while the window tests
    the RAW depth: 5.05 is in, 5.3 out.
  * (2, 1): only a point at 5.3, valid but outside every window: depth
    1 and the void fill.
  """
  edge = np.float32(np.float32(2.0) + np.float32(0.1))
  inside = np.nextafter(edge, np.float32(0))
  assert np.float32(2.1) >= edge
  coords, feats = _random(13, -6, 6)
  sparse, sparse_feats = _random(7, -6, 6, keep=0.02)
  coords[1], feats[1] = sparse[1], sparse_feats[1]
  for i, (px, py, depth, feat) in enumerate([
      (5, 3, 2.0, (10, 200, 7)), (5, 3, 2.05, (200, 10, 7)),
      (5, 3, 2.2, (255, 255, 255)),
      (6, 3, 2.0, (10, 10, 10)), (6, 3, np.float32(2.1), (99, 99, 99)),
      (7, 3, 2.0, (10, 10, 10)), (7, 3, inside, (99, 99, 99)),
      (1, 1, 5.05, (50, 60, 70)), (1, 1, 5.3, (80, 20, 90)),
      (2, 1, 5.3, (1, 2, 3))]):
    depth = np.float32(depth)
    coords[1, :, i] = [((px + 0.5) / W * 2 - 1) * depth,
                       ((py + 0.5) / H * 2 - 1) * depth, depth, 1.0]
    feats[1, i] = feat
  return coords, feats


# name -> (coords, feats, depth_scale, input void, output void, byte feats)
CASES = {
    'collisions': _collisions() + (5.0, -1.0, -1.0, True),
    'negative features': _random(3, -4, 4, byte_feats=False) + (
        10.0, -1.0, -1.0, False),
    'scalar features': (_random(5, -4, 4)[0],
                        np.random.RandomState(5).randint(
                            0, 42, (BATCH, POINTS)).astype(np.float32),
                        10.0, 0.0, 0.0, True),
    'empty': (np.zeros((1, 4, 0), np.float32),
              np.zeros((1, 0, 3), np.float32), 20.0, -1.0, -1.0, True),
}


def _port(coords, feats, depth_scale, in_void, out_void):
  pd, pf = t_splat.project_to_feat(
      torch.from_numpy(coords), torch.from_numpy(feats), H, W,
      depth_scale=depth_scale, input_void_class=in_void,
      output_void_class=out_void)
  return pd.numpy(), pf.numpy()


def _pallas_exact(coords, feats, **kw):
  return splat_pallas.project_to_feat_pallas_exact(coords, feats,
                                                   interpret=True, **kw)


REFERENCES = {
    'scatter': j_splat.project_to_feat,
    'sorted': j_splat.project_to_feat_sorted,
    'pallas_exact interpret': _pallas_exact,
}
# The Pallas kernel packs features into bytes: byte features only.
PAIRS = [(case, ref) for case in CASES for ref in REFERENCES
         if CASES[case][5] or ref != 'pallas_exact interpret']


@pytest.mark.parametrize('case,reference', PAIRS,
                         ids=[f'{c}-{r}' for c, r in PAIRS])
def test_exact_splat_bit_equal_to_jax(case, reference):
  """Tolerance: none (array_equal). JAX runs op by op, as its own tests
  call it (under jit XLA divides by depth_scale as a multiply)."""
  coords, feats, depth_scale, in_void, out_void, _ = CASES[case]
  pd, pf = _port(coords, feats, depth_scale, in_void, out_void)
  jd, jf = REFERENCES[reference](
      jnp.asarray(coords), jnp.asarray(feats), height=H, width=W,
      depth_scale=depth_scale, input_void_class=in_void,
      output_void_class=out_void)
  np.testing.assert_array_equal(pd, np.asarray(jd))
  np.testing.assert_array_equal(pf, np.asarray(jf))


def test_window_semantics_by_value():
  """The per-channel channel-mixing max, the f32 window sum and the void
  fill, read off the port's output."""
  coords, feats, depth_scale, in_void, out_void, _ = CASES['collisions']
  pd, pf = _port(coords, feats, depth_scale, in_void, out_void)
  np.testing.assert_array_equal(pf[1, 3, 5], [200, 200, 7])
  np.testing.assert_array_equal(pf[1, 3, 6], [10, 10, 10])
  np.testing.assert_array_equal(pf[1, 3, 7], [99, 99, 99])
  assert pd[1, 3, 5] == np.float32(2.0) / np.float32(5.0)
  np.testing.assert_array_equal(pf[1, 1, 1], [50, 60, 70])
  np.testing.assert_array_equal(pf[1, 1, 2], [-1, -1, -1])
  assert pd[1, 1, 1] == pd[1, 1, 2] == 1.0


@pytest.mark.parametrize('mode', [None, 'sorted'])
def test_jax_equirect_modes_equal_the_port_splat(mode):
  """JAX `project_feats_to_equirectangular` in its exact modes against
  the port's splat on JAX's own view coordinates (the trig of the two
  packages differs by ULPs, the splat by nothing); tolerance: none."""
  rs = np.random.RandomState(11)
  xyz = rs.uniform(-5, 5, (BATCH, 4, POINTS)).astype(np.float32)
  xyz[:, 3] = 1.0
  feats = rs.randint(-1, 256, (BATCH, POINTS, 3)).astype(np.float32)
  jd, jf = geometry_j.project_feats_to_equirectangular(
      jnp.asarray(feats), jnp.asarray(xyz), H, W, -1.0, 20.0,
      splat_mode=mode)
  view = np.array(geometry_j.equirect_view_coords(jnp.asarray(xyz)))
  pd, pf = _port(view, feats, 20.0, -1.0, 0.0)
  np.testing.assert_array_equal(pd, np.asarray(jd))
  np.testing.assert_array_equal(pf, np.asarray(jf))


def test_port_routes_every_exact_mode_to_the_exact_splat():
  coords, feats, *_ = CASES['collisions']
  xyz, feats = torch.from_numpy(coords), torch.from_numpy(feats)
  view = geometry_t.equirect_view_coords(xyz)
  want = t_splat.project_to_feat(view, feats, H, W, 5.0, -1.0)
  for mode in (None, 'scatter', 'sorted', 'pallas_exact'):
    got = geometry_t.project_feats_to_equirectangular(
        feats, xyz, H, W, -1.0, 5.0, splat_mode=mode)
    assert all(torch.equal(a, b) for a, b in zip(got, want)), mode
  fast = geometry_t.project_feats_to_equirectangular(
      feats, xyz, H, W, -1.0, 5.0, splat_mode='fast')
  assert not torch.equal(fast[1], want[1])  # the cloud tells them apart
  # CPU tensors never reach the kernel.
  assert tracing.count('splat.exact_launches') == 0


def test_order_keys_sort_and_round_trip():
  """The kernel's order-preserving u32 keys of float32 features (its
  `order_key`, mirrored in Python) sort as the floats do and decode to
  the same bits."""
  values = np.array([-np.inf, -3e38, -3.5, -1.0, -1e-30, -0.0, 0.0, 1e-45,
                     1.0, 255.0, 3e38, np.inf], np.float32)
  keys = [splat_cuda.order_key(float(v)) for v in values]
  unsigned = [k & 0xFFFFFFFF for k in keys]
  assert unsigned == sorted(unsigned) and len(set(unsigned)) == len(keys)
  decoded = splat_cuda.decode_order_keys(torch.tensor(keys,
                                                      dtype=torch.int32))
  np.testing.assert_array_equal(decoded.numpy().view(np.uint32),
                                values.view(np.uint32))


def test_exact_plain_buffers():
  """zbuf holds the minimum (depth_scale where empty), fbuf the void
  fill where no point is; any channel count."""
  coords, feats = _random(9, -4, 4, channels=5)
  zbuf, fbuf = splat_cuda.splat_exact(torch.from_numpy(coords),
                                      torch.from_numpy(feats), H, W, 10.0,
                                      -1.0, -7.0)
  assert zbuf.shape == (BATCH, H * W) and fbuf.shape == (BATCH, H * W, 5)
  empty = zbuf == 10.0
  assert (~empty).any() and (zbuf[~empty] < 10.0).all()
  hit = (fbuf != -7.0).all(-1)
  assert not (hit & empty).any() and hit.any()
  assert (fbuf[~hit] == -7.0).all()
