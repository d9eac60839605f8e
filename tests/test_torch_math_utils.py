"""Port parity: `se3ds_torch.utils.math_utils` against
`se3ds_tpu.utils.math_utils` on seeded numpy inputs, CPU.

Tolerances: the colormaps, the inpainting (tie cases included) and the
copied checkpoint path are exact. The KL and `reparameterize` go
through exp and log, which the two CPU libraries round differently by
an ULP: rtol 1e-6, atol 1e-7. IoU and accuracy divide integer-valued
float32 sums, so they are exact per frame; their means sum in another
order: rtol 1e-6.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from se3ds_torch import constants as constants_t
from se3ds_torch.utils import math_utils as mu_t
from se3ds_tpu import constants as constants_j
from se3ds_tpu.utils import math_utils as mu_j


def test_colormaps_and_class_names():
  cmap = mu_t.create_label_colormap()
  assert np.array_equal(cmap, mu_j.create_label_colormap())
  labels = np.random.RandomState(0).randint(0, 42, (8, 16))
  got = mu_t.cmap_to_label(cmap[labels], cmap)
  assert np.array_equal(got, mu_j.cmap_to_label(cmap[labels], cmap))
  assert np.array_equal(got, labels)
  assert constants_t.MP3D_ID2CLASS == constants_j.MP3D_ID2CLASS


def test_compute_kl():
  rs = np.random.RandomState(1)
  args = [rs.normal(0, s, (4, 8)).astype(np.float32)
          for s in (1.0, 0.5, 1.0, 0.5)]
  got = mu_t.compute_kl(*map(torch.from_numpy, args))
  want = mu_j.compute_kl(*map(jnp.asarray, args))
  np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                             atol=1e-7)
  with pytest.raises(ValueError):
    mu_t.compute_kl(torch.ones(2, 2), torch.ones(2, 2), torch.ones(2, 3),
                    torch.ones(2, 3))


def test_reparameterize_is_the_formula_with_the_generators_eps():
  rs = np.random.RandomState(2)
  mu, logvar = (rs.normal(size=(3, 5)).astype(np.float32) for _ in range(2))
  got = mu_t.reparameterize(torch.Generator().manual_seed(3),
                            torch.from_numpy(mu), torch.from_numpy(logvar))
  eps = torch.randn((3, 5), generator=torch.Generator().manual_seed(3))
  want = eps.numpy() * jnp.exp(0.5 * jnp.asarray(logvar)) + mu
  np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                             atol=1e-7)


def _masks(rs, n, t):
  mask = (rs.rand(n, t) > 0.3).astype(np.float32)
  mask[0] = 0  # an example with no valid frame: divide_no_nan
  return mask


@pytest.mark.parametrize('with_spatial_mask', [False, True])
def test_compute_sequence_iou(with_spatial_mask):
  rs = np.random.RandomState(4)
  eye = np.eye(5, dtype=np.float32)
  pred = eye[rs.randint(0, 5, (3, 4, 6, 7))]
  true = eye[rs.randint(0, 5, (3, 4, 6, 7))]
  true[1, 2] = pred[1, 2]  # a perfect frame
  mask = _masks(rs, 3, 4)
  spatial = ((rs.rand(3, 4, 6, 7) > 0.2).astype(np.float32)
             if with_spatial_mask else None)
  args = [pred, true, mask, spatial]
  got = mu_t.compute_sequence_iou(
      *[None if a is None else torch.from_numpy(a) for a in args])
  want = mu_j.compute_sequence_iou(
      *[None if a is None else jnp.asarray(a) for a in args])
  np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
  np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=1e-6)


@pytest.mark.parametrize('with_spatial_mask', [False, True])
def test_compute_sequence_accuracy(with_spatial_mask):
  rs = np.random.RandomState(5)
  pred = rs.randint(0, 4, (3, 4, 6, 7)).astype(np.int32)
  gt = np.where(rs.rand(3, 4, 6, 7) > 0.4, pred, 0).astype(np.int32)
  mask = _masks(rs, 3, 4)
  spatial = ((rs.rand(3, 4, 6, 7) > 0.2).astype(np.float32)
             if with_spatial_mask else None)
  args = [pred, gt, mask, spatial]
  got = mu_t.compute_sequence_accuracy(
      *[None if a is None else torch.from_numpy(a) for a in args])
  want = mu_j.compute_sequence_accuracy(
      *[None if a is None else jnp.asarray(a) for a in args])
  np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
  np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=1e-6)


def test_nearest_neighbor_inpaint_with_ties():
  rs = np.random.RandomState(6)
  images = np.where(rs.rand(4, 9, 13) > 0.9,
                    rs.randint(1, 40, (4, 9, 13)), 0).astype(np.int32)
  images[1] = 0  # nothing to copy from: stays void
  images[2] = 0  # pixel (4, 6) is equally far from all four sources
  images[2, 2, 6], images[2, 4, 4] = 7, 8
  images[2, 4, 8], images[2, 6, 6] = 9, 10
  images[3] = 0  # pixel (0, 2) is as far from (0, 0) as from (0, 4)
  images[3, 0, 0], images[3, 0, 4] = 3, 5
  got = mu_t.nearest_neighbor_inpaint(torch.from_numpy(images)).numpy()
  want = np.asarray(mu_j.nearest_neighbor_inpaint(jnp.asarray(images)))
  np.testing.assert_array_equal(got, want)
  assert got[2, 4, 6] == 7 and got[3, 0, 2] == 3  # the first source wins
  assert not got[1].any() and (got[0] != 0).all()


def test_get_local_ckpt_path(tmp_path, monkeypatch):
  source = tmp_path / 'src'
  (source / 'ckpt').mkdir(parents=True)
  (source / 'ckpt' / 'weights').write_text('w')
  (source / 'ckpt-1.index').write_text('i')
  results = []
  for name, module in (('port', mu_t), ('jax', mu_j)):
    work = tmp_path / name
    work.mkdir()
    monkeypatch.chdir(work)
    results.append((module.get_local_ckpt_path(str(source / 'ckpt')),
                    sorted(os.listdir(work)),
                    module.get_local_ckpt_path(str(source / 'ckpt-1')),
                    sorted(os.listdir(work))))
  assert results[0] == results[1]
  assert results[0][1] == ['weights']
