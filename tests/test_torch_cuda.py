"""The CUDA kernels on the card, against their plain versions.

These tests need an NVIDIA card and nvcc (a CUDA kernel has no CPU mode)
and skip elsewhere. They import no JAX, so they run where the port runs:

    python -m pytest --noconftest -q tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from se3ds_torch.eval import metrics
from se3ds_torch.models import folding
from se3ds_torch.models import generator as generator_lib
from se3ds_torch.models import inference
from se3ds_torch.models import model_config
from se3ds_torch.ops import splat
from se3ds_torch.ops import splat_cuda


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
  before = splat_cuda.LAUNCHES
  zk, pk = splat_cuda.splat_fast(coords, feats, 64, 256, 20.0, -1.0)
  zp, pp = splat_cuda.splat_fast_plain(coords, feats, 64, 256, 20.0, -1.0)
  torch.cuda.synchronize()
  assert splat_cuda.LAUNCHES == before + (1 if num_points else 0)
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
  before = splat_cuda.LAUNCHES
  splat.project_to_feat_fast(coords, feats, 32, 64, 20.0, -1.0)
  assert splat_cuda.LAUNCHES == before + 1
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
  before = splat_cuda.LAUNCHES
  out = model(np.array([[0.3, 0, 0]], np.float32), add_preds_to_memory=True)
  assert splat_cuda.LAUNCHES == before + 2
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
  before = splat_cuda.EXACT_LAUNCHES
  zk, fk = splat_cuda.splat_exact(coords, feats, 64, 256, 20.0, -1.0, -1.0)
  zp, fp = splat_cuda.splat_exact_plain(coords, feats, 64, 256, 20.0, -1.0,
                                        -1.0)
  torch.cuda.synchronize()
  assert splat_cuda.EXACT_LAUNCHES == before + (2 if num_points else 0)
  assert torch.equal(zk, zp) and torch.equal(fk, fp)


@pytest.mark.cuda
def test_exact_splat_never_takes_the_plain_version(card):
  coords, feats = _cloud(7, 1, 1000, 3, card)
  before = splat_cuda.EXACT_LAUNCHES
  splat.project_to_feat(coords, feats, 32, 64, 20.0, -1.0)
  assert splat_cuda.EXACT_LAUNCHES == before + 2
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
  before = splat_cuda.EXACT_LAUNCHES
  generated, _, _ = metrics.rollout_generated(generator, batch, 2, 20.0)
  assert splat_cuda.EXACT_LAUNCHES == before + 4
  assert generated[1].is_cuda and torch.isfinite(generated[1]).all()
