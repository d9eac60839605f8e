"""The reference copies agree with the port on the CPU at test sizes:
the generator as it serves and the train step, through the cells' own
drivers (the port's plain splat and its eager calls on the CPU), and
the FLOP counts."""

import numpy as np
import pytest
import torch

from benchmark import traffic
from benchmark import weights as weights_lib
from benchmark.drivers import serving
from benchmark.drivers import train_step
from benchmark.reference import flops as ref_flops
from benchmark.reference import generator as ref_gen
from benchmark.tests import conftest


@pytest.mark.parametrize('name', ['serve-traj-ring', 'serve-poses-k8'])
def test_served_calls_agree_with_the_reference(name):
  outcome = conftest.run_tiny(name)
  readings = outcome.readings['program']
  assert readings['guidance_px'] == 0
  assert readings['memory_pts'] == 0
  # bfloat16 against float32 at this size: ~0.6 levels, ~1e-3 of depth.
  assert readings['rgb_mae'] < 2.0
  assert readings['depth_mae'] < 3e-3
  assert outcome.attempted > 0


def test_train_steps_agree_with_the_reference():
  readings = conftest.run_tiny('train-highres-remat').readings['program']
  # float32 on both sides: rounding only.
  assert readings['loss_gap'] < 1e-4
  assert readings['grad_gap'] < 1e-3
  assert readings['change_gap'] < 0.1


def test_served_generator_equals_the_port_in_float32():
  from se3ds_torch.models import folding
  from se3ds_torch.models import generator as port_gen
  cfg = dict(gen_dims=4, resnet_version='tiny', use_blurred_mask=True)
  with torch.device('meta'):
    leaves = weights_lib.flax_leaves(serving.reference(cfg, 'meta'))
  weights = weights_lib.Weights.make(leaves, 7, 'cpu')
  ref = serving.reference(cfg, 'cpu')
  ref_gen.load_flax(ref, weights.tree)
  port = port_gen.ResNetGenerator(gen_dims=4, resnet_version='tiny')
  port.load_state_dict(folding.torch_state_dict_from_flax(
      weights.numpy_tree(), port))
  port.eval()
  g = torch.Generator().manual_seed(0)
  shape = (2, 32, 64)
  cond = {'proj_image': torch.rand(shape + (3,), generator=g),
          'proj_depth': torch.rand(shape + (1,), generator=g),
          'proj_mask': (torch.rand(shape + (1,), generator=g) > 0.3).float(),
          'blurred_mask': torch.zeros(shape + (1,))}
  with torch.no_grad():
    depth, rgb = ref(cond)
    out = port(cond)
  torch.testing.assert_close(depth, out[3], rtol=0, atol=1e-5)
  torch.testing.assert_close(rgb, out[6], rtol=0, atol=1e-5)


def test_serving_flops_equal_the_ports_count():
  from se3ds_torch.models import generator as port_gen
  from se3ds_torch.utils import flops as port_flops
  with torch.device('meta'):
    port = port_gen.ResNetGenerator(gen_dims=8, resnet_version='50').eval()
    cond = {k: torch.empty((1, 64, 128, c)) for k, c in
            (('proj_image', 3), ('proj_depth', 1), ('proj_mask', 1),
             ('blurred_mask', 1))}
  with torch.no_grad():
    expected = port_flops.count_flops(port, cond)
  assert ref_flops.served_pano(8, '50', 64) == expected


def test_train_step_flops_equal_the_ports_count():
  from se3ds_torch import config as config_lib
  from se3ds_torch.train import trainer  # noqa: F401 (gin names)
  cell = conftest.tiny('train-highres-remat')
  gin = [l for l in cell.config['gin'] if not l.startswith('GAN.remat')]
  spec = train_step.Spec({'gin': gin})
  config_lib.clear_config()
  config_lib.parse_config('\n'.join(gin))
  port = config_lib.apply_config('GAN', model_dir='', device='cpu')
  n, h = spec.step_examples, spec.image_size
  batch = {k: np.zeros((n, h, 2 * h, c), np.float32) for k, c in
           (('image', 3), ('depth', 1), ('proj_image', 3), ('proj_depth', 1),
            ('proj_mask', 1), ('blurred_mask', 1))}
  assert train_step.step_flops(spec) == port.step_flops(batch)


def test_a_seed_gives_the_same_traffic():
  a = traffic.synthetic_pano(16, traffic.rng(2**40 + 3, 'scene'))
  b = traffic.synthetic_pano(16, traffic.rng(2**40 + 3, 'scene'))
  assert all(np.array_equal(x, y) for x, y in zip(a, b))
  path = traffic.closed_loop(traffic.rng(9, 'path'), 48, [0.3, 0.9])
  radius = np.linalg.norm(path, axis=1)
  assert np.allclose(radius, radius[0]) and 0.3 <= radius[0] <= 0.9
