"""Port parity: the generator and its weight bridge from Flax.

One JAX generator per file: random Flax variables (numpy, from a seed)
are folded by the JAX package's `fold_spectral_variables` and run through
its folded `ResNetGenerator`; the same variables go through the port's
`torch_state_dict_from_flax` into the port's generator. Both run float32
on the CPU.
"""

import jax
import numpy as np
import pytest
import torch

from se3ds_torch import tracing
from se3ds_torch.models import folding as folding_t
from se3ds_torch.models import generator as generator_t
from se3ds_torch.models import layers as layers_t
from se3ds_tpu.models import folding as folding_j
from se3ds_tpu.models import generator as generator_j

H = 32
GEN = dict(gen_dims=4, z_dim=4, resnet_version='tiny')


def random_flax_variables(shapes, seed):
  """Random values for a Flax variable tree: glorot-scale kernels, BN
  statistics away from the identity, power-iteration states u."""
  rs = np.random.RandomState(seed)

  def fill(path, leaf):
    name = path[-1].key
    shape = leaf.shape
    if name == 'kernel':
      fan = np.prod(shape[:-2]) * (shape[-2] + shape[-1])
      value = rs.uniform(-1, 1, shape) * np.sqrt(6.0 / fan)
    elif name in ('scale', 'var'):
      value = rs.uniform(0.5, 1.5, shape)
    elif name == 'u':
      value = rs.normal(0.0, 0.05, shape)
    else:  # bias, mean
      value = rs.normal(0.0, 0.1, shape)
    return value.astype(np.float32)

  return jax.tree_util.tree_map_with_path(fill, shapes)


def _cond(seed):
  rs = np.random.RandomState(seed)
  return {
      'proj_image': rs.uniform(0, 1, (2, H, 2 * H, 3)).astype(np.float32),
      'proj_depth': rs.uniform(0, 1, (2, H, 2 * H, 1)).astype(np.float32),
      'proj_mask': (rs.rand(2, H, 2 * H, 1) > 0.3).astype(np.float32),
      'blurred_mask': (rs.rand(2, H, 2 * H, 1) > 0.8).astype(np.float32),
  }


@pytest.fixture(scope='module')
def flax_generator():
  """(live variables, folded variables, JAX outputs, cond)."""
  cond = _cond(1)
  live = generator_j.ResNetGenerator(image_size=H, **GEN)
  shapes = jax.eval_shape(
      lambda: live.init(jax.random.PRNGKey(0), cond, train=False))
  variables = random_flax_variables(shapes, seed=0)
  folded = folding_j.fold_spectral_variables(live, variables, cond)
  model = generator_j.ResNetGenerator(image_size=H, spectral_fold=True, **GEN)
  outs = jax.jit(lambda v, c: model.apply(v, c, train=False))(folded, cond)
  return variables, folded, [np.asarray(o) for o in outs], cond


def _port(variables):
  model = generator_t.ResNetGenerator(**GEN)
  model.load_state_dict(folding_t.torch_state_dict_from_flax(variables,
                                                             model))
  return model.eval()


def test_generator_matches_jax(flax_generator):
  """The 7-output contract, float32.

  Tolerance: atol 1e-5. Two CPU convolution libraries sum in different
  orders over ~40 layers; measured max |delta| 3.6e-7 on outputs in
  [0, 1].
  """
  variables, _, ref, cond = flax_generator
  model = _port(variables)
  with torch.no_grad():
    out = model({k: torch.from_numpy(v) for k, v in cond.items()})
  assert len(out) == 7
  for got, want in zip(out, ref):
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


def test_served_layout_equals_contiguous_nchw(flax_generator, monkeypatch):
  """The served form (channels_last kernels, the permuted input's
  channels_last view) runs every convolution in channels_last memory and
  gives the outputs of the same forward on contiguous NCHW inputs and
  OIHW kernels, float32, within the tolerance of the JAX comparison."""
  variables, _, _, cond = flax_generator
  cond = {k: torch.from_numpy(v) for k, v in cond.items()}
  served = _port(variables)
  layers_t.store_served_kernels(served, torch.float32)
  tracing.reset()
  with torch.no_grad():
    got = served(cond)
  convs = sum(isinstance(m, (layers_t._Conv, layers_t.Conv2DTranspose))
              for m in served.modules())
  assert tracing.count('generator.convs') == convs
  assert tracing.count('generator.nchw_convs') == 0
  monkeypatch.setattr(generator_t, '_nchw',
                      lambda x: x.permute(0, 3, 1, 2).contiguous())
  tracing.reset()
  with torch.no_grad():
    want = _port(variables)(cond)
  assert tracing.count('generator.nchw_convs') == convs
  tracing.reset()
  for a, b in zip(got, want):
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-5)


def test_prefolded_variables_give_the_same_model(flax_generator):
  """Variables the JAX package already folded (no 'spectral') load as is;
  tolerance: 1e-6 (the fold's matvecs run in another library)."""
  variables, folded, _, _ = flax_generator
  assert 'spectral' not in folded
  a = folding_t.torch_state_dict_from_flax(variables, _port(variables))
  b = folding_t.torch_state_dict_from_flax(folded, _port(variables))
  assert a.keys() == b.keys()
  for k in a:
    np.testing.assert_allclose(a[k].numpy(), b[k].numpy(), rtol=0, atol=1e-6)


def test_fold_touches_exactly_the_spectral_convs(flax_generator):
  """The port folds the kernels the JAX fold changed, found from the
  port's own SpectralConv modules; PartialConv kernels stay RAW."""
  variables, folded, _, _ = flax_generator
  flat_live = jax.tree_util.tree_flatten_with_path(variables['params'])[0]
  flat_folded = dict(
      jax.tree_util.tree_flatten_with_path(folded['params'])[0])
  changed = {'.'.join(k.key for k in path[:-1])
             for path, value in flat_live
             if path[-1].key == 'kernel'
             and not np.array_equal(value, flat_folded[path])}
  model = generator_t.ResNetGenerator(**GEN)
  assert folding_t.spectral_conv_names(model) == changed
  state = folding_t.torch_state_dict_from_flax(variables, model)
  raw = variables['params']['encoder']['stack1']['block0']['conv2']['kernel']
  assert 'encoder.stack1.block0.conv2' not in changed  # a PartialConv
  np.testing.assert_array_equal(
      state['encoder.stack1.block0.conv2.weight'].numpy(),
      raw.transpose(3, 2, 0, 1))


def test_state_dict_covers_every_port_tensor(flax_generator):
  variables, _, _, _ = flax_generator
  model = generator_t.ResNetGenerator(**GEN)
  state = folding_t.torch_state_dict_from_flax(variables, model)
  assert set(state) == set(model.state_dict())


def test_random_init_is_seeded_and_finite():
  a = generator_t.ResNetGenerator(**GEN)
  b = generator_t.ResNetGenerator(**GEN)
  folding_t.init_random_(a, torch.Generator().manual_seed(3))
  folding_t.init_random_(b, torch.Generator().manual_seed(3))
  for (ka, va), (kb, vb) in zip(a.state_dict().items(),
                                b.state_dict().items()):
    assert ka == kb and torch.equal(va, vb)
  with torch.no_grad():
    out = a.eval()({k: torch.from_numpy(v) for k, v in _cond(2).items()})
  assert all(torch.isfinite(o).all() for o in out)
  # A folded SpectralConv kernel has spectral norm close to 1.
  w = a.global_context.conv0.weight.detach()
  sigma = torch.linalg.matrix_norm(w.reshape(w.shape[0], -1), ord=2)
  assert 0.5 < float(sigma) < 1.5
  assert isinstance(a.global_context.conv0, layers_t.SpectralConv)
