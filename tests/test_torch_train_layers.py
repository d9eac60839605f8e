"""Port parity: the layers in training mode, the discriminator and the
generator in training, against the Flax modules (train=True,
mutable=[...]), float32 CPU.

Every JAX reference is jitted at XLA's lowest backend optimisation level
and without XLA's CPU fusion emitters (the compile is most of this file's
time on one core; the emitters are a code generator, not a change of the
arithmetic). Tolerances:
layer outputs atol 1e-5 (two CPU convolution libraries sum in other
orders; activations are O(1)); stored power-iteration states u and
BatchNorm statistics atol 1e-6; kernel gradients atol 1e-5 of their
largest element; pools exact up to the division (1 ULP). The whole
generator in training: atol 2e-4 (G_TRAIN_ATOL).
"""

import functools

import jax
import numpy as np
import pytest
import torch

from se3ds_torch.models import discriminator as disc_t
from se3ds_torch.models import folding as folding_t
from se3ds_torch.models import generator as gen_t
from se3ds_torch.models import layers as layers_t
from se3ds_tpu.models import discriminator as disc_j
from se3ds_tpu.models import generator as gen_j
from se3ds_tpu.models import layers as layers_j
from test_torch_serving import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures('one_torch_thread')

ATOL = 1e-5
STATE_ATOL = 1e-6


def _compiled(fn, *args):
  return jax.jit(fn).lower(*args).compile(compiler_options={
      'xla_backend_optimization_level': 0,
      'xla_cpu_use_fusion_emitters': False})


def _nchw(x):
  return torch.from_numpy(np.ascontiguousarray(np.asarray(x).transpose(
      0, 3, 1, 2)))


def _nhwc(t):
  return t.detach().numpy().transpose(0, 2, 3, 1)


def _random_variables(module, seed, *args):
  """Random variables of a Flax module from its shapes (no compile):
  glorot-scale kernels, norm scales and BN variances in [0.5, 1.5],
  u ~ N(0, 0.05), other leaves N(0, 0.1)."""
  shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), *args))
  rs = np.random.RandomState(seed)

  def fill(path, leaf):
    name, shape = path[-1].key, leaf.shape
    if name == 'kernel':
      fan = np.prod(shape[:-2]) * (shape[-2] + shape[-1])
      value = rs.uniform(-1, 1, shape) * np.sqrt(6.0 / fan)
    elif name in ('scale', 'var', 'gamma'):
      value = rs.uniform(0.5, 1.5, shape)
    elif name == 'u':
      value = rs.normal(0.0, 0.05, shape)
    else:  # bias, beta, mean
      value = rs.normal(0.0, 0.1, shape)
    return value.astype(np.float32)

  return jax.tree_util.tree_map_with_path(fill, shapes)


def _load(port, variables):
  port.load_state_dict(folding_t.torch_state_dict_from_flax(variables, port))
  return port


def _flax_train(module, variables, x, collections):
  """(outputs, new collections) of the Flax module with train=True."""
  fn = lambda v, x: module.apply(v, x, train=True, mutable=collections)
  return _compiled(fn, variables, x)(variables, x)


def _state_dict_of(tree):
  return folding_t.torch_tensors_from_flax(tree)


@pytest.mark.parametrize('kernel,strides,fused_pad,use_bias', [
    (3, 1, 1, True),  # the heads and the global context: circular at eval
    (4, 2, 2, True),  # a discriminator group conv
    (1, 1, 0, False),  # a decoder 1x1, SAME
])
def test_spectral_conv_train_matches_jax(kernel, strides, fused_pad,
                                         use_bias):
  """Output (zero padding in training), the stored u, and the kernel
  gradient of a fixed projection of the output: sigma's gradient flows
  through the kernel only (u and v are outside the gradient)."""
  rs = np.random.RandomState(kernel)
  x = rs.normal(size=(2, 8, 16, 5)).astype(np.float32)
  proj = rs.normal(size=(1, 1, 1, 6)).astype(np.float32)
  padding = 'VALID' if fused_pad else 'SAME'
  flax_layer = layers_j.SpectralConv(6, kernel, strides, padding,
                                     use_bias=use_bias, fused_pad=fused_pad,
                                     circular=True)
  variables = _random_variables(flax_layer, kernel, x)

  def loss(params, spectral, x):
    out, new = flax_layer.apply({'params': params, 'spectral': spectral}, x,
                                train=True, mutable=['spectral'])
    return (out * proj).sum(), (out, new['spectral'])

  (_, (ref, ref_spectral)), ref_grads = _compiled(
      jax.value_and_grad(loss, has_aux=True), variables['params'],
      variables['spectral'], x)(variables['params'], variables['spectral'],
                                x)

  port = _load(layers_t.SpectralConv(5, 6, kernel, strides, padding,
                                     use_bias=use_bias, fused_pad=fused_pad,
                                     circular=True, fold=False), variables)
  out = port.train()(_nchw(x))
  (out * _nchw(proj)).sum().backward()
  np.testing.assert_allclose(_nhwc(out), np.asarray(ref), atol=ATOL, rtol=0)
  np.testing.assert_allclose(port.u.numpy(), ref_spectral['u'],
                             atol=STATE_ATOL, rtol=0)
  want = _state_dict_of(ref_grads)['weight'].numpy()
  np.testing.assert_allclose(port.weight.grad.numpy(), want, rtol=0,
                             atol=1e-5 * np.abs(want).max())


def test_spectral_conv_eval_iterates_without_storing():
  """At eval one power iteration from the stored u, nothing stored, and
  circular padding: the JAX layer with train=False."""
  x = np.random.RandomState(5).normal(size=(2, 6, 12, 4)).astype(np.float32)
  flax_layer = layers_j.SpectralConv(3, 3, 1, 'VALID', fused_pad=1,
                                     circular=True)
  variables = _random_variables(flax_layer, 6, x)
  ref = _compiled(lambda v, x: flax_layer.apply(v, x, train=False),
                  variables, x)(variables, x)
  port = _load(layers_t.SpectralConv(4, 3, 3, 1, 'VALID', fused_pad=1,
                                     circular=True, fold=False), variables)
  u = port.u.clone()
  with torch.no_grad():
    out = port.eval()(_nchw(x))
  np.testing.assert_allclose(_nhwc(out), np.asarray(ref), atol=ATOL, rtol=0)
  assert torch.equal(port.u, u)


@pytest.mark.parametrize('kernel,strides,fused_pad', [(7, 2, 3), (3, 1, 1)])
def test_partial_conv_train_zero_pads_and_updates_u(kernel, strides,
                                                    fused_pad):
  """Training pads the features and the mask with zeros (no wrap),
  convolves with the raw kernel and stores the inert u."""
  rs = np.random.RandomState(kernel)
  x = rs.normal(size=(2, 8, 16, 5)).astype(np.float32)
  mask = (rs.rand(2, 8, 16, 1) > 0.4).astype(np.float32)
  flax_layer = layers_j.PartialConv(6, kernel, strides, 'VALID',
                                    spectral_norm=True, fused_pad=fused_pad,
                                    circular=True)
  variables = _random_variables(flax_layer, kernel, x, mask)
  fn = lambda v, x, m: flax_layer.apply(v, x, m, train=True,
                                        mutable=['spectral'])
  (ref, ref_mask), new = _compiled(fn, variables, x, mask)(variables, x, mask)
  port = _load(layers_t.PartialConv(5, 6, kernel, strides, 'VALID',
                                    fused_pad=fused_pad, circular=True,
                                    spectral_norm=True, fold=False),
               variables)
  with torch.no_grad():
    out, new_mask = port.train()(_nchw(x), _nchw(mask))
  np.testing.assert_allclose(_nhwc(out), np.asarray(ref), atol=ATOL, rtol=0)
  np.testing.assert_array_equal(_nhwc(new_mask), np.asarray(ref_mask))
  np.testing.assert_allclose(port.u.numpy(), new['spectral']['u'],
                             atol=STATE_ATOL, rtol=0)


def test_sync_batch_norm_train_matches_flax():
  """Batch mean and biased variance normalise; both running statistics
  move by Flax's r = 0.99 r + 0.01 batch, the variance biased."""
  rs = np.random.RandomState(7)
  x = (rs.normal(size=(3, 5, 7, 4)) * 2 + 0.5).astype(np.float32)
  flax_layer = layers_j.SyncBatchNorm()
  variables = _random_variables(flax_layer, 8, x)
  ref, new = _flax_train(flax_layer, variables, x, ['batch_stats'])
  port = _load(layers_t.SyncBatchNorm(4), variables)
  with torch.no_grad():
    out = port.train()(_nchw(x))
  np.testing.assert_allclose(_nhwc(out), np.asarray(ref), atol=ATOL, rtol=0)
  stats = new['batch_stats']['bn']
  np.testing.assert_allclose(port.running_mean.numpy(), stats['mean'],
                             atol=STATE_ATOL, rtol=0)
  np.testing.assert_allclose(port.running_var.numpy(), stats['var'],
                             atol=STATE_ATOL, rtol=0)


def test_instance_norm_matches_flax():
  rs = np.random.RandomState(9)
  x = (rs.normal(size=(2, 5, 6, 3)) * 3 - 1).astype(np.float32)
  flax_layer = layers_j.InstanceNorm()
  variables = _random_variables(flax_layer, 10, x)
  ref = _compiled(lambda v, x: flax_layer.apply(v, x), variables, x)(
      variables, x)
  port = _load(layers_t.InstanceNorm(3), variables)
  with torch.no_grad():
    out = port(_nchw(x))
  np.testing.assert_allclose(_nhwc(out), np.asarray(ref), atol=ATOL, rtol=0)


@pytest.mark.parametrize('height,width', [(8, 16), (7, 9), (1, 2)])
def test_avg_pool_3x3_stride2_same(height, width):
  """TF's SAME pool: 0 before and 1 after at an even size, the divisor
  counting in-bounds elements only; equal up to the division's ULP."""
  x = np.random.RandomState(height).normal(size=(2, height, width, 3)
                                           ).astype(np.float32)
  ref = np.asarray(layers_j.avg_pool_3x3_stride2_same(x))
  got = _nhwc(layers_t.avg_pool_3x3_stride2_same(_nchw(x)))
  assert got.shape == ref.shape
  np.testing.assert_allclose(got, ref, rtol=2e-7, atol=1e-7)


D_CONFIG = dict(n_dis=2, dis_dims=2, n_layers=3)


def test_discriminator_train_matches_jax():
  """Every map of both scales, in training (u stored) and then at eval
  from the stored u (nothing stored)."""
  x = np.random.RandomState(11).normal(size=(4, 32, 64, 4)).astype(
      np.float32)
  flax_d = disc_j.SNMultiScaleDiscriminator(**D_CONFIG)
  variables = _random_variables(flax_d, 12, x)
  ref, new = _flax_train(flax_d, variables, x, ['spectral'])
  port = _load(disc_t.SNMultiScaleDiscriminator(**D_CONFIG), variables)
  with torch.no_grad():
    maps = port.train()(torch.from_numpy(x))
  for sub_ref, sub in zip(ref, maps):
    assert len(sub) == len(sub_ref) == D_CONFIG['n_layers'] + 1
    for r, m in zip(sub_ref, sub):
      np.testing.assert_allclose(m.numpy(), np.asarray(r), atol=ATOL, rtol=0)
  state = port.state_dict()
  for key, value in _state_dict_of(new['spectral']).items():
    np.testing.assert_allclose(state[key].numpy(), value.numpy(),
                               atol=STATE_ATOL, rtol=0)
  ref_eval = _compiled(lambda v, x: flax_d.apply(v, x, train=False),
                       {**variables, **new}, x)({**variables, **new}, x)
  with torch.no_grad():
    maps = port.eval()(torch.from_numpy(x))
  np.testing.assert_allclose(maps[1][-1].numpy(), np.asarray(ref_eval[1][-1]),
                             atol=ATOL, rtol=0)
  assert all(torch.equal(state[k], v) for k, v in port.state_dict().items())


H = 32
G_CONFIG = dict(gen_dims=2, z_dim=2, resnet_version='tiny')
# In training at this size the bottleneck's BatchNorms normalise over 4
# elements per channel, which amplifies float32 rounding: the port's
# outputs move by some 1e-5 for a 1e-7 relative change of its input, as
# much as it differs from its own float64 run, so atol 2e-4.
G_TRAIN_ATOL = 2e-4


def _cond(seed):
  rs = np.random.RandomState(seed)
  return {
      'proj_image': rs.uniform(0, 1, (2, H, 2 * H, 3)).astype(np.float32),
      'proj_depth': rs.uniform(0, 1, (2, H, 2 * H, 1)).astype(np.float32),
      'proj_mask': (rs.rand(2, H, 2 * H, 1) > 0.3).astype(np.float32),
      'blurred_mask': (rs.rand(2, H, 2 * H, 1) > 0.8).astype(np.float32),
  }


@pytest.fixture(scope='module')
def trained_generators():
  """The JAX and the port's trainable generator after one train-mode
  forward from the same variables: (JAX outputs, JAX new state, port
  outputs, port model, variables, cond)."""
  cond = _cond(13)
  flax_g = gen_j.ResNetGenerator(image_size=H, **G_CONFIG)
  variables = _random_variables(flax_g, 14, cond)
  ref, new = _flax_train(flax_g, variables, cond, ['batch_stats', 'spectral'])
  port = _load(gen_t.ResNetGenerator(spectral_fold=False, **G_CONFIG),
               variables)
  with torch.no_grad():
    outs = port.train()({k: torch.from_numpy(v) for k, v in cond.items()})
  return ref, new, outs, port, variables, cond


def test_generator_train_outputs_match_jax(trained_generators):
  """The 7-output contract in training: zero padding, batch statistics,
  u stored before each spectral conv's output."""
  ref, _, outs, _, _, _ = trained_generators
  assert len(outs) == len(ref) == 7
  for r, o in zip(ref, outs):
    assert tuple(o.shape) == r.shape
    np.testing.assert_allclose(o.numpy(), np.asarray(r), atol=G_TRAIN_ATOL,
                               rtol=0)


def test_generator_train_state_matches_jax(trained_generators):
  """Every BatchNorm running statistic and every u (SpectralConvs and the
  PartialConvs' inert ones) after the train-mode forward."""
  _, new, _, port, _, _ = trained_generators
  want = {**_state_dict_of(new['batch_stats']),
          **_state_dict_of(new['spectral'])}
  state = port.state_dict()
  assert {k for k in state if k.endswith(('.u', 'running_mean',
                                          'running_var'))} == set(want)
  for key, value in want.items():
    np.testing.assert_allclose(state[key].numpy(), value.numpy(),
                               atol=STATE_ATOL, rtol=0, err_msg=key)


def test_unfolded_eval_equals_folded_serving(trained_generators):
  """The trainable generator at eval (circular padding, stored
  statistics, one power iteration per call and nothing stored) equals
  the serving generator loaded with `serving_state_dict`: the same
  float32 ops, so bit-equal."""
  _, _, _, port, _, cond = trained_generators
  serving = gen_t.ResNetGenerator(**G_CONFIG)
  serving.load_state_dict(folding_t.serving_state_dict(port))
  before = {k: v.clone() for k, v in port.state_dict().items()}
  inputs = {k: torch.from_numpy(v) for k, v in cond.items()}
  with torch.no_grad():
    a = port.eval()(inputs)
    b = serving.eval()(inputs)
  for x, y in zip(a, b):
    assert torch.equal(x, y)
  assert all(torch.equal(before[k], v) for k, v in port.state_dict().items())
