"""Port parity: generator layers against the Flax layers, float32 CPU.

Tolerance for convolution outputs: atol 1e-5 (two CPU convolution
libraries sum in different orders; activations are O(1)). Padding,
pooling and mask propagation are exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from se3ds_torch.models import folding as folding_t
from se3ds_torch.models import generator as generator_t
from se3ds_torch.models import layers as layers_t
from se3ds_tpu.models import generator as generator_j
from se3ds_tpu.models import layers as layers_j

ATOL = 1e-5


def _nchw(x):
  return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _nhwc(t):
  return t.detach().numpy().transpose(0, 2, 3, 1)


def _flax_variables(module, seed, *args):
  """Random variables for a Flax module, from its shapes (no compile):
  glorot-scale kernels, BN statistics away from the identity."""
  shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), *args))
  rs = np.random.RandomState(seed)

  def fill(path, leaf):
    name, shape = path[-1].key, leaf.shape
    if name == 'kernel':
      fan = np.prod(shape[:-2]) * (shape[-2] + shape[-1])
      value = rs.uniform(-1, 1, shape) * np.sqrt(6.0 / fan)
    elif name in ('scale', 'var'):
      value = rs.uniform(0.5, 1.5, shape)
    else:  # bias, mean, u
      value = rs.normal(0.0, 0.1, shape)
    return value.astype(np.float32)

  return jax.tree_util.tree_map_with_path(fill, shapes)


def _flax_apply(module, variables, *args):
  return jax.jit(module.apply)(variables, *args)


def _hwio_to_oihw(k):
  return folding_t.torch_kernel_from_flax(k, transposed=False)


@pytest.mark.parametrize('kernel,strides,fused_pad,use_bias', [
    (7, 2, 3, True),  # the encoder's first conv: circular pad, stride 2
    (3, 1, 1, True),  # a bottleneck conv2
    (1, 1, 0, False),  # a decoder agent: 1x1, no bias, SAME
])
def test_partial_conv_uses_raw_kernel(kernel, strides, fused_pad, use_bias):
  """PartialSpectralConv convolves with the RAW kernel (reference bug):
  the port, given the raw kernel, matches the live Flax layer."""
  rs = np.random.RandomState(kernel)
  x = rs.normal(size=(2, 8, 16, 5)).astype(np.float32)
  mask = (rs.rand(2, 8, 16, 1) > 0.4).astype(np.float32)
  flax_layer = layers_j.PartialConv(
      6, kernel_size=kernel, strides=strides,
      padding='VALID' if fused_pad else 'SAME', use_bias=use_bias,
      spectral_norm=True, fused_pad=fused_pad, circular=True)
  variables = _flax_variables(flax_layer, kernel, x, mask)
  assert 'u' in variables['spectral']
  params = variables['params']
  ref_out, ref_mask = _flax_apply(flax_layer, variables, x, mask)

  port = layers_t.PartialConv(5, 6, kernel, strides,
                              'VALID' if fused_pad else 'SAME',
                              use_bias=use_bias, fused_pad=fused_pad,
                              circular=True)
  port.weight.data = _hwio_to_oihw(params['kernel'])
  if use_bias:
    port.bias.data = torch.from_numpy(params['bias'])
  out, new_mask = port.eval()(_nchw(x), _nchw(mask))
  np.testing.assert_allclose(_nhwc(out), np.asarray(ref_out), atol=ATOL,
                             rtol=0)
  np.testing.assert_array_equal(_nhwc(new_mask), np.asarray(ref_mask))


@pytest.mark.parametrize('kernel,padding', [(3, 'SAME'), (2, 'VALID'),
                                            (2, 'SAME')])
def test_conv_transpose_layout_and_flip(kernel, padding):
  """Flax ConvTranspose (kh, kw, in, out) -> torch (in, out, kh, kw) with
  a spatial flip, and lax.conv_transpose's SAME/VALID geometry."""
  x = np.random.RandomState(20 + kernel).normal(size=(2, 5, 7, 4)).astype(
      np.float32)
  flax_layer = layers_j.Conv2DTranspose(3, kernel_size=kernel, strides=2,
                                        padding=padding, use_bias=True)
  variables = _flax_variables(flax_layer, kernel, x)
  kern = variables['params']['convt']['kernel']
  bias = variables['params']['convt']['bias']
  ref = _flax_apply(flax_layer, variables, x)

  port = layers_t.Conv2DTranspose(4, 3, kernel, 2, padding)
  port.weight.data = folding_t.torch_kernel_from_flax(kern, transposed=True)
  port.bias.data = torch.from_numpy(bias)
  out = port(_nchw(x))
  assert _nhwc(out).shape == np.asarray(ref).shape
  np.testing.assert_allclose(_nhwc(out), np.asarray(ref), atol=ATOL, rtol=0)


@pytest.mark.parametrize('pad,width', [(1, 16), (3, 16), (5, 3)])
def test_circular_padding_exact(pad, width):
  """Height zero-padded, width wrapped; a margin wider than the pano
  wraps around it more than once (JAX `wrap_width`, which the JAX
  generator uses at such widths)."""
  x = np.arange(2 * 4 * width * 3, dtype=np.float32).reshape(2, 4, width, 3)
  if pad <= width:
    ref = layers_j.pad2d(jnp.asarray(x), pad, circular_pad=True, train=False)
    np.testing.assert_array_equal(
        _nhwc(layers_t.pad2d(_nchw(x), pad, circular_pad=True)),
        np.asarray(ref))
  ref = layers_j.wrap_width(jnp.asarray(x), pad)
  np.testing.assert_array_equal(_nhwc(layers_t.wrap_width(_nchw(x), pad)),
                                np.asarray(ref))


@pytest.mark.parametrize('k,s,fused_pad,padding', [
    (7, 2, 3, 'VALID'), (3, 2, 1, 'VALID'), (1, 2, 0, 'SAME'),
    (3, 2, 0, 'SAME')])
def test_mask_window_sum_exact(k, s, fused_pad, padding):
  mask = (np.random.RandomState(k * s).rand(2, 9, 18, 1) > 0.5).astype(
      np.float32)
  ref = layers_j.mask_window_sum(jnp.asarray(mask), k, k, s,
                                 fused_pad=fused_pad, circular=True,
                                 padding=padding)
  got = layers_t.mask_window_sum(_nchw(mask), k, k, s, fused_pad=fused_pad,
                                 circular=True, padding=padding)
  np.testing.assert_array_equal(_nhwc(got), np.asarray(ref))


@pytest.mark.parametrize('layout', [torch.contiguous_format,
                                    torch.channels_last])
def test_pool_and_upsample_exact(layout):
  """Exact in either memory layout; the upsample equals the
  `repeat_interleave` form and returns its input's layout."""
  x = np.random.RandomState(3).normal(size=(2, 7, 9, 3)).astype(np.float32)
  t = _nchw(x).contiguous(memory_format=layout)
  np.testing.assert_array_equal(
      _nhwc(layers_t.max_pool_2x2_same(t)),
      np.asarray(layers_j.max_pool_2x2_same(jnp.asarray(x))))
  up = layers_t.upsample_2x_nearest(t)
  np.testing.assert_array_equal(
      _nhwc(up), np.asarray(layers_j.upsample_2x_nearest(jnp.asarray(x))))
  assert torch.equal(
      up, t.repeat_interleave(2, dim=-2).repeat_interleave(2, dim=-1))
  assert up.is_contiguous(memory_format=layout)


def _load_chain(port, params, stats):
  """Loads a Flax OutputHead/GlobalContext (folded form) into the port."""
  for name, p in params.items():
    if name.startswith('conv'):
      getattr(port, name).weight.data = _hwio_to_oihw(p['kernel'])
      getattr(port, name).bias.data = torch.from_numpy(np.asarray(p['bias']))
    else:
      bn = getattr(port, name)
      bn.weight.data = torch.from_numpy(np.asarray(p['bn']['scale']))
      bn.bias.data = torch.from_numpy(np.asarray(p['bn']['bias']))
      bn.running_mean.data = torch.from_numpy(
          np.asarray(stats[name]['bn']['mean']))
      bn.running_var.data = torch.from_numpy(
          np.asarray(stats[name]['bn']['var']))


@pytest.mark.parametrize('which', ['head', 'context'])
def test_leaky_relu_slope_03_in_heads_and_context(which):
  """Keras LeakyReLU() slope 0.3 in the output heads and the global
  context (the decoder's upc uses 0.2; the generator test covers it).
  Inputs are mostly negative so the slope dominates the output."""
  x = (np.random.RandomState(30).normal(size=(1, 4, 12, 8)) - 1.5).astype(
      np.float32)
  if which == 'head':
    flax_mod = generator_j.OutputHead(8, 3, circular_pad=True, fold=True)
    port = generator_t.OutputHead(8, 3, circular_pad=True)
  else:
    flax_mod = generator_j.GlobalContext(2, circular_pad=True, fold=True)
    port = generator_t.GlobalContext(2, circular_pad=True)
  variables = _flax_variables(flax_mod, 31, x)
  ref = _flax_apply(flax_mod, variables, x)
  _load_chain(port, variables['params'], variables['batch_stats'])
  np.testing.assert_allclose(_nhwc(port.eval()(_nchw(x))), np.asarray(ref),
                             atol=ATOL, rtol=0)
