"""`layers.epilogue`, what follows each convolution, on the CPU (its plain
body, `layers.epilogue_plain`; tests/test_torch_cuda.py holds the CUDA
kernel to it on the card).

Each case is one that the generator runs, on a convolution's real
output: the layers' composed ops, written out here as the previous
version of the layers composed them, are computed in float32 and rounded
once. For float32 tensors that is the previous version's code itself, so
the plain body equals it bit for bit, in training (batch statistics,
autograd) and at eval, where BatchNorm is Flax's per-channel formula
(held near `F.batch_norm` below). For bfloat16 the plain body equals
the same ops in float32 on the upcast tensors, rounded once.

A train-mode forward of a tiny generator, with and without
rematerialisation, equals the previous version's composition of its
blocks (outputs, gradients and state, bit for bit) and launches no
kernel.
"""

import copy

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from se3ds_torch import tracing
from se3ds_torch.models import folding
from se3ds_torch.models import generator as generator_lib
from se3ds_torch.models import layers

N, H, W = 2, 8, 16


@pytest.fixture(autouse=True, scope='module')
def one_torch_thread():
  """Tiny ops under the suite's parallel workers: one thread each."""
  threads = torch.get_num_threads()
  torch.set_num_threads(1)
  yield
  torch.set_num_threads(threads)


# -- the previous version's ops, composed as its layers composed them -------


def _parent_renormalise(conv, out, window_sum):
  kh, kw = conv.weight.shape[-2:]
  mask_ratio = (kh * kw) / (window_sum + 1e-6)
  update_mask = torch.clamp(window_sum, 0.0, 1.0)
  mask_ratio = mask_ratio * update_mask
  if conv.bias is not None:
    bias = conv.bias.to(out.dtype)[:, None, None]
    out = (out - bias) * mask_ratio + bias
    out = out * update_mask
  else:
    out = out * mask_ratio
  return out, update_mask


def _parent_bias(conv, out):
  if conv.bias is None:
    return out
  return out + conv.bias.to(out.dtype)[:, None, None]


def _parent_bn(bn, x):
  """Training: the module's batch statistics. Eval: Flax's formula."""
  if bn.training:
    return bn(x)
  mul = torch.sqrt(bn.running_var + layers.BN_EPSILON).reciprocal() * (
      bn.weight)
  return ((x - bn.running_mean[:, None, None]) * mul[:, None, None]
          + bn.bias[:, None, None])


# -- the cases --------------------------------------------------------------


def _randomise(module, seed):
  g = torch.Generator().manual_seed(seed)
  for name, p in sorted(module.named_parameters()):
    with torch.no_grad():
      p.copy_(torch.randn(p.shape, generator=g) * 0.3)
  for m in module.modules():
    if isinstance(m, layers.SyncBatchNorm):
      m.running_mean.copy_(torch.randn(m.running_mean.shape, generator=g))
      m.running_var.copy_(
          torch.rand(m.running_var.shape, generator=g) * 1.5 + 0.25)


def _nhwc_memory(x, dtype):
  return x.to(dtype).contiguous(memory_format=torch.channels_last)


def _partial(c_in, c_out, k, stride, bias):
  return layers.PartialConv(c_in, c_out, k, stride, 'VALID' if k > 1 else
                            'SAME', use_bias=bias, fused_pad=k // 2,
                            circular=k > 1)


class _Case(torch.nn.Module):
  """Modules and inputs of one case; `new()` calls the epilogue as the
  layers do, `parent()` composes the previous version's ops in float32
  on the same convolution outputs."""

  def __init__(self, name, dtype, seed=0, c_in=8, c=16, shape=(N, H, W)):
    super().__init__()
    self.name, self.dtype = name, dtype
    n, h, w = shape
    bn = lambda width=c: layers.SyncBatchNorm(width)
    if name.startswith('partial'):
      _, k, stride, bias = name.split('_')
      self.conv = _partial(c_in, c, int(k[0]), int(stride[1]), bias == 'bias')
      self.bn = bn()
    elif name == 'bottleneck_downsample':
      self.conv = _partial(c_in, c, 1, 1, True)
      self.bn = bn()
      self.res = _partial(c_in, c, 1, 1, False)
      self.res_bn = bn()
    elif name == 'bottleneck_identity':
      self.conv = _partial(c, c, 1, 1, True)
      self.bn = bn()
    elif name == 'trans_block_upsample':
      self.conv = layers.Conv2DTranspose(c_in, c, 3, 2, 'SAME',
                                         use_bias=False)
      self.bn = bn()
      self.res = layers.Conv2DTranspose(c_in, c, 2, 2, 'VALID',
                                        use_bias=False)
      self.res_bn = bn()
    elif name == 'conv_bn_relu':
      self.conv = layers.SpectralConv(c_in, c, 3, 1, 'VALID', use_bias=False,
                                      fused_pad=1, circular=True)
      self.bn = bn()
    elif name == 'agent_skip_add':
      self.conv = layers.PartialConv(c_in, c, 1, 1, 'SAME', use_bias=False)
      self.bn = bn()
    elif name == 'chain_leaky03_next_bn':
      self.conv = layers.SpectralConv(c_in, c, 3, 1, 'VALID', fused_pad=1,
                                      circular=True)
      self.post = bn()
    elif name == 'upc_bias_bn_leaky02':
      self.conv = layers.SpectralConv(c_in, c, 1, 1, 'SAME')
      self.bn = bn()
    elif name == 'transpose_bias':
      self.conv = layers.Conv2DTranspose(c_in, 3, 2, 2, 'SAME')
    elif name == 'head_last_1ch':
      self.conv = layers.SpectralConv(c_in, 1, 3, 1, 'VALID', fused_pad=1,
                                      circular=True)
    elif name == 'bn_only':
      self.bn = bn(c_in)
    else:
      raise ValueError(name)
    for m in self.modules():
      if isinstance(m, layers.SyncBatchNorm):
        m.weight.data.uniform_(0.5, 1.5)
    _randomise(self, seed)
    layers.store_served_kernels(self, dtype)
    g = torch.Generator().manual_seed(seed + 1)
    width = c if name == 'bottleneck_identity' else c_in
    self.register_buffer(
        'x', _nhwc_memory(torch.randn(n, width, h, w, generator=g), dtype))
    self.register_buffer(
        'mask', (torch.rand(n, 1, h, w, generator=g) > 0.4).to(dtype))
    self.register_buffer('skip', None)
    if name == 'agent_skip_add':
      self.skip = _nhwc_memory(torch.randn(n, c, h, w, generator=g), dtype)

  def _outputs(self):
    """The convolutions' outputs the epilogue takes: (a, b) ConvOutput
    fields without the modules' ops."""
    with torch.no_grad():
      conv = getattr(self, 'conv', None)
      if isinstance(conv, layers.PartialConv):
        mask = None if self.name == 'agent_skip_add' else self.mask
        a = conv.convolve(self.x, mask)
      elif conv is not None:
        a = (conv.convolve(self.x), None)
      else:
        a = (self.x, None)
      b = None
      if isinstance(getattr(self, 'res', None), layers.PartialConv):
        b = self.res.convolve(self.x, self.mask)
      elif getattr(self, 'res', None) is not None:
        b = (self.res.convolve(self.x), None)
    return a, b

  def new(self, epilogue=layers.epilogue):
    """The case's epilogue call as the layers make it (`epilogue`, or
    its plain body `layers.epilogue_plain`)."""
    (out, ws), b = self._outputs()
    x = layers.ConvOutput(out, getattr(self, 'conv', None), ws,
                          getattr(self, 'bn', None))
    name = self.name
    if name == 'bottleneck_identity':
      return epilogue(x, layers.RELU, self.x)
    if b is not None:
      return epilogue(x, layers.RELU, layers.ConvOutput(
          b[0], self.res, b[1], self.res_bn))
    if name == 'agent_skip_add':
      return epilogue(x, layers.RELU, self.skip, after_act=True)
    if name == 'chain_leaky03_next_bn':
      return epilogue(x, 0.3, post_bn=self.post)
    if name == 'upc_bias_bn_leaky02':
      return epilogue(x, 0.2)
    if name in ('transpose_bias', 'head_last_1ch', 'bn_only'):
      return epilogue(x)
    return epilogue(x, layers.RELU)

  def parent(self):
    (out, ws), b = self._outputs()
    out = out.float()
    update_mask = None
    conv = getattr(self, 'conv', None)
    if ws is not None:
      out, update_mask = _parent_renormalise(conv, out, ws.float())
    elif conv is not None:
      out = _parent_bias(conv, out)
    name = self.name
    if name == 'upc_bias_bn_leaky02':
      out = F.leaky_relu(_parent_bn(self.bn, out), negative_slope=0.2)
    elif name == 'chain_leaky03_next_bn':
      out = _parent_bn(self.post, F.leaky_relu(out, negative_slope=0.3))
    elif name == 'agent_skip_add':
      out = self.skip.float() + F.relu(_parent_bn(self.bn, out))
    elif name in ('transpose_bias', 'head_last_1ch'):
      pass
    elif name == 'bn_only':
      out = _parent_bn(self.bn, out)
    else:
      out = _parent_bn(self.bn, out)
      if b is not None:
        res = b[0].float()
        if b[1] is not None:
          res = _parent_renormalise(self.res, res, b[1].float())[0]
        out = out + _parent_bn(self.res_bn, res)
      elif name == 'bottleneck_identity':
        out = out + self.x.float()
      out = F.relu(out)
    return (out.to(self.dtype),
            None if update_mask is None else update_mask.to(self.dtype))


CASES = ['partial_1x1_s1_bias', 'partial_3x3_s1_bias', 'partial_3x3_s2_bias',
         'partial_1x1_s2_nobias', 'partial_3x3_s1_nobias',
         'bottleneck_downsample', 'bottleneck_identity',
         'trans_block_upsample', 'conv_bn_relu', 'agent_skip_add',
         'chain_leaky03_next_bn', 'upc_bias_bn_leaky02', 'transpose_bias',
         'head_last_1ch', 'bn_only']


def _equal(got, want):
  assert got[0].dtype == want[0].dtype and torch.equal(got[0], want[0])
  assert (got[1] is None) == (want[1] is None)
  if got[1] is not None:
    assert got[1].dtype == want[1].dtype and torch.equal(got[1], want[1])


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16],
                         ids=['float32', 'bfloat16'])
@pytest.mark.parametrize('name', CASES)
def test_eval_epilogue_equals_the_composed_ops(name, dtype):
  """Eval, no gradient: the plain body on the CPU equals the composed ops
  in float32, rounded once (for float32, the composed ops themselves)."""
  case = _Case(name, dtype).eval()
  with torch.no_grad():
    _equal(case.new(), case.parent())


@pytest.mark.parametrize('name', CASES)
def test_train_epilogue_equals_the_composed_ops(name):
  """Training, float32: the same ops as the previous version, batch
  statistics included, so the same values, running statistics and
  gradients."""
  case = _Case(name, torch.float32).train()
  twin = copy.deepcopy(case)
  params = [p for p in case.parameters()]
  got = case.new()
  want = twin.parent()
  _equal(got, want)
  grads = torch.autograd.grad(got[0].square().sum(), params,
                              allow_unused=True)
  want_grads = torch.autograd.grad(want[0].square().sum(),
                                   list(twin.parameters()), allow_unused=True)
  for g, w in zip(grads, want_grads):
    assert (g is None) == (w is None)
    if g is not None:
      assert torch.equal(g, w)
  for (name_, a), (_, b) in zip(case.named_buffers(), twin.named_buffers()):
    assert torch.equal(a, b), name_


def test_eval_batchnorm_is_flax_formula_near_f_batch_norm():
  """Eval BatchNorm is Flax's per-channel formula, (x - mean) * (rsqrt(var
  + eps) * weight) + bias; it stays within float32 rounding of
  `F.batch_norm`, the previous version's eval path."""
  bn = layers.SyncBatchNorm(64).eval()
  _randomise(bn, 3)
  bn.weight.data.uniform_(0.5, 1.5)
  x = torch.randn(4, 64, 8, 16, generator=torch.Generator().manual_seed(4))
  with torch.no_grad():
    got = bn(x)
    want = F.batch_norm(x, bn.running_mean, bn.running_var, bn.weight,
                        bn.bias, training=False, eps=layers.BN_EPSILON)
  torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


def test_cpu_eval_launches_no_kernel():
  case = _Case('bottleneck_downsample', torch.float32).eval()
  before = [tracing.count(n) for n in ('epilogue.launches',
                                       'generator.fused_convs')]
  with torch.no_grad():
    case.new()
  assert [tracing.count(n) for n in ('epilogue.launches',
                                     'generator.fused_convs')] == before


# -- the generator in training against the previous version's blocks ------


def _parent_partial(conv, x, mask=None):
  return _parent_renormalise(conv, *conv.convolve(x, mask))


def _parent_conv(conv, x):
  return _parent_bias(conv, conv.convolve(x))


def _parent_bottleneck(b, x, mask):
  out, update_mask = _parent_partial(b.conv1, x, mask)
  out = F.relu(b.act1_bn(out))
  out, update_mask = _parent_partial(b.conv2, out, update_mask)
  out = F.relu(b.act2_bn(out))
  out, update_mask = _parent_partial(b.conv3, out, update_mask)
  out = b.act3_bn(out)
  residual = x
  if b.downsample is not None:
    residual, _ = _parent_partial(b.downsample, x, mask)
    residual = b.ds_norm(residual)
  return F.relu(out + residual), update_mask


def _parent_trans_block(b, x):
  out = F.relu(b.main_bn1(_parent_conv(b.main_conv1, x)))
  up = b.main_convt if hasattr(b, 'main_convt') else b.main_conv2
  out = b.main_bn2(_parent_conv(up, out))
  residual = x
  if b.has_upsample:
    res = b.up_convt if hasattr(b, 'up_convt') else b.up_conv
    residual = b.up_bn(_parent_conv(res, x))
  return F.relu(out + residual)


def _parent_trans_stack(stack, x):
  for i in range(stack.num_blocks):
    x = _parent_trans_block(getattr(stack, f'block{i}'), x)
  return x


def _parent_chain(chain, x):
  for i in range(chain.num_convs):
    x = _parent_conv(getattr(chain, f'conv{i}'), getattr(chain, f'bn{i}')(x))
    if i < chain.num_convs - 1:
      x = F.leaky_relu(x, negative_slope=0.3)
  return x


def _parent_decoder(dec, x, skip):
  def agent(name, t):
    out, _ = _parent_partial(getattr(dec, name), t)
    return F.relu(getattr(dec, f'{name}_bn')(out))

  out = F.leaky_relu(dec.upc_bn(_parent_conv(dec.upc_conv, x)),
                     negative_slope=0.2)
  out = agent('agent4', layers.upsample_2x_nearest(out))
  for i in range(4):
    out = _parent_trans_stack(getattr(dec, f'deconv{i + 1}'), out)
    out = out + agent(f'agent{3 - i}', skip[3 - i])
  out = _parent_trans_stack(dec.final_conv, out)
  return _parent_conv(dec.final_deconv, out)


def _parent_generator(gen, cond):
  """rgb and depth of `gen(cond)` in training, as the previous version's
  blocks composed them."""
  nchw = lambda t: t.permute(0, 3, 1, 2).contiguous()
  x = nchw(torch.cat([cond['proj_image'], cond['proj_depth'],
                      cond['blurred_mask']], dim=-1))
  mask = nchw(cond['proj_mask'])
  enc = gen.encoder
  out, update_mask = _parent_partial(enc.conv1, x, mask)
  b1 = F.relu(enc.act1_bn(out))
  out = layers.max_pool_2x2_same(b1)
  update_mask = layers.max_pool_2x2_same(update_mask)
  skip = [b1]
  for s in range(1, 5):
    stack = getattr(enc, f'stack{s}')
    for i in range(stack.num_blocks):
      out, update_mask = _parent_bottleneck(getattr(stack, f'block{i}'), out,
                                            update_mask)
    skip.append(out)
  out, _ = _parent_partial(enc.final_conv, out, update_mask)
  hidden = _parent_chain(gen.global_context, F.relu(enc.final_bn(out)))
  rgb = _parent_chain(gen.rgb_conv,
                      _parent_decoder(gen.decoder, hidden, skip[:4]))
  depth = _parent_chain(gen.depth_conv,
                        _parent_decoder(gen.depth_decoder, hidden, skip[:4]))
  nhwc = lambda t: t.permute(0, 2, 3, 1).float()
  return [torch.clamp(nhwc(depth), 0.0, 1.0), (torch.tanh(nhwc(rgb)) + 1) / 2]


@pytest.mark.parametrize('remat', [False, True], ids=['stored', 'remat'])
def test_train_generator_equals_the_parent_blocks(remat):
  gen = generator_lib.ResNetGenerator(gen_dims=4, z_dim=2,
                                      resnet_version='tiny',
                                      spectral_fold=False)
  folding.init_random_(gen, torch.Generator().manual_seed(5))
  gen.train()
  twin = copy.deepcopy(gen)
  rs = np.random.RandomState(6)
  cond = {k: torch.from_numpy(rs.rand(2, 32, 64, c).astype(np.float32))
          for k, c in (('proj_image', 3), ('proj_depth', 1),
                       ('blurred_mask', 1))}
  cond['proj_mask'] = torch.from_numpy(
      (rs.rand(2, 32, 64, 1) > 0.3).astype(np.float32))
  before = tracing.count('epilogue.launches')
  with layers.rematerialise(remat):
    outs = gen(cond)
    got = [outs[3], outs[6]]
    grads = torch.autograd.grad(sum(t.square().sum() for t in got),
                                list(gen.parameters()))
  want = _parent_generator(twin, cond)
  want_grads = torch.autograd.grad(sum(t.square().sum() for t in want),
                                   list(twin.parameters()))
  assert tracing.count('epilogue.launches') == before
  for g, w in zip(got, want):
    assert torch.equal(g, w)
  names = [name for name, _ in gen.named_parameters()]
  for name, g, w in zip(names, grads, want_grads):
    assert torch.equal(g, w), name
  for (name, a), (_, b) in zip(gen.named_buffers(), twin.named_buffers()):
    assert torch.equal(a, b), name
