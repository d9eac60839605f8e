"""Plain PyTorch reference of the SE3DS generator, as it serves and trains.

A frozen copy of the architecture of google-research/se3ds's
ResNetGenerator: a ResNet encoder of partial convolutions over the
guidance RGB-D and its mask, a 4-conv spectral global context, two
decoders (RGB, depth) with partial-conv skip agents, and two 3-conv
output heads. Serving: width-circular padding, BatchNorm on stored
statistics, spectral kernels divided by sigma from one power iteration
at load (`load_flax`). Training (`Numerics.train`): zero padding,
BatchNorm on the batch's statistics, spectral kernels divided by sigma
at each forward (`prepare`). NCHW inside, NHWC at the boundary, float32,
no kernel of the program.

Module names follow the Flax variable paths of the JAX package, which
are also the program's names, so one weight tree in the Flax layout
(`weights.py`) loads into both. `Numerics` also switches what the
benchmark needs and the models never do: `calibrate` records each output
head's (mean, std) before its activation (read once, when the benchmark
makes the weights); `fp8` and `bf16` round each convolution's operands
to a lower precision (the controls the correctness limits must fail);
`checkpoint` recomputes each block in the backward pass to fit one card.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils import checkpoint as checkpoint_lib

ENCODER_BLOCKS = {'tiny': (1, 1, 1, 1), '50': (3, 4, 6, 3),
                  '101': (3, 4, 23, 3), '152': (3, 8, 36, 3)}
DECODER_BLOCKS = {'tiny': (1, 1, 1, 1), '50': (6, 4, 3, 3),
                  '101': (23, 4, 3, 3), '152': (36, 8, 3, 3)}
BN_EPSILON = 1e-3
SPECTRAL_EPSILON = 1e-10
FP8_MAX = 448.0


@dataclasses.dataclass
class Numerics:
  calibrate: bool = False
  fp8: bool = False
  # Training: zero padding, BatchNorm on the batch's statistics, spectral
  # kernels divided by sigma from `u` at each call (`prepare`).
  train: bool = False
  bf16: bool = False        # convolutions in bfloat16 (a control)
  checkpoint: bool = False  # recompute each block in the backward pass
  # Under `calibrate`: (mean, std) of each output head before its
  # activation, {'rgb': ..., 'depth': ...}.
  heads: Optional[Dict[str, Tuple[torch.Tensor, torch.Tensor]]] = None


def _fp8(t: torch.Tensor) -> torch.Tensor:
  scale = torch.clamp(t.abs().amax(), min=1e-30) / FP8_MAX
  return (t / scale).to(torch.float8_e4m3fn).to(t.dtype) * scale


def _drop_low_bits(t: torch.Tensor) -> torch.Tensor:
  return (t.float().contiguous().view(torch.int32) & -65536).view(
      torch.float32)


class _BFloat16(torch.autograd.Function):
  """float32 kept to bfloat16's 8 significant bits by dropping the low
  16, as tensor cores drop the low 13 of a float32 operand for TF32 (the
  configuration's rounding, three bits shorter); the gradient that flows
  back through it is kept to 8 bits the same way."""

  @staticmethod
  def forward(ctx, t):
    return _drop_low_bits(t)

  @staticmethod
  def backward(ctx, grad):
    return _drop_low_bits(grad)


def _operands(numerics: Numerics, x, weight):
  """A convolution's operands in the precision `numerics` asks for (the
  products then exact in float32, as on tensor cores)."""
  if numerics.fp8:
    return _fp8(x), _fp8(weight)
  if numerics.bf16:
    return _BFloat16.apply(x), _BFloat16.apply(weight)
  return x, weight


def _result(numerics: Numerics, out: torch.Tensor) -> torch.Tensor:
  """A convolution's output as the precision keeps it."""
  out = out.float()
  return _BFloat16.apply(out) if numerics.bf16 else out


def segment(numerics: Numerics, fn, *args):
  """`fn(*args)`, recomputed in the backward pass under `checkpoint`
  (the blocks hold no state that a recompute would change)."""
  if numerics.checkpoint and torch.is_grad_enabled():
    return checkpoint_lib.checkpoint(fn, *args, use_reentrant=False)
  return fn(*args)


def _same_pads(size: int, k: int, s: int) -> Tuple[int, int]:
  out = -(-size // s)
  total = max((out - 1) * s + k - size, 0)
  return total // 2, total - total // 2


def _wrap_width(x: torch.Tensor, margin: int) -> torch.Tensor:
  width = x.shape[-1]
  if margin <= width:
    return torch.cat([x[..., -margin:], x, x[..., :margin]], dim=-1)
  idx = torch.arange(-margin, width + margin, device=x.device) % width
  return x.index_select(-1, idx)


def _pad(x: torch.Tensor, p: int, circular: bool) -> torch.Tensor:
  """Zero rows above and below; columns wrapped, or zeros."""
  if p == 0:
    return x
  if circular:
    return _wrap_width(F.pad(x, (0, 0, p, p)), p)
  return F.pad(x, (p, p, p, p))


def _pad_for_window(x, kh, kw, strides, padding, fused_pad, circular):
  if fused_pad:
    return _pad(x, fused_pad, circular)
  if padding == 'VALID':
    return x
  top, bottom = _same_pads(x.shape[-2], kh, strides[0])
  left, right = _same_pads(x.shape[-1], kw, strides[1])
  return F.pad(x, (left, right, top, bottom))


class Conv(nn.Module):
  """Conv2D with Keras defaults and TF padding. `spectral` marks the
  kernels divided by sigma: once at load for serving (`fold`), at each
  call in training (`prepare`). `inert_u` marks a partial conv whose
  trainable form keeps a power-iteration state it never uses."""

  def __init__(self, numerics: Numerics, in_f: int, out_f: int, k: int,
               stride: int = 1, padding: str = 'SAME', use_bias: bool = True,
               fused_pad: int = 0, circular: bool = False,
               spectral: bool = False, inert_u: bool = False):
    super().__init__()
    self.numerics = numerics
    self.strides = (stride, stride)
    self.padding = padding
    self.fused_pad = fused_pad
    self.circular = circular
    self.spectral = spectral
    self.inert_u = inert_u
    self.weight = nn.Parameter(torch.empty(out_f, in_f, k, k))
    self.bias = nn.Parameter(torch.zeros(out_f)) if use_bias else None
    self.register_buffer('u', None)
    self.prepared = None

  @property
  def wraps(self) -> bool:
    return self.circular and not self.numerics.train

  def conv(self, x: torch.Tensor) -> torch.Tensor:
    """The convolution. A zero pad is the convolution's own (as JAX pads
    and counts it); a wrapped one, and TF's odd SAME row and column, are
    padded here."""
    weight = self.weight if self.prepared is None else self.prepared
    x, weight = _operands(self.numerics, x, weight)
    kh, kw = weight.shape[-2:]
    pad = (0, 0)
    if self.fused_pad and self.wraps:
      x = _pad(x, self.fused_pad, True)
    elif self.fused_pad:
      pad = (self.fused_pad, self.fused_pad)
    elif self.padding == 'SAME':
      top, bottom = _same_pads(x.shape[-2], kh, self.strides[0])
      left, right = _same_pads(x.shape[-1], kw, self.strides[1])
      if bottom > top or right > left:
        x = F.pad(x, (0, right - left, 0, bottom - top))
      pad = (top, left)
    return _result(self.numerics,
                   F.conv2d(x, weight, stride=self.strides, padding=pad))

  def forward(self, x):
    out = self.conv(x)
    return out if self.bias is None else out + self.bias[:, None, None]


class PartialConv(Conv):
  """Partial convolution: the masked input, renormalised by the share of
  the window the mask covers; returns (out, update_mask)."""

  def forward(self, x, mask=None):
    if mask is None:
      mask = torch.ones_like(x[:, :1])
    kh, kw = self.weight.shape[-2:]
    if kh == 1 and kw == 1 and not self.fused_pad:
      window = mask[:, :, ::self.strides[0], ::self.strides[1]]
    else:
      window = F.avg_pool2d(
          _pad_for_window(mask, kh, kw, self.strides, self.padding,
                          self.fused_pad, self.wraps),
          (kh, kw), stride=self.strides, divisor_override=1)
    out = self.conv(x * mask)
    ratio = (kh * kw) / (window + 1e-6)
    update = torch.clamp(window, 0.0, 1.0)
    ratio = ratio * update
    if self.bias is None:
      return out * ratio, update
    bias = self.bias[:, None, None]
    return ((out - bias) * ratio + bias) * update, update


class ConvTranspose(nn.Module):
  """Transposed conv with `jax.lax.conv_transpose`'s output geometry; the
  weight is PyTorch's (in, out, kh, kw), already flipped."""

  def __init__(self, numerics: Numerics, in_f: int, out_f: int, k: int,
               stride: int, padding: str, use_bias: bool = True):
    super().__init__()
    self.numerics = numerics
    self.stride = stride
    self.padding = padding
    self.weight = nn.Parameter(torch.empty(in_f, out_f, k, k))
    self.bias = nn.Parameter(torch.zeros(out_f)) if use_bias else None

  def _pads(self, k: int) -> Tuple[int, int]:
    s = self.stride
    if self.padding == 'SAME':
      pad_len = k + s - 2
      before = k - 1 if s > k - 1 else -(-pad_len // 2)
    else:
      pad_len = k + s - 2 + max(k - s, 0)
      before = k - 1
    return before, pad_len - before

  def forward(self, x):
    x, weight = _operands(self.numerics, x, self.weight)
    k = weight.shape[-1]
    out = _result(self.numerics,
                  F.conv_transpose2d(x, weight, stride=self.stride))
    before, after = self._pads(k)
    crop = [before - (k - 1), after - (k - 1)]
    out = F.pad(out, crop + crop)
    return out if self.bias is None else out + self.bias[:, None, None]


class BatchNorm(nn.Module):
  """BatchNorm, eps 1e-3: on stored statistics, or in training on the
  batch's (the biased variance)."""

  def __init__(self, numerics: Numerics, features: int):
    super().__init__()
    self.numerics = numerics
    self.weight = nn.Parameter(torch.ones(features))
    self.bias = nn.Parameter(torch.zeros(features))
    self.register_buffer('running_mean', torch.zeros(features))
    self.register_buffer('running_var', torch.ones(features))

  def forward(self, x):
    if self.numerics.train:
      return F.batch_norm(x, None, None, self.weight, self.bias,
                          training=True, eps=BN_EPSILON)
    return F.batch_norm(x, self.running_mean, self.running_var, self.weight,
                        self.bias, training=False, eps=BN_EPSILON)


def _max_pool(x):
  h, w = x.shape[-2:]
  if h % 2 or w % 2:
    x = F.pad(x, (0, w % 2, 0, h % 2), value=float('-inf'))
  return F.max_pool2d(x, 2, 2)


def _upsample(x):
  return x.repeat_interleave(2, dim=-2).repeat_interleave(2, dim=-1)


class Bottleneck(nn.Module):

  def __init__(self, nm, in_f, filters, strides, has_downsample):
    super().__init__()
    self.numerics = nm
    self.conv1 = PartialConv(nm, in_f, filters, 1, 1, 'SAME', inert_u=True)
    self.act1_bn = BatchNorm(nm, filters)
    self.conv2 = PartialConv(nm, filters, filters, 3, strides, 'VALID',
                             fused_pad=1, circular=True, inert_u=True)
    self.act2_bn = BatchNorm(nm, filters)
    self.conv3 = PartialConv(nm, filters, 4 * filters, 1, 1, 'SAME',
                             inert_u=True)
    self.act3_bn = BatchNorm(nm, 4 * filters)
    if has_downsample:
      self.downsample = PartialConv(nm, in_f, 4 * filters, 1, strides, 'SAME',
                                    use_bias=False, inert_u=True)
      self.ds_norm = BatchNorm(nm, 4 * filters)
    else:
      self.downsample = None

  def forward(self, x, mask):
    out, update = self.conv1(x, mask)
    out = F.relu(self.act1_bn(out))
    out, update = self.conv2(out, update)
    out = F.relu(self.act2_bn(out))
    out, update = self.conv3(out, update)
    out = self.act3_bn(out)
    residual = x
    if self.downsample is not None:
      residual = self.ds_norm(self.downsample(x, mask)[0])
    return F.relu(out + residual), update


class ResStack(nn.Module):

  def __init__(self, nm, in_f, inplanes, planes, blocks, strides):
    super().__init__()
    has_downsample = strides != 1 or inplanes != planes * 4
    self.num_blocks = blocks
    for i in range(blocks):
      self.add_module(f'block{i}', Bottleneck(
          nm, in_f if i == 0 else planes * 4, planes,
          strides if i == 0 else 1, has_downsample and i == 0))

  def forward(self, x, mask):
    for i in range(self.num_blocks):
      block = getattr(self, f'block{i}')
      x, mask = segment(block.numerics, block, x, mask)
    return x, mask


class Encoder(nn.Module):

  def __init__(self, nm, in_features, h, version):
    super().__init__()
    filters = ENCODER_BLOCKS[version]
    self.conv1 = PartialConv(nm, in_features, h, 7, 2, 'VALID', fused_pad=3,
                             circular=True)
    self.act1_bn = BatchNorm(nm, h)
    specs = [(h, h, h, filters[0], 1), (4 * h, h, 2 * h, filters[1], 2),
             (8 * h, 2 * h, 4 * h, filters[2], 2),
             (16 * h, 4 * h, 8 * h, filters[3], 2)]
    for i, (in_f, inplanes, planes, blocks, strides) in enumerate(specs):
      self.add_module(f'stack{i + 1}', ResStack(nm, in_f, inplanes, planes,
                                                blocks, strides))
    self.final_conv = PartialConv(nm, 32 * h, 4 * h, 3, 1, 'VALID',
                                  fused_pad=1, circular=True)
    self.final_bn = BatchNorm(nm, 4 * h)

  def forward(self, x, mask):
    out, update = self.conv1(x, mask)
    b1 = F.relu(self.act1_bn(out))
    out, update = _max_pool(b1), _max_pool(update)
    skips = [b1]
    for i in range(1, 5):
      out, update = getattr(self, f'stack{i}')(out, update)
      if i < 4:
        skips.append(out)
    out = F.relu(self.final_bn(self.final_conv(out, update)[0]))
    return out, skips


class TransBasicBlock(nn.Module):

  def __init__(self, nm, inplanes, planes, strides=1, has_upsample=False,
               spectral=True):
    super().__init__()
    self.numerics = nm
    conv = lambda *a, **k: Conv(nm, *a, spectral=spectral, **k)
    self.main_conv1 = conv(inplanes, inplanes, 3, 1, 'VALID', use_bias=False,
                           fused_pad=1, circular=True)
    self.main_bn1 = BatchNorm(nm, inplanes)
    if has_upsample and strides != 1:
      self.main_convt = ConvTranspose(nm, inplanes, planes, 3, strides,
                                      'SAME', use_bias=False)
    else:
      self.main_conv2 = conv(inplanes, planes, 3, strides, 'VALID',
                             use_bias=False, fused_pad=1, circular=True)
    self.main_bn2 = BatchNorm(nm, planes)
    self.has_upsample = has_upsample
    if has_upsample:
      if strides != 1:
        self.up_convt = ConvTranspose(nm, inplanes, planes, 2, strides,
                                      'VALID', use_bias=False)
      else:
        self.up_conv = conv(inplanes, planes, 1, strides, use_bias=False)
      self.up_bn = BatchNorm(nm, planes)

  def forward(self, x):
    out = F.relu(self.main_bn1(self.main_conv1(x)))
    main = self.main_convt if hasattr(self, 'main_convt') else self.main_conv2
    out = self.main_bn2(main(out))
    residual = x
    if self.has_upsample:
      up = self.up_convt if hasattr(self, 'up_convt') else self.up_conv
      residual = self.up_bn(up(x))
    return F.relu(out + residual)


class ResStackTranspose(nn.Module):

  def __init__(self, nm, inplanes, planes, blocks, strides=1, spectral=True):
    super().__init__()
    self.num_blocks = blocks
    for i in range(blocks - 1):
      self.add_module(f'block{i}', TransBasicBlock(nm, inplanes, inplanes,
                                                   spectral=spectral))
    self.add_module(f'block{blocks - 1}', TransBasicBlock(
        nm, inplanes, planes, strides,
        has_upsample=strides != 1 or inplanes != planes, spectral=spectral))

  def forward(self, x):
    for i in range(self.num_blocks):
      block = getattr(self, f'block{i}')
      x = segment(block.numerics, block, x)
    return x


class Decoder(nn.Module):

  def __init__(self, nm, h, version):
    super().__init__()
    filters = DECODER_BLOCKS[version]
    self.upc_conv = Conv(nm, 4 * h, 2 * h, 1, 1, 'SAME', spectral=True)
    self.upc_bn = BatchNorm(nm, 2 * h)
    for name, in_f, out_f in (('agent4', 2 * h, 8 * h),
                              ('agent3', 16 * h, 4 * h),
                              ('agent2', 8 * h, 2 * h),
                              ('agent1', 4 * h, h), ('agent0', h, h)):
      self.add_module(name, PartialConv(nm, in_f, out_f, 1, 1, 'SAME',
                                        use_bias=False, inert_u=True))
      self.add_module(f'{name}_bn', BatchNorm(nm, out_f))
    stages = [(8 * h, 4 * h, filters[0], 1), (4 * h, 2 * h, filters[1], 2),
              (2 * h, h, filters[2], 2), (h, h, filters[3], 2)]
    for i, (inplanes, planes, blocks, strides) in enumerate(stages):
      self.add_module(f'deconv{i + 1}', ResStackTranspose(
          nm, inplanes, planes, blocks, strides))
    self.final_conv = ResStackTranspose(nm, h, h, 3, spectral=False)
    self.final_deconv = ConvTranspose(nm, h, h, 2, 2, 'SAME')

  def _agent(self, name, x):
    return F.relu(getattr(self, f'{name}_bn')(getattr(self, name)(x)[0]))

  def forward(self, x, skips):
    out = F.leaky_relu(self.upc_bn(self.upc_conv(x)), negative_slope=0.2)
    out = self._agent('agent4', _upsample(out))
    for i in range(4):
      out = getattr(self, f'deconv{i + 1}')(out)
      out = out + self._agent(f'agent{3 - i}', skips[3 - i])
    return self.final_deconv(self.final_conv(out))


class ConvChain(nn.Module):
  """(BatchNorm, circular 3x3 spectral conv, LeakyReLU 0.3) layers, no
  activation after the last."""

  def __init__(self, nm, widths: List[int]):
    super().__init__()
    self.numerics = nm
    self.num_convs = len(widths) - 1
    for i in range(self.num_convs):
      self.add_module(f'bn{i}', BatchNorm(nm, widths[i]))
      self.add_module(f'conv{i}', Conv(nm, widths[i], widths[i + 1], 3, 1,
                                       'VALID', fused_pad=1, circular=True,
                                       spectral=True))

  def _layer(self, i, x):
    x = getattr(self, f'conv{i}')(getattr(self, f'bn{i}')(x))
    if i < self.num_convs - 1:
      x = F.leaky_relu(x, negative_slope=0.3)
    return x

  def forward(self, x):
    for i in range(self.num_convs):
      x = segment(self.numerics, self._layer, i, x)
    return x


class Generator(nn.Module):
  """The served generator: NHWC guidance dict -> (depth (N, H, W, 1),
  rgb (N, H, W, 3)), both in [0, 1]."""

  def __init__(self, gen_dims: int, resnet_version: str,
               use_blurred_mask: bool = True,
               numerics: Optional[Numerics] = None):
    super().__init__()
    nm = numerics or Numerics()
    self.numerics = nm
    h = gen_dims
    self.use_blurred_mask = use_blurred_mask
    self.encoder = Encoder(nm, 5 if use_blurred_mask else 4, h,
                           resnet_version)
    self.global_context = ConvChain(nm, [4 * h, 4 * h, 8 * h, 4 * h, 4 * h])
    self.decoder = Decoder(nm, h, resnet_version)
    self.depth_decoder = Decoder(nm, h, resnet_version)
    self.rgb_conv = ConvChain(nm, [h, h, h, 3])
    self.depth_conv = ConvChain(nm, [h, h, h, 1])

  def forward(self, cond: Dict[str, torch.Tensor]):
    parts = [cond['proj_image'], cond['proj_depth']]
    if self.use_blurred_mask:
      parts.append(cond['blurred_mask'])
    x = torch.cat(parts, dim=-1).permute(0, 3, 1, 2).float()
    mask = cond['proj_mask'].permute(0, 3, 1, 2).float()
    hidden, skips = self.encoder(x, mask)
    hidden = self.global_context(hidden)
    rgb = self.rgb_conv(self.decoder(hidden, skips)).permute(0, 2, 3, 1)
    depth = self.depth_conv(self.depth_decoder(hidden, skips)).permute(
        0, 2, 3, 1)
    if self.numerics.calibrate:
      self.numerics.heads = {'rgb': (rgb.mean(), rgb.std()),
                             'depth': (depth.mean(), depth.std())}
    return torch.clamp(depth, 0.0, 1.0), (torch.tanh(rgb) + 1) / 2


def leaves(model: nn.Module):
  """Each weight of `model` as (module name, module, kind): 'conv',
  'convt', 'bn' or 'in'."""
  for name, module in model.named_modules():
    if isinstance(module, Conv):
      yield name, module, 'conv'
    elif isinstance(module, ConvTranspose):
      yield name, module, 'convt'
    elif isinstance(module, BatchNorm):
      yield name, module, 'bn'
    elif isinstance(module, InstanceNorm):
      yield name, module, 'in'


def normalize(kernel: torch.Tensor, u: torch.Tensor):
  """(kernel / (sigma + eps), u_hat) from one power iteration from `u`;
  sigma's gradient flows through the kernel alone."""
  out = kernel.shape[0]
  w_flat = kernel.reshape(out, -1).T
  with torch.no_grad():
    w = w_flat.detach()
    v = u @ w.T
    v_hat = v / (torch.linalg.norm(v) + SPECTRAL_EPSILON)
    u_new = v_hat @ w
    u_hat = u_new / (torch.linalg.norm(u_new) + SPECTRAL_EPSILON)
  sigma = (v_hat @ w_flat) @ u_hat.T
  return (w_flat / (sigma + SPECTRAL_EPSILON)).T.reshape(kernel.shape), u_hat


def prepare(model: nn.Module, store_u: bool) -> None:
  """Before a training-form forward: each spectral kernel divided by
  sigma from one power iteration from its `u` (what the call convolves
  with); the new `u` stored where the forward stores it (in training).
  A partial conv's inert `u` advances too, and nothing reads it."""
  for _, module, kind in leaves(model):
    if kind != 'conv' or module.u is None:
      continue
    if module.spectral:
      module.prepared, u_hat = normalize(module.weight, module.u)
    elif store_u:
      with torch.no_grad():
        u_hat = normalize(module.weight, module.u)[1]
    if store_u:
      module.u.copy_(u_hat)


class InstanceNorm(nn.Module):
  """Instance normalisation, eps 1e-3, with a per-channel scale and
  shift (Flax `gamma`, `beta`)."""

  def __init__(self, features: int):
    super().__init__()
    self.weight = nn.Parameter(torch.ones(features))
    self.bias = nn.Parameter(torch.zeros(features))

  def forward(self, x):
    return F.instance_norm(x, weight=self.weight, bias=self.bias, eps=1e-3)


def fold(kernel: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
  """An OIHW kernel divided by (sigma + eps), sigma from one power
  iteration from `u` (1, O) on the (K, O) flattened kernel."""
  out = kernel.shape[0]
  w = kernel.reshape(out, -1).T
  v = u @ w.T
  v_hat = v / (torch.linalg.norm(v) + SPECTRAL_EPSILON)
  u_new = v_hat @ w
  u_hat = u_new / (torch.linalg.norm(u_new) + SPECTRAL_EPSILON)
  sigma = (v_hat @ w) @ u_hat.T
  return (w / (sigma + SPECTRAL_EPSILON)).T.reshape(kernel.shape)


def _node(tree, path):
  for part in path:
    tree = tree[part]
  return tree


@torch.no_grad()
def load_flax(model: nn.Module, variables, fold_spectral: bool = True
              ) -> None:
  """Loads a Flax-layout tree ({'params', 'batch_stats', 'spectral'} of
  tensors) into `model`: HWIO kernels to OIHW, transposed kernels to
  (in, out, kh, kw) flipped; spectral kernels folded (serving), or kept
  raw with their `u` (training)."""
  params, stats = variables['params'], variables['batch_stats']
  spectral = variables['spectral']
  for name, module, kind in leaves(model):
    path = name.split('.')
    if kind == 'in':
      module.weight.copy_(_node(params, path)['gamma'])
      module.bias.copy_(_node(params, path)['beta'])
      continue
    if kind == 'bn':
      p, s = _node(params, path)['bn'], _node(stats, path)['bn']
      module.weight.copy_(p['scale'])
      module.bias.copy_(p['bias'])
      module.running_mean.copy_(s['mean'])
      module.running_var.copy_(s['var'])
      continue
    node = _node(params, path)
    if kind == 'convt':
      node = node['convt']
      module.weight.copy_(node['kernel'].flip(0, 1).permute(2, 3, 0, 1))
    else:
      kernel = node['kernel'].permute(3, 2, 0, 1)
      if module.spectral and fold_spectral:
        kernel = fold(kernel.float(), _node(spectral, path)['u'].float())
      elif module.spectral or (module.inert_u and not fold_spectral):
        module.u = _node(spectral, path)['u'].float().clone()
      module.weight.copy_(kernel)
    if module.bias is not None:
      module.bias.copy_(node['bias'])
