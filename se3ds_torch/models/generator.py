"""SE3DS generator (port of `se3ds_tpu.models.generator`).

A ResNet encoder with partial convs over the guidance RGB-D (+ blurred
mask), a 4-conv spectral global context at the bottleneck, and two
decoders (RGB and depth) sharing the encoder skips. The generator takes
and returns NHWC tensors and runs on NCHW-shaped tensors inside: in
channels_last (NHWC) memory in eval, where the permuted input is a
channels_last view that every layer keeps, and in contiguous NCHW memory
in training, which makes its inputs contiguous. The 7-output contract
[mu, logvar, kld, depth, seg, depth_seg, rgb] is kept; mu, logvar, kld
and the two seg outputs are all zero in this release.

`spectral_fold=True` (the default) is the serving form: every spectral
kernel divided by sigma at load, eval only. `spectral_fold=False` is the
trainable form: spectral convs hold their power-iteration state `u` and
the module trains (`.train()`: zero padding, batch statistics, `u`
stored) or evaluates (`.eval()`: circular padding, running statistics,
one power iteration per call, equal to the folded form).
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch
from torch import nn

from se3ds_torch import constants
from se3ds_torch.models import layers
from se3ds_torch.models import spatial

RESNET_ENCODER_FILTERS = {
    'tiny': (1, 1, 1, 1),
    '50': (3, 4, 6, 3),
    '101': (3, 4, 23, 3),
    '152': (3, 8, 36, 3),
}
RESNET_DECODER_FILTERS = {
    'tiny': (1, 1, 1, 1),
    '50': (6, 4, 3, 3),
    '101': (23, 4, 3, 3),
    '152': (36, 8, 3, 3),
}


def _check_version(resnet_version: str):
  if resnet_version not in RESNET_ENCODER_FILTERS:
    raise ValueError(
        f'resnet_version should be one of {sorted(RESNET_ENCODER_FILTERS)},'
        f' got {resnet_version} instead.')


class ResNetEncoder(nn.Module):
  """Encoder; returns (hidden, [b1, s1, s2, s3])."""

  def __init__(self, in_features: int, hidden_dims: int = 64,
               resnet_version: str = '50', circular_pad: bool = False,
               spectral: bool = True, fold: bool = True):
    super().__init__()
    _check_version(resnet_version)
    filters = RESNET_ENCODER_FILTERS[resnet_version]
    h = hidden_dims
    self.conv1 = layers.PartialConv(in_features, h, 7, 2, 'VALID',
                                    fused_pad=3, circular=circular_pad)
    self.act1_bn = layers.SyncBatchNorm(h)
    # (real input width, Flax `inplanes`, planes, blocks, strides)
    specs = [(h, h, h, filters[0], 1), (4 * h, h, 2 * h, filters[1], 2),
             (8 * h, 2 * h, 4 * h, filters[2], 2),
             (16 * h, 4 * h, 8 * h, filters[3], 2)]
    for i, (in_f, inplanes, planes, blocks, strides) in enumerate(specs):
      self.add_module(f'stack{i + 1}', layers.ResStack(
          in_f, inplanes, planes, blocks, strides=strides,
          circular_pad=circular_pad, spectral=spectral, fold=fold))
    self.final_conv = layers.PartialConv(32 * h, 4 * h, 3, 1, 'VALID',
                                         fused_pad=1, circular=circular_pad)
    self.final_bn = layers.SyncBatchNorm(4 * h)

  def _stem(self, x, mask):
    out, window_sum = self.conv1.convolve(x, mask)
    b1, update_mask = layers.epilogue(
        layers.ConvOutput(out, self.conv1, window_sum, self.act1_bn),
        layers.RELU)
    return (b1, layers.max_pool_2x2_same(b1),
            layers.max_pool_2x2_same(update_mask))

  def _final(self, x, mask):
    out, window_sum = self.final_conv.convolve(x, mask)
    return layers.epilogue(
        layers.ConvOutput(out, self.final_conv, window_sum, self.final_bn),
        layers.RELU)[0]

  def forward(self, x, mask=None):
    b1, out, update_mask = layers.remat(self._stem, x, mask,
                                        state_of=(self.conv1,))
    out, update_mask = self.stack1(out, update_mask)
    s1 = out
    out, update_mask = self.stack2(out, update_mask)
    s2 = out
    out, update_mask = self.stack3(out, update_mask)
    s3 = out
    out, update_mask = self.stack4(out, update_mask)
    out = layers.remat(self._final, out, update_mask,
                       state_of=(self.final_conv,))
    return out, [b1, s1, s2, s3]


class ResNetDecoder(nn.Module):
  """Decoder with partial-conv skip agents (fully convolutional)."""

  def __init__(self, output_dim: int, hidden_dims: int = 64,
               resnet_version: str = '50', circular_pad: bool = False,
               spectral: bool = True, fold: bool = True):
    super().__init__()
    _check_version(resnet_version)
    filters = RESNET_DECODER_FILTERS[resnet_version]
    h = hidden_dims
    conv = layers.conv_fn(spectral, fold)
    self.upc_conv = conv(4 * h, 2 * h, 1, 1, 'SAME')
    self.upc_bn = layers.SyncBatchNorm(2 * h)
    # Skip agents: (name, input width, output width).
    agents = [('agent4', 2 * h, 8 * h), ('agent3', 16 * h, 4 * h),
              ('agent2', 8 * h, 2 * h), ('agent1', 4 * h, h),
              ('agent0', h, h)]
    for name, in_f, out_f in agents:
      self.add_module(name, layers.PartialConv(
          in_f, out_f, 1, 1, 'SAME', use_bias=False, spectral_norm=spectral,
          fold=fold))
      self.add_module(f'{name}_bn', layers.SyncBatchNorm(out_f))
    stages = [(8 * h, 4 * h, filters[0], 1), (4 * h, 2 * h, filters[1], 2),
              (2 * h, h, filters[2], 2), (h, h, filters[3], 2)]
    for i, (inplanes, planes, blocks, strides) in enumerate(stages):
      self.add_module(f'deconv{i + 1}', layers.ResStackTranspose(
          inplanes, planes, blocks, strides=strides,
          circular_pad=circular_pad, spectral=spectral, fold=fold))
    # final_conv uses plain Conv2D in the reference.
    self.final_conv = layers.ResStackTranspose(h, h, 3,
                                               circular_pad=circular_pad,
                                               spectral=False)
    self.final_deconv = layers.Conv2DTranspose(h, output_dim, 2, 2, 'SAME')

  def _agent(self, name: str, x, residual=None):
    """relu(bn(agent(x))), plus `residual` after the activation."""
    agent = getattr(self, name)
    out, window_sum = agent.convolve(x)
    return layers.epilogue(
        layers.ConvOutput(out, agent, window_sum,
                          getattr(self, f'{name}_bn')),
        layers.RELU, residual, after_act=True)[0]

  def _upc(self, x):
    out, _ = layers.epilogue(
        layers.ConvOutput(self.upc_conv.convolve(x), self.upc_conv,
                          bn=self.upc_bn), 0.2)
    return self._agent('agent4', layers.upsample_2x_nearest(out))

  def forward(self, x, skip):
    out = layers.remat(self._upc, x, state_of=(self.upc_conv, self.agent4))
    for i in range(4):
      out = getattr(self, f'deconv{i + 1}')(out)
      agent = f'agent{3 - i}'
      out = layers.remat(self._agent, agent, skip[3 - i], residual=out,
                         state_of=(getattr(self, agent),))
    out = self.final_conv(out)
    return self.final_deconv(out)


class _ConvChain(nn.Module):
  """(BN, circular 3x3 conv, LeakyReLU 0.3) chain; no activation last.

  Layer i's segment ends with layer i + 1's BatchNorm (layer 0's starts
  with its own), so that one epilogue follows each convolution.
  """

  def __init__(self, widths: List[int], circular_pad: bool, spectral: bool,
               fold: bool = True):
    super().__init__()
    conv = layers.conv_fn(spectral, fold)
    self.num_convs = len(widths) - 1
    for i in range(self.num_convs):
      self.add_module(f'bn{i}', layers.SyncBatchNorm(widths[i]))
      self.add_module(f'conv{i}', conv(widths[i], widths[i + 1], 3, 1,
                                       'VALID', fused_pad=1,
                                       circular=circular_pad))

  def _layer(self, i: int, x):
    if i == 0:
      x = self.bn0(x)
    conv = getattr(self, f'conv{i}')
    if i == self.num_convs - 1:
      return conv(x)
    # Keras LeakyReLU() default slope.
    return layers.epilogue(layers.ConvOutput(conv.convolve(x), conv), 0.3,
                           post_bn=getattr(self, f'bn{i + 1}'))[0]

  def forward(self, x):
    # One segment per layer: the output heads run at full resolution.
    for i in range(self.num_convs):
      x = layers.remat(self._layer, i, x,
                       state_of=(getattr(self, f'conv{i}'),))
    return x


class OutputHead(_ConvChain):
  """3x(BN, pad, conv3x3) head (reference rgb_conv/depth_conv)."""

  def __init__(self, hidden_dims: int, out_channels: int, circular_pad: bool,
               spectral: bool = True, fold: bool = True):
    super().__init__([hidden_dims, hidden_dims, hidden_dims, out_channels],
                     circular_pad, spectral, fold)


class GlobalContext(_ConvChain):
  """4-layer spectral-conv context stack at the bottleneck."""

  def __init__(self, hidden_dims: int, circular_pad: bool, fold: bool = True):
    h = hidden_dims
    super().__init__([4 * h, 4 * h, 8 * h, 4 * h, 4 * h], circular_pad,
                     spectral=True, fold=fold)


def _nchw(x):
  return x.permute(0, 3, 1, 2)


def _nhwc(x):
  return x.permute(0, 2, 3, 1)


class ResNetGenerator(nn.Module):
  """RGB-D pano generator (reference ResNetGenerator).

  Call with a dict of NHWC conditions:
    proj_image: (N, H, W, 3) guidance RGB in [0, 1].
    proj_depth: (N, H, W, 1) guidance depth in [0, 1].
    proj_mask: (N, H, W, 1) binary guidance-validity mask.
    blurred_mask: (N, H, W, 1) binary mask of blurred pole regions.

  Returns the reference 7-list, NHWC:
    [mu_p, logvar_p, kld_loss, depth_out, seg_out, depth_seg_out, rgb_out].
  The all-zero seg outputs are broadcast views (no memory).

  With `rows` (a `spatial.Rows`; the eval, folded form only) every map
  is split by rows over its process group: each rank passes the whole
  conditions, runs this forward on its rows, and gets the whole outputs.
  """

  def __init__(self, gen_dims: int = 96, z_dim: int = 128,
               resnet_version: str = '50', context_layer: str = 'convs',
               conv_mode: str = 'spectral', use_blurred_mask: bool = True,
               spectral_fold: bool = True,
               dtype: torch.dtype = torch.float32):
    super().__init__()
    if context_layer not in ('convs', 'none'):
      raise NotImplementedError(context_layer)
    spectral = conv_mode == 'spectral'
    fold = spectral_fold
    circular_pad = True
    h = gen_dims
    self.z_dim = z_dim
    self.use_blurred_mask = use_blurred_mask
    self.dtype = dtype
    self.encoder = ResNetEncoder(5 if use_blurred_mask else 4, h,
                                 resnet_version, circular_pad, spectral, fold)
    self.global_context = (GlobalContext(h, circular_pad, fold)
                           if context_layer == 'convs' else None)
    self.decoder = ResNetDecoder(h, h, resnet_version, circular_pad, spectral,
                                 fold)
    self.depth_decoder = ResNetDecoder(h, h, resnet_version, circular_pad,
                                       spectral, fold)
    self.rgb_conv = OutputHead(h, 3, circular_pad, spectral, fold)
    self.depth_conv = OutputHead(h, 1, circular_pad, spectral, fold)

  def forward(self, cond: Dict[str, torch.Tensor],
              rows: Optional[spatial.Rows] = None) -> List[torch.Tensor]:
    if rows is not None and (self.training or not all(
        getattr(m, 'fold', True) for m in self.modules())):
      raise ValueError('the row-partitioned generator serves the eval, '
                       'folded form (spectral_fold=True, .eval())')
    guidance_depth = cond['proj_depth']
    parts = [cond['proj_image'], guidance_depth]
    if self.use_blurred_mask:
      parts.append(cond['blurred_mask'])
    combined = _nchw(torch.cat(parts, dim=-1).to(self.dtype))
    mask = _nchw(cond['proj_mask'].to(self.dtype))
    if self.training:
      # Contiguous NCHW, not the permuted (channels_last) view: PyTorch's
      # CPU (oneDNN) backward of a strided 1x1 convolution crashes on
      # channels_last input with more than two threads (PyTorch 2.13).
      combined, mask = combined.contiguous(), mask.contiguous()
    if rows is not None:
      combined, mask = rows.split(combined), rows.split(mask)

    hidden, skip = self.encoder(combined, mask)
    if self.global_context is not None:
      hidden = self.global_context(hidden)
    batch_size, _, hidden_h, hidden_w = hidden.shape
    zeros_latent = torch.zeros((batch_size, hidden_h, hidden_w, self.z_dim),
                               dtype=torch.float32, device=hidden.device)

    out = self.decoder(hidden, skip)
    depth_out = self.depth_decoder(hidden, skip)
    seg_out = torch.zeros((), dtype=guidance_depth.dtype,
                          device=guidance_depth.device).expand(
                              *guidance_depth.shape[:-1],
                              constants.NUM_MP3D_CLASSES)
    def head(conv, x):
      x = conv(x)
      return _nhwc(x if rows is None else rows.gather(x)).float()

    rgb_out = head(self.rgb_conv, out)
    depth_out = head(self.depth_conv, depth_out)
    rgb_out = (torch.tanh(rgb_out) + 1) / 2
    depth_out = torch.clamp(depth_out, 0.0, 1.0)
    return [zeros_latent, zeros_latent, zeros_latent, depth_out, seg_out,
            seg_out, rgb_out]
