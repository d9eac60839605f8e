"""The serving generator with its rows spread over a process group (the
port of the JAX package's height-partitioned generator, where GSPMD
shards the pano height, NHWC axis 1, over the mesh's 'spatial' axis and
inserts the halo exchanges; se3ds_tpu/models/inference.py:688-697).

Every map of the forward pass is split by rows over the group: rank r
holds rows [R*r // n, R*(r+1) // n) of a map of R rows (`Rows.band`),
the whole width, and every channel. Elementwise layers run on the band:
what follows each convolution (its bias or partial-conv renormalisation,
eval BatchNorm, activation, residual add) is the blocks' own
`layers.epilogue` call on the band tensors, as in `generator`. A layer that reads across a band
edge (a convolution or partial convolution of kernel height > 1 or
stride > 1, a transposed convolution, the 2x2 max pool, the nearest
upsample) first fetches the input rows its output band reads from the
ranks that hold them (`Rows.fetch`, point-to-point), and then runs on
that window with no height padding of its own. The windows are computed
from the GLOBAL map sizes, so the band outputs are the whole-image
arithmetic row for row:

* height pads: TF 'SAME' pads, fused pads and the max pool's -inf row
  come from the global row count, as fill rows outside [0, R) of the
  window (only the first and last band see them); the width wraps or
  pads as in `layers` (the width is whole on every rank);
* strides stay aligned to global row 0, and the transposed convolutions'
  crops and the upsample's rows are taken in global row numbers;
* a band may hold no rows (deep stages of a small pano hold fewer rows
  than ranks): its rank fetches nothing, computes one row of fill and
  keeps none of it, and every other rank still finds each row it reads.

The outputs are gathered whole on every rank at the end. BatchNorm runs
on its running statistics (eval), so no statistic crosses ranks.
Convolutions run on other shapes than the whole image's, so results may
differ from it by float rounding (the JAX package allows `pred_depth`
2e-3 and `pred_rgb` one level, tests/test_inference.py:524-561).
"""

from __future__ import annotations

from typing import Callable, Dict, List, NamedTuple, Optional, Tuple, Union

import torch
import torch.distributed as dist
import torch.nn.functional as F

from se3ds_torch import constants
from se3ds_torch.models import generator as generator_lib
from se3ds_torch.models import layers


class Band(NamedTuple):
  """This rank's rows of an NCHW map of `rows` rows."""
  x: torch.Tensor
  rows: int

  def map(self, fn: Callable[[torch.Tensor], torch.Tensor]) -> 'Band':
    """An elementwise layer on the band."""
    return Band(fn(self.x), self.rows)


class Rows:
  """A process group over which maps are split by rows."""

  def __init__(self, group):
    self.group = group
    self.size = dist.get_world_size(group)
    self.rank = dist.get_rank(group)
    self.peers = dist.get_process_group_ranks(group)

  def band(self, rows: int, rank: Optional[int] = None) -> Tuple[int, int]:
    """[start, stop) of `rank`'s rows (default: this rank's)."""
    rank = self.rank if rank is None else rank
    return rows * rank // self.size, rows * (rank + 1) // self.size

  def split(self, x: torch.Tensor) -> Band:
    """This rank's band of a whole NCHW map."""
    start, stop = self.band(x.shape[2])
    return Band(x[:, :, start:stop], x.shape[2])

  def fetch(self, band: Band,
            need: Callable[[int], Tuple[int, int]], fill: float
            ) -> torch.Tensor:
    """Rows [a, b) = need(self.rank) of the global map, `fill` outside
    [0, rows); each rank q is sent the rows of this band in need(q).
    Every rank of the group calls it with the same `need`."""
    x, rows = band
    start, stop = self.band(rows)
    a, b = need(self.rank)
    out = x.new_full(x.shape[:2] + (b - a,) + x.shape[3:], fill)
    ops, received = [], []
    for q in range(self.size):
      q0, q1 = self.band(rows, q)
      lo, hi = max(a, q0), min(b, q1)
      if lo < hi and q == self.rank:
        out[:, :, lo - a:hi - a] = x[:, :, lo - start:hi - start]
      elif lo < hi:
        buf = x.new_empty(x.shape[:2] + (hi - lo,) + x.shape[3:])
        ops.append(dist.P2POp(dist.irecv, buf, self.peers[q], self.group))
        received.append((buf, lo - a))
      if q == self.rank:
        continue
      qa, qb = need(q)
      lo, hi = max(qa, start), min(qb, stop)
      if lo < hi:
        ops.append(dist.P2POp(
            dist.isend, x[:, :, lo - start:hi - start].contiguous(),
            self.peers[q], self.group))
    if ops:
      for request in dist.batch_isend_irecv(ops):
        request.wait()
    for buf, at in received:
      out[:, :, at:at + buf.shape[2]] = buf
    return out

  def gather(self, band: Band) -> torch.Tensor:
    """The whole map on every rank."""
    return self.fetch(band, lambda q: (0, band.rows), 0.0)

  def window(self, band: Band, out_rows: int,
             need: Callable[[int, int], Tuple[int, int]], fill: float):
    """The input rows that this rank's band of an output of `out_rows`
    rows reads, `need(o0, o1)` for output rows [o0, o1).

    Returns (window, o0, kept): the window of output rows [o0, o0 + 1)
    for a rank whose band is empty (fill only, nothing fetched), and the
    number of output rows to keep (0 there).
    """
    def need_of(q):
      o0, o1 = self.band(out_rows, q)
      return need(o0, o1) if o1 > o0 else (0, 0)

    o0, o1 = self.band(out_rows)
    window = self.fetch(band, need_of, fill)
    if o1 > o0:
      return window, o0, o1 - o0
    a, b = need(0, 1)
    x = band.x
    return x.new_full(x.shape[:2] + (b - a,) + x.shape[3:], fill), 0, 0


def _height_pads(module, rows: int, kh: int, sh: int) -> Tuple[int, int]:
  if module.fused_pad:
    return module.fused_pad, module.fused_pad
  if module.padding.upper() == 'SAME':
    return layers._same_pads(rows, kh, sh)
  return 0, 0


def _pad_width(module, x: torch.Tensor, kw: int, sw: int) -> torch.Tensor:
  """The width pads of `layers._Conv` (circular at eval for fused pads)."""
  if module.fused_pad:
    p = module.fused_pad
    return layers.wrap_width(x, p) if module.wraps else F.pad(x, (p, p))
  if module.padding.upper() == 'SAME':
    return F.pad(x, layers._same_pads(x.shape[-1], kw, sw))
  return x


def _conv_window(rows_: Rows, module, band: Band):
  """A `layers._Conv`'s window: (input rows with the width padded, the
  output's global rows, the rows to keep)."""
  kh, kw = module.weight.shape[-2:]
  sh, sw = module.strides
  top, bottom = _height_pads(module, band.rows, kh, sh)
  out_rows = (band.rows + top + bottom - kh) // sh + 1
  window, _, kept = rows_.window(
      band, out_rows, lambda o0, o1: (o0 * sh - top, (o1 - 1) * sh - top + kh),
      0.0)
  return _pad_width(module, window, kw, sw), out_rows, kept


def conv(rows_: Rows, module, band: Band) -> Band:
  """A `Conv2D` or folded `SpectralConv` on a band, without its bias
  (its `epilogue` adds it)."""
  x, out_rows, kept = _conv_window(rows_, module, band)
  out = layers._conv2d(x, module.weight.to(x.dtype), stride=module.strides)
  return Band(out[:, :, :kept], out_rows)


def partial_conv(rows_: Rows, module: layers.PartialConv, band: Band,
                 mask: Optional[Band] = None) -> Tuple[Band, torch.Tensor]:
  """A `PartialConv` on a band: the masked features and the mask in one
  window; returns (the convolution without its bias, the mask's window
  sums), which its `epilogue` takes."""
  if mask is None:
    mask = band.map(lambda x: torch.ones_like(x[:, :1]))
  both = Band(torch.cat([band.x * mask.x, mask.x], dim=1), band.rows)
  x, out_rows, kept = _conv_window(rows_, module, both)
  kh, kw = module.weight.shape[-2:]
  window_sum = F.avg_pool2d(x[:, -1:], (kh, kw), stride=module.strides,
                            divisor_override=1)
  out = layers._conv2d(x[:, :-1], module.weight.to(x.dtype),
                       stride=module.strides)
  return Band(out[:, :, :kept], out_rows), window_sum[:, :, :kept]


def conv_transpose(rows_: Rows, module: layers.Conv2DTranspose,
                   band: Band) -> Band:
  """A `Conv2DTranspose` on a band, without its bias (its `epilogue`
  adds it). Output row o is row t = o + kh - 1 - before of the whole
  transposed convolution (before: the module's leading height pad),
  which input rows i with i*sh <= t < i*sh + kh feed."""
  weight = module.weight
  kh, kw = weight.shape[-2:]
  sh, sw = module.strides
  if kh < sh:
    raise ValueError(f'kernel height {kh} below stride {sh}')
  before, after = module._pads(kh, sh)
  shift = kh - 1 - before
  out_rows = (band.rows - 1) * sh + kh - 2 * (kh - 1) + before + after
  window, o0, kept = rows_.window(
      band, out_rows,
      lambda o0, o1: ((o0 + shift - kh + 1) // sh, (o1 - 1 + shift) // sh + 1),
      0.0)
  first = (o0 + shift - kh + 1) // sh
  weight = weight.to(window.dtype)
  layers._count_conv(window, weight)
  out = F.conv_transpose2d(window, weight, stride=module.strides)
  w_before, w_after = module._pads(kw, sw)
  out = F.pad(out, (w_before - (kw - 1), w_after - (kw - 1)))
  start = o0 + shift - first * sh
  return Band(out[:, :, start:start + kept], out_rows)


def max_pool_2x2_same(rows_: Rows, band: Band) -> Band:
  """`layers.max_pool_2x2_same` on a band (-inf below an odd map)."""
  out_rows = -(-band.rows // 2)
  window, _, kept = rows_.window(band, out_rows,
                                 lambda o0, o1: (2 * o0, 2 * o1),
                                 float('-inf'))
  if window.shape[-1] % 2:
    window = F.pad(window, (0, 1), value=float('-inf'))
  return Band(F.max_pool2d(window, 2, 2)[:, :, :kept], out_rows)


def upsample_2x_nearest(rows_: Rows, band: Band) -> Band:
  """`layers.upsample_2x_nearest` on a band."""
  window, o0, kept = rows_.window(band, 2 * band.rows,
                                  lambda o0, o1: (o0 // 2, (o1 - 1) // 2 + 1),
                                  0.0)
  out = layers.upsample_2x_nearest(window)
  start = o0 - 2 * (o0 // 2)
  return Band(out[:, :, start:start + kept], 2 * band.rows)


# -- the generator's blocks on bands (their `forward`s, eval) ---------------


def epilogue(out: Band, module=None,
             window_sum: Optional[torch.Tensor] = None, bn=None,
             act: layers.Activation = None,
             residual: Union[None, torch.Tensor, layers.ConvOutput] = None,
             after_act: bool = False, post_bn=None
             ) -> Tuple[Band, Optional[Band]]:
  """`layers.epilogue(ConvOutput(out.x, module, window_sum, bn), act,
  residual, after_act, post_bn)` on a band (`module` made `out`);
  returns (the result, the update mask of a partial convolution or None)
  as bands."""
  x, update_mask = layers.epilogue(
      layers.ConvOutput(out.x, module, window_sum, bn), act, residual,
      after_act, post_bn)
  return (Band(x, out.rows),
          None if update_mask is None else Band(update_mask, out.rows))


def bottleneck(rows_: Rows, block: layers.Bottleneck, x: Band,
               mask: Optional[Band]) -> Tuple[Band, Band]:
  out, window_sum = partial_conv(rows_, block.conv1, x, mask)
  out, update_mask = epilogue(out, block.conv1, window_sum, block.act1_bn,
                              layers.RELU)
  out, window_sum = partial_conv(rows_, block.conv2, out, update_mask)
  out, update_mask = epilogue(out, block.conv2, window_sum, block.act2_bn,
                              layers.RELU)
  out, window_sum = partial_conv(rows_, block.conv3, out, update_mask)
  residual = x.x
  if block.downsample is not None:
    ds_out, ds_window_sum = partial_conv(rows_, block.downsample, x, mask)
    residual = layers.ConvOutput(ds_out.x, block.downsample, ds_window_sum,
                                 block.ds_norm)
  return epilogue(out, block.conv3, window_sum, block.act3_bn, layers.RELU,
                  residual)


def res_stack(rows_: Rows, stack: layers.ResStack, x: Band,
              mask: Optional[Band]) -> Tuple[Band, Band]:
  for i in range(stack.num_blocks):
    x, mask = bottleneck(rows_, getattr(stack, f'block{i}'), x, mask)
  return x, mask


def _conv_any(rows_: Rows, module, band: Band) -> Band:
  """A `Conv2DTranspose` or a `_Conv` on a band, without its bias."""
  if isinstance(module, layers.Conv2DTranspose):
    return conv_transpose(rows_, module, band)
  return conv(rows_, module, band)


def trans_basic_block(rows_: Rows, block: layers.TransBasicBlock,
                      x: Band) -> Band:
  out, _ = epilogue(conv(rows_, block.main_conv1, x), block.main_conv1,
                    bn=block.main_bn1, act=layers.RELU)
  up = block.main_convt if hasattr(block, 'main_convt') else block.main_conv2
  out = _conv_any(rows_, up, out)
  residual = x.x
  if block.has_upsample:
    res = block.up_convt if hasattr(block, 'up_convt') else block.up_conv
    residual = layers.ConvOutput(_conv_any(rows_, res, x).x, res,
                                 bn=block.up_bn)
  return epilogue(out, up, bn=block.main_bn2, act=layers.RELU,
                  residual=residual)[0]


def res_stack_transpose(rows_: Rows, stack: layers.ResStackTranspose,
                        x: Band) -> Band:
  for i in range(stack.num_blocks):
    x = trans_basic_block(rows_, getattr(stack, f'block{i}'), x)
  return x


def encoder(rows_: Rows, enc: generator_lib.ResNetEncoder, x: Band,
            mask: Band) -> Tuple[Band, List[Band]]:
  out, window_sum = partial_conv(rows_, enc.conv1, x, mask)
  b1, update_mask = epilogue(out, enc.conv1, window_sum, enc.act1_bn,
                             layers.RELU)
  out = max_pool_2x2_same(rows_, b1)
  update_mask = max_pool_2x2_same(rows_, update_mask)
  skips = [b1]
  for i in range(1, 5):
    out, update_mask = res_stack(rows_, getattr(enc, f'stack{i}'), out,
                                 update_mask)
    skips.append(out)
  out, window_sum = partial_conv(rows_, enc.final_conv, out, update_mask)
  return epilogue(out, enc.final_conv, window_sum, enc.final_bn,
                  layers.RELU)[0], skips[:4]


def decoder(rows_: Rows, dec: generator_lib.ResNetDecoder, x: Band,
            skip: List[Band]) -> Band:
  def agent(name, t, residual=None):
    """relu(bn(agent(t))), plus `residual` after the activation."""
    module = getattr(dec, name)
    out, window_sum = partial_conv(rows_, module, t)
    return epilogue(out, module, window_sum, getattr(dec, f'{name}_bn'),
                    layers.RELU, residual, after_act=True)[0]

  out, _ = epilogue(conv(rows_, dec.upc_conv, x), dec.upc_conv,
                    bn=dec.upc_bn, act=0.2)
  out = agent('agent4', upsample_2x_nearest(rows_, out))
  for i in range(4):
    out = res_stack_transpose(rows_, getattr(dec, f'deconv{i + 1}'), out)
    out = agent(f'agent{3 - i}', skip[3 - i], out.x)
  out = res_stack_transpose(rows_, dec.final_conv, out)
  return epilogue(conv_transpose(rows_, dec.final_deconv, out),
                  dec.final_deconv)[0]


def conv_chain(rows_: Rows, chain: generator_lib._ConvChain,
               x: Band) -> Band:
  """`_ConvChain` on a band: layer i's epilogue ends with layer i + 1's
  BatchNorm, as in its `_layer`."""
  x = x.map(chain.bn0)
  last = chain.num_convs - 1
  for i in range(last):
    module = getattr(chain, f'conv{i}')
    # Keras LeakyReLU() default slope.
    x, _ = epilogue(conv(rows_, module, x), module, act=0.3,
                    post_bn=getattr(chain, f'bn{i + 1}'))
  module = getattr(chain, f'conv{last}')
  return epilogue(conv(rows_, module, x), module)[0]


@torch.no_grad()
def generate(rows_: Rows, gen: generator_lib.ResNetGenerator,
             cond: Dict[str, torch.Tensor]) -> List[torch.Tensor]:
  """`gen(cond)` (eval) with the rows spread over `rows_`'s group; every
  rank passes the whole conditions and gets the whole 7 outputs."""
  if gen.training or not all(getattr(m, 'fold', True)
                             for m in gen.modules()):
    raise ValueError('the row-partitioned generator serves the eval, '
                     'folded form (spectral_fold=True, .eval())')
  guidance_depth = cond['proj_depth']
  parts = [cond['proj_image'], guidance_depth]
  if gen.use_blurred_mask:
    parts.append(cond['blurred_mask'])
  nchw = generator_lib._nchw
  combined = rows_.split(nchw(torch.cat(parts, dim=-1).to(gen.dtype)))
  mask = rows_.split(nchw(cond['proj_mask'].to(gen.dtype)))
  hidden, skip = encoder(rows_, gen.encoder, combined, mask)
  if gen.global_context is not None:
    hidden = conv_chain(rows_, gen.global_context, hidden)
  batch, width = hidden.x.shape[0], hidden.x.shape[-1]
  zeros_latent = torch.zeros((batch, hidden.rows, width, gen.z_dim),
                             dtype=torch.float32, device=hidden.x.device)
  out = decoder(rows_, gen.decoder, hidden, skip)
  depth_out = decoder(rows_, gen.depth_decoder, hidden, skip)
  seg_out = torch.zeros((), dtype=guidance_depth.dtype,
                        device=guidance_depth.device).expand(
                            *guidance_depth.shape[:-1],
                            constants.NUM_MP3D_CLASSES)
  nhwc = generator_lib._nhwc
  rgb_out = nhwc(rows_.gather(conv_chain(rows_, gen.rgb_conv, out))).float()
  depth_out = nhwc(rows_.gather(
      conv_chain(rows_, gen.depth_conv, depth_out))).float()
  rgb_out = (torch.tanh(rgb_out) + 1) / 2
  depth_out = torch.clamp(depth_out, 0.0, 1.0)
  return [zeros_latent, zeros_latent, zeros_latent, depth_out, seg_out,
          seg_out, rgb_out]
