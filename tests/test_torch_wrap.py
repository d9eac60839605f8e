"""The circular pads of the generator, `layers._padded`, on the CPU (its
plain body; tests/test_torch_cuda.py holds the CUDA kernel,
`ops/wrap_cuda.py`, to it on the card).

`_padded(x, pads, scale)` is `_padded(x * scale, pads)`: a partial
convolution's masking rides its input's circular pad. These tests hold
that for every pad the tiny generator makes, in float32 and bfloat16,
with a scale that is not 0/1 and inputs holding NaN, inf and -0; hold
`PartialConv.convolve` to the previous version's ops (the product, then
the pad) bit for bit, at eval and in training with its gradients; and
count the circular pads, `generator.wrap_pads`, against the generator's
structure (tests/test_torch_tracing.py counts them through served calls
whose programs replay).
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from se3ds_torch import tracing
from se3ds_torch.models import folding
from se3ds_torch.models import generator as generator_lib
from se3ds_torch.models import layers

H, W = 32, 64


@pytest.fixture(autouse=True, scope='module')
def one_torch_thread():
  """Tiny ops under the suite's parallel workers: one thread each."""
  threads = torch.get_num_threads()
  torch.set_num_threads(1)
  yield
  torch.set_num_threads(threads)


def _generator(seed=0, fold=True):
  gen = generator_lib.ResNetGenerator(gen_dims=4, z_dim=2,
                                      resnet_version='tiny',
                                      spectral_fold=fold)
  folding.init_random_(gen, torch.Generator().manual_seed(seed))
  return gen.eval()


def _cond(seed=1, batch=2):
  rs = np.random.RandomState(seed)
  return {k: torch.from_numpy(rs.rand(batch, H, W, c).astype(np.float32))
          for k, c in (('proj_image', 3), ('proj_depth', 1),
                       ('proj_mask', 1), ('blurred_mask', 1))}


def _circular_pads_by_structure(gen):
  """The circular pads one eval forward of `gen` makes: one for each
  circular convolution with a fused pad, and one more for a partial
  convolution's mask (its window sums)."""
  return sum((2 if isinstance(m, layers.PartialConv) else 1)
             for m in gen.modules()
             if isinstance(m, layers._Conv) and m.circular and m.fused_pad)


@pytest.fixture(scope='module')
def generator_pads():
  """(shape, Pads, whether a scale was given) of every `_padded` call of
  one eval forward of the tiny generator."""
  gen, seen, real = _generator(), [], layers._padded

  def recording(x, pads, scale=None):
    seen.append((tuple(x.shape), pads, scale is not None))
    return real(x, pads, scale)

  layers._padded = recording
  try:
    with torch.no_grad():
      gen(_cond())
  finally:
    layers._padded = real
  return seen


def _bits(x):
  return x.view(torch.int16 if x.dtype == torch.bfloat16 else torch.int32)


def _scale_and_input(shape, dtype, seed):
  """A float input holding NaN, inf and -0, and an (N, 1, H, W) scale that
  is not 0/1 (and holds 0, -0 and inf)."""
  g = torch.Generator().manual_seed(seed)
  n, c, h, w = shape
  x = torch.randn(shape, generator=g) * 3
  flat = x.view(-1)
  picks = torch.randperm(flat.numel(), generator=g)[:3 * max(1, flat.numel()
                                                               // 50)]
  for i, value in enumerate((float('nan'), float('inf'), -0.0)):
    flat[picks[i::3]] = value
  scale = torch.rand((n, 1, h, w), generator=g) * 2 - 0.5
  scale.view(-1)[:3] = torch.tensor([0.0, -0.0, float('inf')])
  to = lambda t: t.to(dtype).contiguous(memory_format=torch.channels_last)
  return to(x), scale.to(dtype)


def test_the_generator_pads_circularly(generator_pads):
  """The tiny generator's eval forward makes its circular pads through
  `_padded`, and every partial convolution masks its input there, with
  its mask as the scale: in the circular pad's one pass where it pads
  circularly, with no pad where the convolution pads its input itself."""
  wrapped = [p for _, p, _ in generator_pads if p.wrap]
  scaled = [p for _, p, s in generator_pads if s]
  gen = _generator()
  assert len(wrapped) == _circular_pads_by_structure(gen) > 0
  partial = [m for m in gen.modules() if isinstance(m, layers.PartialConv)]
  assert len(scaled) == len(partial) > 0
  assert sum(p.wrap for p in scaled) == sum(
      1 for m in partial if m.fused_pad) > 0
  assert all(p.wrap or p == layers.Pads(0, 0, 0, 0) for p in scaled)
  assert {(p.top, p.left) for p in wrapped} == {(1, 1), (3, 3)}


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16],
                         ids=['float32', 'bfloat16'])
def test_scaled_pad_equals_the_scaled_input_padded(generator_pads, dtype):
  """For every pad of the tiny generator, and the row band's pads (no
  height pad), `_padded(x, pads, scale)` is `_padded(x * scale, pads)`
  bit for bit, NaN, inf and -0 included; without a scale it is `F.pad`
  and `wrap_width`."""
  cases = {(shape, pads) for shape, pads, _ in generator_pads}
  cases |= {(shape, pads._replace(top=0, bottom=0))
            for shape, pads in list(cases) if pads.wrap}
  for i, (shape, pads) in enumerate(sorted(cases)):
    x, scale = _scale_and_input(shape, dtype, i)
    got = layers._padded(x, pads, scale)
    want = layers._padded(x * scale, pads)
    assert got.dtype == dtype and got.shape == want.shape
    assert torch.equal(_bits(got), _bits(want)), (shape, pads)
    if pads.wrap:
      plain = layers.wrap_width(F.pad(x, (0, 0, pads.top, pads.bottom)),
                                pads.left)
      assert torch.equal(_bits(layers._padded(x, pads)), _bits(plain))


def _parent_convolve(conv, feature, mask):
  """The previous version's `PartialConv.convolve`: the masked features,
  then the pad (circular at eval, the convolution's own zeros in
  training), then the convolution; and the mask's window sums."""
  kh, kw = conv.weight.shape[-2:]
  if mask is None:
    mask = torch.ones_like(feature[:, :1])
  window_sum = layers.mask_window_sum(mask, kh, kw, conv.strides,
                                      fused_pad=conv.fused_pad,
                                      circular=conv.wraps,
                                      padding=conv.padding)
  x, p = feature * mask, conv.fused_pad
  weight = conv.weight.to(x.dtype)
  if conv.wraps:
    x = layers.wrap_width(F.pad(x, (0, 0, p, p)), p)
    p = 0
  return F.conv2d(x, weight, stride=conv.strides, padding=p), window_sum


PARTIAL_CASES = {
    'bottleneck_conv2': dict(c_in=8, c=8, k=3, stride=1),
    'bottleneck_conv2_stride2': dict(c_in=8, c=8, k=3, stride=2),
    'stem': dict(c_in=5, c=8, k=7, stride=2),
    'final_conv': dict(c_in=16, c=8, k=3, stride=1),
    'conv1_1x1': dict(c_in=8, c=8, k=1, stride=1),
    'downsample_1x1': dict(c_in=8, c=16, k=1, stride=2),
}


@pytest.mark.parametrize('train', [False, True], ids=['eval', 'train'])
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16],
                         ids=['float32', 'bfloat16'])
@pytest.mark.parametrize('name', sorted(PARTIAL_CASES))
def test_partial_convolve_gives_the_parents_bits(name, dtype, train):
  """`PartialConv.convolve` gives the previous version's output and window
  sums bit for bit, with a blurred (not 0/1) mask and with none, at eval
  (the circular pad) and in training (zero pads; with the gradients of
  the features, the mask and the kernel, float32)."""
  case = PARTIAL_CASES[name]
  k = case['k']
  conv = layers.PartialConv(case['c_in'], case['c'], k, case['stride'],
                            'VALID' if k > 1 else 'SAME', fused_pad=k // 2,
                            circular=k > 1).train(train)
  g = torch.Generator().manual_seed(k * 10 + case['stride'])
  with torch.no_grad():
    conv.weight.copy_(torch.randn(conv.weight.shape, generator=g) * 0.3)
  feature = torch.randn(2, case['c_in'], 12, 24, generator=g).to(dtype)
  feature = feature.contiguous(memory_format=torch.channels_last)
  blurred = torch.rand(2, 1, 12, 24, generator=g).to(dtype)
  blurred[:, :, :3] = 0
  for mask in (blurred, None):
    if train and dtype == torch.float32:
      used = 1 if mask is None else 2
      inputs = [t.detach().requires_grad_() for t in (feature, blurred)]
      got = conv.convolve(*inputs[:used])
      grads = torch.autograd.grad(got[0].sum(),
                                  inputs[:used] + [conv.weight])
      twins = [t.detach().requires_grad_() for t in (feature, blurred)]
      want = _parent_convolve(conv, *twins[:used],
                              *([None] if mask is None else []))
      wants = torch.autograd.grad(want[0].sum(),
                                  twins[:used] + [conv.weight])
      for a, b in zip(grads, wants):
        assert torch.equal(a, b)
    else:
      with torch.no_grad():
        got = conv.convolve(feature, mask)
        want = _parent_convolve(conv, feature, mask)
    for a, b in zip(got, want):
      assert a.dtype == b.dtype and torch.equal(a.detach(), b.detach())


def test_wrap_pads_count_the_circular_pads_of_a_forward():
  """`generator.wrap_pads` moves by the circular pads the generator's
  structure implies, each eval forward; a train-mode forward pads with
  zeros and moves it by none; the CPU launches no kernel."""
  gen, cond = _generator(), _cond()
  per_call = _circular_pads_by_structure(gen)
  before = [tracing.count(n) for n in ('generator.wrap_pads',
                                       'wrap.launches')]
  with torch.no_grad():
    for _ in range(2):
      gen(cond)
  assert [tracing.count(n) - b for n, b in zip(
      ('generator.wrap_pads', 'wrap.launches'), before)] == [2 * per_call, 0]
  trainable = _generator(fold=False).train()
  before = tracing.count('generator.wrap_pads')
  trainable(cond)
  assert tracing.count('generator.wrap_pads') == before
