"""InceptionV3 feature extractor (port of `se3ds_tpu.eval.inception`).

The architecture of `tf.keras.applications.InceptionV3`, as the JAX
package builds it: conv + BatchNorm (no scale, eps 1e-3) + ReLU units,
mixed0..mixed10, a global average pool (the 2048-d "avg_pool" output)
and a 1000-way softmax head ("predictions"). The module takes NHWC
images, like the JAX one, and runs NCHW inside. Module names are the
Flax ones, so `torch_state_dict_from_flax_inception` maps the JAX
package's variables one to one.

Weights: `init_inception(generator)` gives deterministic random weights
(FID and IS are then a consistent relative metric only);
`inception_model`, the gin configurable the trainer's eval builds, gives
them from a fixed seed, loads a saved state dict, or converts a Keras
`.h5` (the ImageNet bundle) through `load_keras_weights`, which needs
h5py; `python -m se3ds_torch.convert_inception` converts one once into
a state-dict file where h5py is installed. `torch_state_dict_from_flax_
inception` carries the JAX package's variables across.
"""

from __future__ import annotations

import logging
import math
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from se3ds_torch.ops import image as image_ops

log = logging.getLogger('se3ds_torch')

POOL_DIM = 2048
NUM_CLASSES = 1000
BN_EPSILON = 1e-3
INPUT_SIZE = 299

# Inception V1 frozen-graph tensor endpoints; used by load_frozen_graph_v1.
INCEPTION_V1_INPUT = 'Mul:0'
INCEPTION_V1_OUTPUT = 'logits:0'
INCEPTION_V1_FINAL_POOL = 'pool_3:0'


class BatchNormNoScale(nn.Module):
  """Eval BatchNorm with a shift and no scale (Keras `scale=False`)."""

  def __init__(self, features: int):
    super().__init__()
    self.bias = nn.Parameter(torch.zeros(features))
    self.register_buffer('running_mean', torch.zeros(features))
    self.register_buffer('running_var', torch.ones(features))

  def forward(self, x):
    return F.batch_norm(x, self.running_mean, self.running_var, None,
                        self.bias, False, 0.0, BN_EPSILON)


class ConvBN(nn.Module):
  """conv2d_bn: Conv (no bias) + BatchNorm(scale=False) + ReLU.

  'SAME' is only used at stride 1 with odd kernels, where Flax pads
  (k - 1) / 2 on each side: (0, 3) for 1x7, (1, 0) for 3x1.
  """

  def __init__(self, in_features: int, features: int,
               kernel: Tuple[int, int], stride: int = 1,
               padding: str = 'SAME'):
    super().__init__()
    if padding == 'SAME':
      if stride != 1 or not all(k % 2 for k in kernel):
        raise ValueError(f'SAME padding needs stride 1 and odd kernels, '
                         f'got {kernel} stride {stride}')
      pad = (kernel[0] // 2, kernel[1] // 2)
    else:
      pad = (0, 0)
    self.conv = nn.Conv2d(in_features, features, kernel, stride, pad,
                          bias=False)
    self.bn = BatchNormNoScale(features)

  def forward(self, x):
    return F.relu(self.bn(self.conv(x)))


def _avg_pool_same(x):
  """3x3 stride-1 SAME average pool; padding is left out of the count."""
  return F.avg_pool2d(x, 3, 1, padding=1, count_include_pad=False)


def _max_pool_3x3_s2(x):
  return F.max_pool2d(x, 3, 2)


class InceptionV3(nn.Module):
  """Returns (avg_pool (N, 2048), predictions (N, 1000) softmax) for
  (N, H, W, 3) images, H and W >= 75."""

  def __init__(self):
    super().__init__()

    def cb(name, in_f, out_f, kernel, stride=1, padding='SAME'):
      self.add_module(name, ConvBN(in_f, out_f, kernel, stride, padding))

    cb('conv0', 3, 32, (3, 3), 2, 'VALID')
    cb('conv1', 32, 32, (3, 3), padding='VALID')
    cb('conv2', 32, 64, (3, 3))
    cb('conv3', 64, 80, (1, 1), padding='VALID')
    cb('conv4', 80, 192, (3, 3), padding='VALID')
    width = 192
    for i, pool_f in enumerate([32, 64, 64]):  # mixed 0..2 (35x35)
      cb(f'mixed{i}_b1x1', width, 64, (1, 1))
      cb(f'mixed{i}_b5a', width, 48, (1, 1))
      cb(f'mixed{i}_b5b', 48, 64, (5, 5))
      cb(f'mixed{i}_b3a', width, 64, (1, 1))
      cb(f'mixed{i}_b3b', 64, 96, (3, 3))
      cb(f'mixed{i}_b3c', 96, 96, (3, 3))
      cb(f'mixed{i}_bp', width, pool_f, (1, 1))
      width = 64 + 64 + 96 + pool_f
    # mixed 3 (17x17 reduction).
    cb('mixed3_b3', width, 384, (3, 3), 2, 'VALID')
    cb('mixed3_bda', width, 64, (1, 1))
    cb('mixed3_bdb', 64, 96, (3, 3))
    cb('mixed3_bdc', 96, 96, (3, 3), 2, 'VALID')
    width = 384 + 96 + width
    for i, f in zip(range(4, 8), [128, 160, 160, 192]):  # mixed 4..7
      cb(f'mixed{i}_b1x1', width, 192, (1, 1))
      cb(f'mixed{i}_b7a', width, f, (1, 1))
      cb(f'mixed{i}_b7b', f, f, (1, 7))
      cb(f'mixed{i}_b7c', f, 192, (7, 1))
      cb(f'mixed{i}_bda', width, f, (1, 1))
      cb(f'mixed{i}_bdb', f, f, (7, 1))
      cb(f'mixed{i}_bdc', f, f, (1, 7))
      cb(f'mixed{i}_bdd', f, f, (7, 1))
      cb(f'mixed{i}_bde', f, 192, (1, 7))
      cb(f'mixed{i}_bp', width, 192, (1, 1))
      width = 4 * 192
    # mixed 8 (8x8 reduction).
    cb('mixed8_b3a', width, 192, (1, 1))
    cb('mixed8_b3b', 192, 320, (3, 3), 2, 'VALID')
    cb('mixed8_b7a', width, 192, (1, 1))
    cb('mixed8_b7b', 192, 192, (1, 7))
    cb('mixed8_b7c', 192, 192, (7, 1))
    cb('mixed8_b7d', 192, 192, (3, 3), 2, 'VALID')
    width = 320 + 192 + width
    for i in (9, 10):  # mixed 9..10 (8x8)
      cb(f'mixed{i}_b1x1', width, 320, (1, 1))
      cb(f'mixed{i}_b3a', width, 384, (1, 1))
      cb(f'mixed{i}_b3b1', 384, 384, (1, 3))
      cb(f'mixed{i}_b3b2', 384, 384, (3, 1))
      cb(f'mixed{i}_bda', width, 448, (1, 1))
      cb(f'mixed{i}_bdb', 448, 384, (3, 3))
      cb(f'mixed{i}_bdc1', 384, 384, (1, 3))
      cb(f'mixed{i}_bdc2', 384, 384, (3, 1))
      cb(f'mixed{i}_bp', width, 192, (1, 1))
      width = 320 + 2 * 384 + 2 * 384 + 192
    self.predictions = nn.Linear(POOL_DIM, NUM_CLASSES)

  def forward(self, images: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    c = lambda name, x: getattr(self, name)(x)
    cat = lambda *xs: torch.cat(xs, dim=1)  # the JAX channel order
    x = images.permute(0, 3, 1, 2)
    for name in ('conv0', 'conv1', 'conv2'):
      x = c(name, x)
    x = _max_pool_3x3_s2(x)
    x = c('conv4', c('conv3', x))
    x = _max_pool_3x3_s2(x)

    for i in range(3):
      x = cat(c(f'mixed{i}_b1x1', x),
              c(f'mixed{i}_b5b', c(f'mixed{i}_b5a', x)),
              c(f'mixed{i}_b3c', c(f'mixed{i}_b3b', c(f'mixed{i}_b3a', x))),
              c(f'mixed{i}_bp', _avg_pool_same(x)))

    x = cat(c('mixed3_b3', x),
            c('mixed3_bdc', c('mixed3_bdb', c('mixed3_bda', x))),
            _max_pool_3x3_s2(x))

    for i in range(4, 8):
      b7 = x
      for name in ('b7a', 'b7b', 'b7c'):
        b7 = c(f'mixed{i}_{name}', b7)
      bd = x
      for name in ('bda', 'bdb', 'bdc', 'bdd', 'bde'):
        bd = c(f'mixed{i}_{name}', bd)
      x = cat(c(f'mixed{i}_b1x1', x), b7, bd,
              c(f'mixed{i}_bp', _avg_pool_same(x)))

    b7 = x
    for name in ('b7a', 'b7b', 'b7c', 'b7d'):
      b7 = c(f'mixed8_{name}', b7)
    x = cat(c('mixed8_b3b', c('mixed8_b3a', x)), b7, _max_pool_3x3_s2(x))

    for i in (9, 10):
      b3 = c(f'mixed{i}_b3a', x)
      bd = c(f'mixed{i}_bdb', c(f'mixed{i}_bda', x))
      x = cat(c(f'mixed{i}_b1x1', x),
              c(f'mixed{i}_b3b1', b3), c(f'mixed{i}_b3b2', b3),
              c(f'mixed{i}_bdc1', bd), c(f'mixed{i}_bdc2', bd),
              c(f'mixed{i}_bp', _avg_pool_same(x)))

    pool = x.mean(dim=(2, 3))  # avg_pool, 2048-d
    return pool, F.softmax(self.predictions(pool), dim=-1)


@torch.no_grad()
def init_inception(generator: torch.Generator) -> InceptionV3:
  """InceptionV3 on the generator's device with deterministic random
  weights: glorot-uniform conv kernels, BatchNorm at the identity
  statistics, a lecun-normal head; every shift zero."""
  log.warning('InceptionV3 is running with DETERMINISTIC RANDOM weights: '
              'FID/IS values are a consistent RELATIVE metric only.')
  # Built without PyTorch's default init, which draws from the global RNG.
  with torch.device('meta'):
    model = InceptionV3()
  model.to_empty(device=generator.device)
  for module in model.modules():
    if isinstance(module, nn.Conv2d):
      weight = module.weight
      receptive = weight[0, 0].numel()
      limit = math.sqrt(6.0 / (receptive * (weight.shape[0]
                                            + weight.shape[1])))
      weight.uniform_(-limit, limit, generator=generator)
    elif isinstance(module, BatchNormNoScale):
      module.bias.zero_()
      module.running_mean.zero_()
      module.running_var.fill_(1.0)
  head = model.predictions
  head.weight.normal_(0.0, 1.0 / math.sqrt(POOL_DIM), generator=generator)
  head.bias.zero_()
  return model.eval().requires_grad_(False)


def inception_model(version: str = 'V3',
                    checkpoint_path: Optional[str] = None) -> InceptionV3:
  """InceptionV3 on the CPU, in eval mode (the JAX package's
  `inception_model`, its gin surface).

  checkpoint_path: None gives `init_inception` from seed 42 (a CPU
  generator, so every device evaluates with the same weights); a Keras
  `.h5` weights file converts through `load_keras_weights` (which needs
  h5py, and raises ImportError without it: never random weights); any
  other path is a file written by `torch.save(model.state_dict())`, as
  `python -m se3ds_torch.convert_inception` writes one.
  """
  if version != 'V3':
    raise ValueError(f'{version} is not valid input.')
  if checkpoint_path is None:
    return init_inception(torch.Generator().manual_seed(42))
  if checkpoint_path.endswith('.h5'):
    state = load_keras_weights(checkpoint_path)
  else:
    state = torch.load(checkpoint_path, map_location='cpu',
                       weights_only=True)
  with torch.device('meta'):
    model = InceptionV3()
  model.to_empty(device='cpu')
  model.load_state_dict(state)
  return model.eval().requires_grad_(False)


def conv_module_order():
  """ConvBN module names in graph order, matching the creation order of
  conv2d_<k>/batch_normalization_<k> layers in Keras InceptionV3."""
  names = ['conv0', 'conv1', 'conv2', 'conv3', 'conv4']
  for i in range(3):  # mixed 0..2
    names += [f'mixed{i}_b1x1', f'mixed{i}_b5a', f'mixed{i}_b5b',
              f'mixed{i}_b3a', f'mixed{i}_b3b', f'mixed{i}_b3c',
              f'mixed{i}_bp']
  names += ['mixed3_b3', 'mixed3_bda', 'mixed3_bdb', 'mixed3_bdc']
  for i in range(4, 8):
    names += [f'mixed{i}_b1x1', f'mixed{i}_b7a', f'mixed{i}_b7b',
              f'mixed{i}_b7c', f'mixed{i}_bda', f'mixed{i}_bdb',
              f'mixed{i}_bdc', f'mixed{i}_bdd', f'mixed{i}_bde',
              f'mixed{i}_bp']
  names += ['mixed8_b3a', 'mixed8_b3b', 'mixed8_b7a', 'mixed8_b7b',
            'mixed8_b7c', 'mixed8_b7d']
  for i in (9, 10):
    names += [f'mixed{i}_b1x1', f'mixed{i}_b3a', f'mixed{i}_b3b1',
              f'mixed{i}_b3b2', f'mixed{i}_bda', f'mixed{i}_bdb',
              f'mixed{i}_bdc1', f'mixed{i}_bdc2', f'mixed{i}_bp']
  return names


def load_keras_weights(h5_path: str) -> Dict[str, torch.Tensor]:
  """The port's InceptionV3 state dict from a Keras InceptionV3 weights
  `.h5` (the released ImageNet bundle
  `inception_v3_weights_tf_dim_ordering_tf_kernels.h5`, a `save_weights`
  file, or a whole-model save, whose weights sit under `model_weights/`).

  Layers map by creation order: Keras names them conv2d[_k] and
  batch_normalization[_k] in graph order (k sorted as a number), which is
  `conv_module_order()`.

  Raises:
    ImportError: without h5py (convert the file where h5py is installed
      with `python -m se3ds_torch.convert_inception`).
    ValueError: a file without InceptionV3's 94 conv and BN layers.
  """
  try:
    import h5py  # Conversion-time only: the card's machine has none.
  except ImportError as e:
    raise ImportError(
        'Reading a Keras .h5 needs h5py, which is not installed here. '
        'Convert the file once where h5py is installed: python -m '
        'se3ds_torch.convert_inception --h5 <file>.h5 --out <file>.pt, and '
        'pass the .pt as checkpoint_path.') from e

  def keras_index(name: str, stem: str) -> int:
    rest = name[len(stem):]
    return int(rest[1:]) if rest.startswith('_') else 0

  weights: dict = {}
  with h5py.File(h5_path, 'r') as f:
    root = f['model_weights'] if 'model_weights' in f else f

    def visit(name, obj):
      if isinstance(obj, h5py.Dataset):
        weights[name] = np.asarray(obj)

    root.visititems(visit)

  def find(layer: str, leaf: str):
    for name, arr in weights.items():
      parts = name.split('/')
      if layer in parts and parts[-1].split(':')[0] == leaf:
        return arr
    raise KeyError(f'{layer}/{leaf} not found in {h5_path}')

  def layers(stem: str):
    return sorted({n.split('/')[0] for n in weights
                   if n.split('/')[0].startswith(stem)},
                  key=lambda s: keras_index(s, stem))

  conv_layers, bn_layers = layers('conv2d'), layers('batch_normalization')
  order = conv_module_order()
  if len(conv_layers) != len(order) or len(bn_layers) != len(order):
    raise ValueError(
        f'Expected {len(order)} conv/bn layers, found {len(conv_layers)}/'
        f'{len(bn_layers)}')
  params = {module: {'conv': {'kernel': find(conv, 'kernel')},
                     'bn': {'bias': find(bn, 'beta')}}
            for module, conv, bn in zip(order, conv_layers, bn_layers)}
  batch_stats = {module: {'bn': {'mean': find(bn, 'moving_mean'),
                                 'var': find(bn, 'moving_variance')}}
                 for module, bn in zip(order, bn_layers)}
  params['predictions'] = {'kernel': find('predictions', 'kernel'),
                           'bias': find('predictions', 'bias')}
  return torch_state_dict_from_flax_inception(
      {'params': params, 'batch_stats': batch_stats})


def load_frozen_graph_v1(pb_path: str):
  """Inception V1 frozen-graph (.pb) loader, as the JAX package's: an
  auxiliary loader that imports TensorFlow lazily (the reference's public
  `inception_model` only builds 'V3', so V1 is dead surface there too).
  Returns a host callable `images -> (pool_3 features, softmax
  predictions)` pruned at the endpoints Mul:0 -> [pool_3:0, logits:0].
  """
  import tensorflow as tf  # This loader's reason to exist.

  with tf.io.gfile.GFile(pb_path, 'rb') as f:
    graph_def = tf.compat.v1.GraphDef.FromString(f.read())

  def import_graph():
    tf.compat.v1.import_graph_def(graph_def, name='')

  wrapped = tf.compat.v1.wrap_function(import_graph, signature=[])
  call_fn = wrapped.prune(INCEPTION_V1_INPUT,
                          [INCEPTION_V1_FINAL_POOL, INCEPTION_V1_OUTPUT])

  def forward(images):
    pools, logits = call_fn(tf.convert_to_tensor(images))
    preds = tf.nn.softmax(logits)
    return np.squeeze(np.asarray(pools)), np.asarray(preds)

  return forward


def torch_state_dict_from_flax_inception(variables: Mapping[str, Any]
                                         ) -> Dict[str, torch.Tensor]:
  """The port's InceptionV3 state_dict from the JAX package's variables
  ({'params', 'batch_stats'}, numpy or anything `np.asarray` reads).

  Conv kernels go from HWIO to OIHW, BatchNorm bias/mean/var to
  bias/running_mean/running_var, the Dense (2048, 1000) kernel to the
  (1000, 2048) Linear weight.
  """
  f32 = lambda v: torch.from_numpy(np.ascontiguousarray(
      np.asarray(v, np.float32)))
  params, stats = variables['params'], variables['batch_stats']
  state = {}
  for name, module in params.items():
    if name == 'predictions':
      state['predictions.weight'] = f32(np.asarray(module['kernel']).T)
      state['predictions.bias'] = f32(module['bias'])
      continue
    state[f'{name}.conv.weight'] = f32(
        np.asarray(module['conv']['kernel']).transpose(3, 2, 0, 1))
    state[f'{name}.bn.bias'] = f32(module['bn']['bias'])
    state[f'{name}.bn.running_mean'] = f32(stats[name]['bn']['mean'])
    state[f'{name}.bn.running_var'] = f32(stats[name]['bn']['var'])
  return state


def resize_for_inception(images: torch.Tensor) -> torch.Tensor:
  """(N, H, W, C) images resized to 299x299 as `jax.image.resize(...,
  'linear')` does: bilinear with half-pixel centres, antialiased (a
  triangle filter widened by the scale) when downsampling."""
  if images.shape[1:3] == (INPUT_SIZE, INPUT_SIZE):
    return images
  return image_ops.resize(images, (INPUT_SIZE, INPUT_SIZE), 'linear',
                          antialias=True)


@torch.no_grad()
def get_inception(images: torch.Tensor, model: InceptionV3
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
  """Resize to 299 + renorm [0,1]->[-1,1] + forward (JAX
  `inception.get_inception` with its default `re_normalize=True`).
  Returns (pool, predictions)."""
  images = torch.clamp(resize_for_inception(images) * 2 - 1.0, -1.0, 1.0)
  return model(images)
