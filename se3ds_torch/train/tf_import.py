"""Imports the reference's TF checkpoints into the port's models (port of
`se3ds_tpu.train.tf_import`).

Maps the keys of a `tf.train.Checkpoint(ema_generator=...)` bundle (the
format of the released MP3D and RE10K checkpoints) onto the port's state
dict. The bundle is read by `train.tf_bundle.BundleReader`, without
TensorFlow.

The grammar is the JAX package's, written against the port's module
names, which are the Flax ones without the Flax child modules `bn` (a
BatchNorm's) and `convt` (a transposed conv's).

Layouts:
* Conv kernels: Keras HWIO -> OIHW, `transpose(3, 2, 0, 1)`.
* Conv2DTranspose kernels: Keras stores HWOI, so the port's
  (in, out, kh, kw) weight is the same `transpose(3, 2, 0, 1)`, with no
  spatial flip: the JAX package flips these kernels for Flax's
  `ConvTranspose`, and its bridge to the port flips them back.
* BatchNorm: weight/bias/running_mean/running_var <-
  gamma/beta/moving_mean/moving_variance; InstanceNorm weight/bias <-
  gamma/beta; a conv's bias is `bias` (a layer has `bias` or `beta`,
  never both, so the existing key decides).
* Spectral-norm `u` vectors are stored under autonumbered attribute names
  (`spectral_conv_<k>_u`) and are matched by the layer's prefix and the
  `_u` suffix.
"""

from __future__ import annotations

import re
from typing import Callable, Dict, Optional

import torch
from torch import nn

from se3ds_torch.models import folding
from se3ds_torch.train import tf_bundle

ATTR_SUFFIX = '/.ATTRIBUTES/VARIABLE_VALUE'

# The TF leaf names a state-dict leaf may have, in the order tried.
_LEAVES = {'weight': ('kernel', 'gamma'), 'bias': ('bias', 'beta'),
           'running_mean': ('moving_mean',),
           'running_var': ('moving_variance',)}

# Output heads and the global context: bnK/convK -> a Sequential index.
_HEAD_RE = re.compile(r'^(rgb_conv|depth_conv|global_context)\.'
                      r'(bn|conv)(\d+)$')

# The last module name of a block or stage -> its TF object path.
_LAST = {
    # TransBasicBlock.
    'main_conv1': 'main/layer_with_weights-0',
    'main_bn1': 'main/layer_with_weights-1',
    'main_conv2': 'main/layer_with_weights-2/layer_with_weights-0',
    'main_convt': 'main/layer_with_weights-2',
    'main_bn2': 'main/layer_with_weights-3',
    'up_conv': 'upsample/layer_with_weights-0',
    'up_convt': 'upsample/layer_with_weights-0',
    'up_bn': 'upsample/layer_with_weights-1',
    # Bottleneck norms (act1/act2 are Sequential[BN, ReLU]; act3 is a bare
    # BN layer) and the encoder's stem.
    'act1_bn': 'act1/layer_with_weights-0',
    'act2_bn': 'act2/layer_with_weights-0',
    'act3_bn': 'act3',
    # Decoder.
    'upc_conv': 'upc/layer_with_weights-0',
    'upc_bn': 'upc/layer_with_weights-1',
}


def torch_path_to_tf_prefix(path: str) -> str:
  """Maps a module name of the port's generator (e.g.
  'decoder.deconv2.block0.main_convt') to its TF object path under the
  checkpoint's root."""
  head = _HEAD_RE.match(path)
  if head:
    stack, kind, idx = head.groups()
    tf_stack = ('global_context_layer' if stack == 'global_context'
                else stack)
    return (f'{tf_stack}/layer_with_weights-'
            f'{2 * int(idx) + (kind == "conv")}')
  *parents, last = path.split('.')
  if parents == ['encoder'] and last == 'final_bn':
    last = 'final_act/layer_with_weights-0'
  last = re.sub(r'^agent(\d)_bn$', r'agent\1_act/layer_with_weights-0',
                _LAST.get(last, last))
  path = '/'.join(parents + [last])
  # ResStack blocks: stackN/blockI -> stackN/blocks/I; the transposed
  # stacks: deconvN/blockI -> deconvN/block/layer_with_weights-I.
  path = re.sub(r'(^|/)(stack\d)/block(\d+)/', r'\1\2/blocks/\3/', path)
  return re.sub(r'(deconv\d|final_conv)/block(\d+)/',
                r'\1/block/layer_with_weights-\2/', path)


def discriminator_path_map(n_layers: int) -> Callable[[str], str]:
  """Path mapper for `SNMultiScaleDiscriminator` checkpoints:
  `discriminators/<d>/discriminator_groups/<g>/layer_with_weights-{0,1}`
  for the conv and InstanceNorm of each group, and
  `discriminator_groups/<n_layers>` for the bare final conv."""

  def map_path(path: str) -> str:
    m = re.match(r'^dis(\d+)\.(.*)$', path)
    if not m:
      return path
    d, rest = m.groups()
    prefix = f'discriminators/{d}/discriminator_groups'
    group = re.match(r'^group(\d+)_(conv|norm)$', rest)
    if group:
      return (f'{prefix}/{group.group(1)}/layer_with_weights-'
              f'{int(group.group(2) == "norm")}')
    if rest == 'final_conv':
      return f'{prefix}/{n_layers}'
    return f'discriminators/{d}/{rest.replace(".", "/")}'

  return map_path


def convert_tf_checkpoint(ckpt_path: str, model: nn.Module,
                          root: str = 'ema_generator',
                          path_map: Optional[Callable[[str], str]] = None
                          ) -> Dict[str, torch.Tensor]:
  """Loads a reference TF checkpoint into `model`'s state-dict layout.

  Args:
    ckpt_path: the bundle's prefix.
    model: the port's module in its trainable form (a generator with
      `spectral_fold=False`, or a discriminator), on any device: only its
      state dict's names, shapes and dtypes are read, so a model on the
      meta device keeps the conversion's memory to the converted branch
      (tensors are read one at a time).
    root: the checkpoint's root attribute ('ema_generator' or
      'generator' for a generator, 'discriminator' for a discriminator).
    path_map: module name -> TF object path under `root`
      (default `torch_path_to_tf_prefix`).

  Returns:
    {state-dict key: CPU tensor} for every key of `model.state_dict()`.

  Raises:
    KeyError: leaves that resolve to no key, or to one of another shape
      (up to 8 of them named).
    ValueError: a model with folded spectral kernels (build it with
      `spectral_fold=False`, then fold with `folding.serving_state_dict`).
  """
  if folding.spectral_conv_names(model):
    raise ValueError('convert_tf_checkpoint needs the trainable form of the '
                     'model (spectral_fold=False): a checkpoint holds raw '
                     'kernels and their u.')
  path_map = path_map or torch_path_to_tf_prefix
  reader = tf_bundle.BundleReader(ckpt_path)
  tf_keys = set(reader.get_variable_to_shape_map())

  # Prefix -> leaf names, for the u-vector lookup.
  by_prefix: Dict[str, list] = {}
  for k in tf_keys:
    if k.endswith(ATTR_SUFFIX) and '/' in k[:-len(ATTR_SUFFIX)]:
      prefix, leaf = k[:-len(ATTR_SUFFIX)].rsplit('/', 1)
      by_prefix.setdefault(prefix, []).append(leaf)

  def resolve(module: str, leaf: str) -> Optional[str]:
    prefix = f'{root}/{path_map(module)}'
    if leaf == 'u':
      for cand in sorted(by_prefix.get(prefix, [])):
        if cand.endswith('_u'):
          return f'{prefix}/{cand}{ATTR_SUFFIX}'
      return None
    for cand in _LEAVES.get(leaf, ()):
      key = f'{prefix}/{cand}{ATTR_SUFFIX}'
      if key in tf_keys:
        return key
    return None

  state, errors = {}, []
  for name, template in model.state_dict().items():
    module, leaf = name.rsplit('.', 1)
    tf_key = resolve(module, leaf)
    if tf_key is None:
      errors.append(name)
      continue
    value = torch.from_numpy(reader.get_tensor(tf_key))
    if value.dim() == 4:  # HWIO (HWOI for a transposed conv) -> the port's
      value = value.permute(3, 2, 0, 1).contiguous()
    if value.shape != template.shape:
      errors.append(f'{name}: shape {tuple(value.shape)} vs '
                    f'{tuple(template.shape)} (tf key {tf_key})')
      continue
    state[name] = value.to(template.dtype)
  if errors:
    raise KeyError(f'{len(errors)} unresolved/mismatched leaves, e.g. '
                   f'{errors[:8]}')
  return state
