"""`se3ds_torch.utils.flops.count_flops` against the JAX package's
`count_flops` (jaxpr traversal; `jax.make_jaxpr` only, no compile).

Both count 2 * MACs of matrix products and convolutions and ignore
elementwise work. Per op class:
* matrix products (the power iterations and sigma's gradient): equal,
  but for the unused power iterations the JAX jaxpr holds at eval;
* convolutions, forward and backward, as JAX lowers them (a strided
  conv's input gradient over the dilated output gradient, a transposed
  conv over its dilated input): equal layer by layer, below;
* what remains on the models comes from work the two packages do
  differently, measured on these tiny shapes: the port's 3x3 stride-2
  'SAME' transposed convs compute one output row and column more (then
  cropped: the forward and the weight gradient count (2H+1)(2W+1)
  positions against JAX's 2H * 2W), and the discriminator's final 4x4
  'SAME' conv pads its odd row and column before the convolution (its
  input gradient counts (H+1)(W+1) positions against H * W): port above
  JAX by 1.15% on the train-mode G forward and 0.83% on the train step;
  at eval the JAX package wraps the width once per conv chain and its
  convs run over the wrapped margins: port below JAX by 1.59%.
"""

import functools

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch.utils import flop_counter

from se3ds_torch.models import folding
from se3ds_torch.models import generator as gen_t
from se3ds_torch.models import layers
from se3ds_torch.train import state as state_t
from se3ds_torch.utils import flops as flops_t
from se3ds_tpu.models import discriminator as disc_j
from se3ds_tpu.models import generator as gen_j
from se3ds_tpu.train import state as state_j
from se3ds_tpu.utils import flops as flops_j
from test_torch_serving import one_torch_thread  # noqa: F401
import test_torch_train as train_t

pytestmark = pytest.mark.usefixtures('one_torch_thread')


def _jax_classes(jaxpr, out=None):
  """JAX's count split into matrix products and convolutions."""
  out = {'matmul': 0.0, 'conv': 0.0} if out is None else out
  for eqn in jaxpr.eqns:
    name = eqn.primitive.name
    if name == 'dot_general':
      out['matmul'] += flops_j._dot_general_flops(eqn)
    elif name == 'conv_general_dilated':
      out['conv'] += flops_j._conv_flops(eqn)
    else:
      for key in ('jaxpr', 'call_jaxpr'):
        sub = eqn.params.get(key)
        if sub is not None:
          _jax_classes(sub.jaxpr if hasattr(sub, 'jaxpr') else sub, out)
          break
  return out


def _port_classes(fn, *args):
  with flop_counter.FlopCounterMode(
      display=False, custom_mapping=flops_t._JAX_RULES) as counter:
    fn(*args)
  counts = counter.get_flop_counts()['Global']
  matmul = sum(v for k, v in counts.items() if 'mm' in str(k))
  return {'matmul': matmul, 'conv': counter.get_total_flops() - matmul}


# (kernel, stride, padding, transposed)
LAYERS = [(3, 1, 'VALID', False), (3, 2, 'VALID', False),
          (1, 2, 'VALID', False), (7, 2, ((3, 3), (3, 3)), False),
          (2, 2, 'VALID', True)]


@pytest.mark.parametrize('k,s,padding,transposed,grads',
                         [(*layer, 'both') for layer in LAYERS]
                         + [(2, 2, 'VALID', True, 'none')])
def test_conv_conventions_equal_jax(k, s, padding, transposed, grads):
  """One conv with both gradients, and a transposed conv's forward
  alone (the rule `FlopCounterMode` counts differently): equal counts
  (strided, padded and transposed convs)."""
  x = np.random.RandomState(0).rand(2, 8, 16, 4).astype(np.float32)
  layer = (nn.ConvTranspose if transposed else nn.Conv)(
      6, (k, k), (s, s), padding=padding, use_bias=False)
  variables = layer.init(jax.random.PRNGKey(0), x)
  loss = lambda v, x: jnp.sum(layer.apply(v, x) ** 2)
  fn = {'none': layer.apply, 'both': jax.grad(loss, argnums=(0, 1))}[grads]
  want = flops_j.count_flops(fn, variables, x)

  pad = 0 if isinstance(padding, str) else padding[0][0]
  weight = torch.randn((4, 6, k, k) if transposed else (6, 4, k, k),
                       requires_grad=True)
  x_t = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous()

  def port():
    inp = x_t.clone().requires_grad_(grads == 'both')
    conv = F.conv_transpose2d if transposed else F.conv2d
    out = conv(inp * 1, weight, stride=s, padding=pad)
    if grads == 'both':
      torch.autograd.grad((out ** 2).sum(), [weight, inp])
  assert flops_t.count_flops(port) == want


@pytest.mark.parametrize('train', [False, True])
def test_generator_forward_flops(train):
  """The tiny G forward: matrix products equal; convolutions within the
  stated differences (module docstring)."""
  batch = train_t._batch(1)
  cond = {k: batch[k] for k in ('proj_image', 'proj_depth', 'proj_mask',
                                'blurred_mask')}
  model_j = gen_j.ResNetGenerator(image_size=train_t.SIZE, **train_t.G_CONFIG)
  variables = train_t._random_variables(model_j, 0,
                                        {k: v[:1] for k, v in cond.items()})
  if train:
    apply = lambda v, c: model_j.apply(v, c, train=True,
                                       mutable=['batch_stats', 'spectral'])
  else:
    apply = lambda v, c: model_j.apply(v, c, train=False)
  want = _jax_classes(jax.make_jaxpr(apply)(variables, cond).jaxpr)
  assert sum(want.values()) == flops_j.count_flops(apply, variables, cond)

  model_t = gen_t.ResNetGenerator(spectral_fold=False, **train_t.G_CONFIG)
  folding.init_random_(model_t, torch.Generator().manual_seed(0))
  model_t.train(train)
  with torch.no_grad():
    got = _port_classes(model_t, {k: torch.from_numpy(v)
                                  for k, v in cond.items()})
  # At eval the JAX jaxpr also holds the partial convs' power iterations,
  # whose result the reference never uses (XLA drops them as dead code;
  # the port does not run them): u w^T, v w and sigma, 6 K O + 2 O each.
  unused = 0 if train else sum(
      6 * m.weight[0].numel() * m.weight.shape[0] + 2 * m.weight.shape[0]
      for m in model_t.modules()
      if isinstance(m, layers.PartialConv) and m.u is not None)
  assert got['matmul'] + unused == want['matmul']
  ratio = got['conv'] / want['conv']
  assert (1.0 < ratio < 1.0125) if train else (0.98 < ratio < 1.0), ratio


def test_train_step_flops():
  """The tiny train step (2 chunks: a D-only step, then G+D): matrix
  products equal; convolutions within the stated differences; the count
  on the meta device equals the count on the CPU."""
  batch = train_t._batch(1)
  generator = gen_j.ResNetGenerator(image_size=train_t.SIZE, **train_t.G_CONFIG)
  discriminator = disc_j.SNMultiScaleDiscriminator(**train_t.D_CONFIG)
  cond = {k: batch[k][:1] for k in ('proj_image', 'proj_depth', 'proj_mask',
                                    'blurred_mask')}
  g_vars = train_t._random_variables(generator, 0, cond)
  d_vars = train_t._random_variables(
      discriminator, 1, np.zeros((2, train_t.SIZE, 2 * train_t.SIZE, 4),
                                 np.float32))
  g_tx, d_tx = state_j.make_optimizers(train_t.OPT['g_lr'],
                                       train_t.OPT['d_lr'],
                                       train_t.OPT['beta1'],
                                       train_t.OPT['beta2'])
  g_state = {k: v for k, v in g_vars.items() if k != 'params'}
  start = state_j.TrainState(
      step=jnp.zeros((), jnp.int32), g_params=g_vars['params'],
      g_state=g_state, d_params=d_vars['params'],
      d_state={'spectral': d_vars['spectral']}, ema_params=g_vars['params'],
      ema_state=g_state, g_opt_state=g_tx.init(g_vars['params']),
      d_opt_state=d_tx.init(d_vars['params']))
  step = functools.partial(state_j.train_step, generator=generator,
                           discriminator=discriminator, g_tx=g_tx, d_tx=d_tx,
                           hp=state_j.GANHParams(**train_t.HP))
  want = _jax_classes(jax.make_jaxpr(step)(start, batch).jaxpr)

  hp = state_t.GANHParams(**train_t.HP)
  port = train_t._port_state(train_t._numpy_state(start))
  meta = state_t.create_train_state(
      *(m.to('meta') for m in train_t._port_models()), **train_t.OPT)
  got = _port_classes(state_t.train_step, port, train_t._torch(batch), hp)
  assert got['matmul'] == want['matmul']
  ratio = got['conv'] / want['conv']
  assert 1.0 < ratio < 1.01, ratio
  meta_batch = {k: v.to('meta') for k, v in train_t._torch(batch).items()}
  assert flops_t.count_flops(state_t.train_step, meta, meta_batch, hp) == sum(
      got.values())
