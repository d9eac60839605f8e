"""The GAN train step, in a loop over batches made on the card.

Set-up builds the trainer as the CLI does, through the port's gin subset
(`config.apply_config('GAN', ...)`) from the bindings in the cell's
config file, loads the benchmark's seeded weights into its state through
the Flax bridge (`folding.torch_state_dict_from_flax`), sets its step
past the recipe's first `num_batched_steps` (as a resumed job's, so that
the EMA decays rather than copies), makes the batches on the card from
the seed, and drives that same state through its first three
`train_step`s (batches 0-2, all rows different), which also warm up
every shape. The window runs `train_step` in a loop over the batches
(3, 0, 1, ...), with a synchronise at its end.

The correctness check follows the first three steps with the plain
reference (`reference/training.py`) from the same weights and batches
and reads each step's losses, each parameter's first Adam moment after
step 1 (the first gradients as the optimizers got them, clipped) and
each parameter's change over the three steps (the generator's, the
discriminator's and the EMA's), as gaps between the two norms. The
numbers held to limits are the steady ones: step 1's world-consistency
loss (the generator's first forward, before any update), and, for each
model apart (`g`, `d`, `ema`), its median leaf's first-moment and change
gaps. The worst leaf and the later losses swing with round-off: two
float32 runs of the reference that differ only in the order of a
chunk's rows read them as far apart as the program with TF32 off does
(PERF.md, PR 12), so they are reported and not held. The data pipeline
is bypassed.
"""

from __future__ import annotations

import ast
import statistics
import time
from typing import Dict, List

import torch

from benchmark import harness
from benchmark import trace as trace_lib
from benchmark import weights as weights_lib
from benchmark.drivers import serving
from benchmark.reference import discriminator as ref_disc
from benchmark.reference import flops as ref_flops
from benchmark.reference import generator as ref_gen
from benchmark.reference import training as ref_train

# A leaf whose reference gradient is below this share of the median
# leaf's moves under Adam by round-off alone (a conv bias ahead of a
# BatchNorm): its change is not compared.
NEGLIGIBLE_GRADIENT = 1e-3
MODELS = ('g.', 'd.', 'ema.')
LOSSES = ('gen/gen_loss', 'dis/disc_loss', 'gen/depth_loss', 'gen/wc_loss',
          'gen/gen_gan_loss')


def gin_values(lines: List[str]) -> Dict[str, object]:
  """'a.b = literal' bindings as {'a.b': value} (references skipped)."""
  out = {}
  for line in lines:
    key, value = (part.strip() for part in line.split('=', 1))
    try:
      out[key] = ast.literal_eval(value)
    except (ValueError, SyntaxError):
      continue
  return out


class Spec:
  """The sizes and the hyper-parameters of the config's bindings."""

  def __init__(self, config):
    g = gin_values(config['gin'])
    self.image_size = g['GAN.image_size']
    self.chunk = g['GAN.train_batch_size']
    self.gen_dims = g['image_models.ResNetGenerator.gen_dims']
    self.resnet = g['image_models.ResNetGenerator.resnet_version']
    self.dis_dims = g['image_models.SNMultiScaleDiscriminator.dis_dims']
    self.n_dis = g['image_models.SNMultiScaleDiscriminator.n_dis']
    self.n_layers = g['image_models.SNMultiScaleDiscriminator.n_layers']
    self.hyper = ref_train.Hyper(
        g_lr=g['GAN.g_lr'], d_lr=g['GAN.d_lr'], beta1=g['GAN.beta1'],
        beta2=g.get('GAN.beta2', 0.999),
        d_step_per_g_step=g['GAN.d_step_per_g_step'],
        lambda_gan=g['GAN.lambda_gan'], lambda_wc=g['GAN.lambda_wc'],
        lambda_depth=g['GAN.lambda_depth'],
        ema_decay=g.get('GAN.ema_decay', 0.999))
    # The first step past the EMA's copy phase.
    self.start_step = (g.get('GAN.ema_init_step', 0)
                       + g.get('GAN.num_batched_steps', 5))
    self.step_examples = self.chunk * self.hyper.d_step_per_g_step

  def models(self, device, numerics):
    with torch.device(device):
      g = ref_gen.Generator(self.gen_dims, self.resnet, True, numerics)
      d = ref_disc.Discriminator(self.dis_dims, self.n_dis, self.n_layers,
                                 numerics=numerics)
    return g, d


def make_batches(spec: Spec, count: int, seed: int, device):
  """`count` batches of one train_step's examples, drawn on the card as
  `trainer.synthetic_batches` draws them."""
  gen = torch.Generator(device=device).manual_seed(seed + 1)
  n, h = spec.step_examples, spec.image_size
  shape = (count, n, h, 2 * h)
  u = lambda c: torch.rand(shape + (c,), generator=gen, device=device)
  stack = {'image': u(3), 'depth': u(1) * 1.2 - 0.1, 'proj_image': u(3),
           'proj_depth': u(1), 'proj_mask': (u(1) > 0.3).float(),
           'blurred_mask': (u(1) > 0.9).float()}
  return [{k: v[i] for k, v in stack.items()} for i in range(count)]


def leaf_norms(named) -> Dict[str, float]:
  names, tensors = zip(*named)
  norms = torch.stack(torch._foreach_norm([t.float() for t in tensors]))
  return dict(zip(names, norms.tolist()))


class Reading:
  """One training run's numbers: losses per step, first moments after
  step 1 and changes after step 3, by leaf ('g.<name>', 'd.<name>',
  'ema.<name>')."""

  def __init__(self):
    self.losses: List[List[float]] = []
    self.moments: Dict[str, float] = {}
    self.change: Dict[str, float] = {}


def _gaps(p: Dict[str, float], r: Dict[str, float], keep=None
          ) -> Dict[str, float]:
  """Each leaf's gap of norms, against the larger of its reference norm
  and its model's median leaf's."""
  out = {}
  for model in MODELS:
    names = [n for n in r if n.startswith(model) and (keep is None
                                                      or keep(n))]
    if not names:
      continue
    median = statistics.median(r[n] for n in names)
    for n in names:
      out[n] = abs(p[n] - r[n]) / max(r[n], median, 1e-30)
  return out


def compare(prog: Reading, ref: Reading) -> Dict[str, float]:
  """The gaps of `prog` against `ref`: the losses' by step, and per
  model (`.g`, `.d`, `.ema`) the median and the worst leaf's first-moment
  and change gaps, with how many leaves' changes were left out
  (negligible reference gradient)."""
  loss_gap = max(abs(a - b) / max(abs(b), 1e-6)
                 for pa, pb in zip(prog.losses, ref.losses)
                 for a, b in zip(pa[:2], pb[:2]))
  floors = {}
  for model in ('g.', 'd.'):
    values = [v for n, v in ref.moments.items() if n.startswith(model)]
    floors[model] = NEGLIGIBLE_GRADIENT * statistics.median(values)

  def kept(name):
    model, leaf = name.split('.', 1)
    source = 'g.' if model == 'ema' else model + '.'
    return ref.moments[source + leaf] >= floors[source]

  excluded = sum(1 for n in ref.change if not kept(n))
  grad, change = _gaps(prog.moments, ref.moments), _gaps(
      prog.change, ref.change, kept)
  step_gaps = [[abs(a - b) / max(abs(b), 1e-6) for a, b in zip(pa, pb)]
               for pa, pb in zip(prog.losses, ref.losses)]
  out = {'loss_gap': loss_gap,
         'loss_gap.step1': max(step_gaps[0][LOSSES.index(k)]
                               for k in ('gen/depth_loss', 'gen/wc_loss')),
         'wc_gap.step1': step_gaps[0][LOSSES.index('gen/wc_loss')],
         'grad_gap': max(grad.values()),
         'change_gap': max(change.values()),
         'leaves_left_out': float(excluded),
         'loss_gaps_by_step': step_gaps}
  for model in MODELS:
    for kind, gaps in (('grad', grad), ('change', change)):
      values = sorted((v, n) for n, v in gaps.items() if n.startswith(model))
      if values:
        out[f'{kind}_gap_median.{model[:-1]}'] = statistics.median(
            v for v, _ in values)
        out[f'{kind}_gap.{model[:-1]}'] = values[-1][0]
        out[f'{kind}_worst.{model[:-1]}'] = values[-1][1]
  return out


def run(cell, seed: int, seconds: float, trace: bool, device,
        started: float, control: bool = False) -> harness.Outcome:
  from se3ds_torch import config as config_lib
  from se3ds_torch.models import folding
  from se3ds_torch.train import state as state_lib
  from se3ds_torch.train import trainer as trainer_lib  # noqa: F401 (gin names)

  p = cell.traffic
  spec = Spec(cell.config)
  with torch.device('meta'):
    g_meta, d_meta = spec.models('meta', ref_gen.Numerics(train=True))
  g_leaves = weights_lib.flax_leaves(g_meta, trainable=True)
  d_leaves = weights_lib.flax_leaves(d_meta, trainable=True)
  g_host = weights_lib.Weights.make(g_leaves, seed, device).to('cpu')
  d_host = weights_lib.Weights.make(d_leaves, seed + 1, device).to('cpu')
  harness.release(device)
  harness.log(started, 'weights made')

  config_lib.clear_config()
  config_lib.parse_config('\n'.join(cell.config['gin']))
  trainer = config_lib.apply_config('GAN', model_dir='', device=device)
  state = trainer.create_state()
  g_state = folding.torch_state_dict_from_flax(g_host.numpy_tree(),
                                               state.generator)
  state.generator.load_state_dict(g_state)
  state.ema.load_state_dict(g_state)
  state.discriminator.load_state_dict(folding.torch_state_dict_from_flax(
      d_host.numpy_tree(), state.discriminator))
  del g_state
  state.step = spec.start_step
  batches = make_batches(spec, p['batches'], seed, device)
  harness.log(started, 'program built')

  prog = Reading()
  named = lambda: [*(('g.' + n, t) for n, t in
                     state.generator.named_parameters()),
                   *(('d.' + n, t) for n, t in
                     state.discriminator.named_parameters())]
  start = {n: t.detach().clone() for n, t in named()}
  for i in range(p['warmup_steps']):
    metrics = state_lib.train_step(state, batches[i], trainer.hp)
    prog.losses.append([float(metrics[k]) for k in LOSSES])
    if i == 0:
      optimizer = lambda n: state.g_opt if n[0] == 'g' else state.d_opt
      prog.moments = leaf_norms(
          [(n, optimizer(n).state[t]['exp_avg']) for n, t in named()])
  prog.change = leaf_norms([(n, t - start[n]) for n, t in named()])
  prog.change.update(leaf_norms(
      [('ema.' + n, t - start['g.' + n])
       for n, t in state.ema.named_parameters()]))
  del start
  harness.release(device)
  harness.log(started, 'warmed up')

  harness.sync(device)
  harness.reset_peak(device)
  w0 = time.perf_counter()
  steps = 0
  while True:
    state_lib.train_step(state, batches[(p['warmup_steps'] + steps)
                                        % len(batches)], trainer.hp)
    steps += 1
    if time.perf_counter() - w0 >= seconds:
      break
  harness.sync(device)
  window_s = time.perf_counter() - w0
  memory_peak = harness.peak_bytes(device)
  harness.log(started, f'window: {steps} steps in {window_s:.3f} s')

  spans = harness.Spans()
  summary = None
  if trace:
    upcoming = iter(range(p['trace_warmup'] + p['trace_steps']))
    summary = trace_lib.traced(
        lambda: state_lib.train_step(
            state, batches[next(upcoming) % len(batches)], trainer.hp),
        p['trace_warmup'], p['trace_steps'])
    spans.counters['steps_traced'] = p['trace_steps']
    harness.log(started, 'traced')
  spans.counters['flops_per_step'] = step_flops(spec)
  spans.counters['peak_bytes'] = memory_peak
  del state, trainer
  harness.release(device)

  ref = follow(spec, g_host, d_host, batches[:p['warmup_steps']], device,
               ref_gen.Numerics(train=True, checkpoint=True))
  readings = compare(prog, ref)
  control_readings = {}
  if control:
    for name, numerics, rows in (
        ('bf16', ref_gen.Numerics(train=True, bf16=True, checkpoint=True),
         None),
        ('half_batch', ref_gen.Numerics(train=True, checkpoint=True), 'half'),
        ('reordered', ref_gen.Numerics(train=True, checkpoint=True),
         'reversed')):
      other = follow(spec, g_host, d_host, batches[:p['warmup_steps']],
                     device, numerics, rows=rows)
      control_readings[name] = compare(other, ref)
  harness.log(started, 'compared')
  checks = {name: (readings[name], cell.limits[name]) for name in cell.limits}
  end_to_end = {'train_examples_per_s': steps * spec.step_examples / window_s,
                'setup_s': w0 - started}
  return harness.Outcome(
      end_to_end, harness.Record(cell, spans, summary), checks,
      attempted=steps, failed=0, memory_peak_bytes=memory_peak,
      readings={'program': readings, 'control': control_readings})


def follow(spec: Spec, g_host, d_host, batches, device, numerics,
           rows=None) -> Reading:
  """The reference's first steps from the same weights and batches.
  `rows` 'half' leaves out the second half of each chunk's rows (a fault
  the comparison must catch); 'reversed' takes each chunk's rows in the
  reverse order, the same sums in another order (a witness of what
  float32 round-off alone moves)."""
  g, d = spec.models(device, numerics)
  ref_gen.load_flax(g, g_host.to(device).tree, fold_spectral=False)
  ref_gen.load_flax(d, d_host.to(device).tree, fold_spectral=False)
  trainer = ref_train.Trainer(g, d, spec.hyper)
  named = lambda: [*(('g.' + n, t) for n, t in g.named_parameters()),
                   *(('d.' + n, t) for n, t in d.named_parameters())]
  start = {n: t.detach().clone() for n, t in named()}
  ema_start = [t.detach().clone() for t in trainer.ema]
  out = Reading()
  moments = {**{'g.' + n: m for (n, _), m in
                zip(g.named_parameters(), trainer.g_opt.m)},
             **{'d.' + n: m for (n, _), m in
                zip(d.named_parameters(), trainer.d_opt.m)}}
  with serving.strict_float32():
    for i, batch in enumerate(batches):
      if rows is not None:
        k = spec.hyper.d_step_per_g_step
        pick = ((lambda c: c[:c.shape[0] // 2]) if rows == 'half' else
                (lambda c: c.flip(0)))
        batch = {key: torch.cat([pick(c) for c in v.chunk(k)])
                 for key, v in batch.items()}
      metrics = trainer.step(batch)
      out.losses.append([float(metrics[k]) for k in LOSSES])
      if i == 0:
        out.moments = leaf_norms(list(moments.items()))
  out.change = leaf_norms([(n, t - start[n]) for n, t in named()])
  out.change.update(leaf_norms(
      [('ema.' + n, t - t0) for (n, _), t, t0 in
       zip(g.named_parameters(), trainer.ema, ema_start)]))
  return out


def step_flops(spec: Spec) -> int:
  """Matmul and conv FLOPs of one reference train_step at the cell's
  sizes, without recomputation, counted on the meta device."""
  g, d = spec.models('meta', ref_gen.Numerics(train=True))
  for module in (g, d):
    for _, m, kind in ref_gen.leaves(module):
      if kind == 'conv' and (m.spectral or m.inert_u):
        m.u = torch.empty((1, m.weight.shape[0]), device='meta')
  trainer = ref_train.Trainer(g, d, spec.hyper)
  n, h = spec.step_examples, spec.image_size
  batch = {k: torch.empty((n, h, 2 * h, c), device='meta')
           for k, c in (('image', 3), ('depth', 1), ('proj_image', 3),
                        ('proj_depth', 1), ('proj_mask', 1),
                        ('blurred_mask', 1))}
  return ref_flops.count(trainer.step, batch)

