"""Port parity: the gin configuration against the JAX package, on the CPU.

The repo's three gin files give the same bindings in the port's registry
as in the JAX package's; `apply_config('GAN')` builds a port `Trainer`
whose attributes equal the JAX `Trainer`'s (apart from the mesh and the
device); a generator built from gin comes out trainable, and its eval
equals the folded serving form; `inception_model` gives seeded, saved or
refused weights; and the CLI's flags parse as the JAX `main.py`'s.
"""

import os
import sys

import numpy as np
import pytest
import torch

from se3ds_torch import config as config_t
from se3ds_torch import main as main_t
from se3ds_torch.eval import inception as inception_t
from se3ds_torch.models import folding as folding_t
from se3ds_torch.models import generator as gen_t
from se3ds_torch.parallel import mesh
from se3ds_torch.train import trainer as trainer_t
from se3ds_tpu import config as config_j
from se3ds_tpu.train import trainer as trainer_j

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GIN_FILES = ['configs/lowres/lowres.gin', 'configs/highres/highres.gin',
             'configs/tiny_test.gin']


@pytest.fixture(autouse=True)
def clear_configs():
  config_t.clear_config()
  config_j.clear_config()
  yield
  config_t.clear_config()
  config_j.clear_config()


def _plain(value):
  """A binding with references replaced by their names."""
  if isinstance(value, (config_t.ConfigurableReference,
                        config_j.ConfigurableReference)):
    return ('@', value.name)
  return value


def _bindings(module):
  return {target: {k: _plain(v) for k, v in params.items()}
          for target, params in module._BINDINGS.items()}


@pytest.mark.parametrize('path', GIN_FILES)
def test_repo_gin_files_bind_the_same_in_both_registries(path):
  for module in (config_t, config_j):
    module.parse_config_files_and_bindings([os.path.join(REPO, path)])
  assert _bindings(config_t) == _bindings(config_j)
  assert config_t._MACROS == config_j._MACROS
  bound = _bindings(config_t)
  assert bound['GAN']['generator_fn'] == ('@', 'image_models.ResNetGenerator')
  if 'tiny' not in path:
    assert bound['ResNetDecoder'] == {'partial_conv': True}
  for name in ('GAN', 'ResNetGenerator', 'SNMultiScaleDiscriminator',
               'R2RImageDataset', 'R2RVideoDataset', 'inception_model'):
    assert config_t.resolve(name) is not None


def _attributes(trainer, skip):
  return {k: _plain(v) for k, v in vars(trainer).items() if k not in skip}


def test_gan_from_tiny_gin_equals_the_jax_trainer(tmp_path):
  """Every attribute of the JAX trainer but its mesh (mesh, num_replicas,
  shard_opt_state, the dataset lock) has the port's value; the port adds
  only its device and its place on the data axis (`data`, world 1 here:
  no process group). The loss weights and schedule compare as dicts."""
  path = os.path.join(REPO, 'configs/tiny_test.gin')
  for module in (config_t, config_j):
    module.parse_config_files_and_bindings([path])
  port = config_t.apply_config('GAN', model_dir=str(tmp_path / 't'),
                               device='cpu')
  jax_trainer = config_j.apply_config('GAN', model_dir=str(tmp_path / 'j'))
  assert port.data == mesh.DataParallel(1, 0)
  got = _attributes(port, {'device', 'data', '_ds_lock', 'hp', 'model_dir'})
  want = _attributes(jax_trainer, {'mesh', 'num_replicas', 'shard_opt_state',
                                   '_ds_lock', 'hp', 'model_dir'})
  assert got == want
  assert port.hp._asdict() == {
      k: v for k, v in jax_trainer.hp._asdict().items()
      if k in port.hp._fields}
  assert isinstance(port, trainer_t.Trainer)
  assert isinstance(jax_trainer, trainer_j.Trainer)


def test_generator_from_gin_is_trainable_and_evaluates_as_folded(tmp_path):
  config_t.parse_config_files_and_bindings(
      [os.path.join(REPO, 'configs/tiny_test.gin')])
  trainer = config_t.apply_config('GAN', model_dir=str(tmp_path),
                                  device='cpu')
  state = trainer.create_state()
  generator = state.generator
  assert isinstance(generator, gen_t.ResNetGenerator)
  assert any(k.endswith('.u') for k in generator.state_dict())
  assert all(p.requires_grad for p in generator.parameters())
  serving = gen_t.ResNetGenerator(gen_dims=2, z_dim=2, resnet_version='tiny')
  serving.load_state_dict(folding_t.serving_state_dict(generator))
  rs = np.random.RandomState(0)
  cond = {k: torch.from_numpy(rs.rand(1, 32, 64, c).astype(np.float32))
          for k, c in (('proj_image', 3), ('proj_depth', 1),
                       ('proj_mask', 1), ('blurred_mask', 1))}
  with torch.no_grad():
    for a, b in zip(generator.eval()(cond), serving.eval()(cond)):
      assert torch.equal(a, b)
  assert state.discriminator.__class__.__name__ == 'SNMultiScaleDiscriminator'


def test_inception_model_weights(tmp_path, monkeypatch):
  seeded = inception_t.inception_model()
  want = inception_t.init_inception(torch.Generator().manual_seed(42))
  for (name, a), b in zip(seeded.state_dict().items(),
                          want.state_dict().values()):
    assert torch.equal(a, b), name
  path = str(tmp_path / 'inception.pt')
  torch.save(seeded.state_dict(), path)
  loaded = inception_t.inception_model(checkpoint_path=path)
  assert not loaded.training
  for a, b in zip(loaded.state_dict().values(), seeded.state_dict().values()):
    assert torch.equal(a, b)
  # A Keras .h5 of the same weights (Keras names and layouts) loads, and
  # without h5py raises ImportError, never giving random weights.
  import h5py
  h5 = str(tmp_path / 'inception.h5')
  state = seeded.state_dict()
  with h5py.File(h5, 'w') as f:
    for k, module in enumerate(inception_t.conv_module_order()):
      conv, bn = [f'{stem}_{k}' if k else stem
                  for stem in ('conv2d', 'batch_normalization')]
      f[f'{conv}/{conv}/kernel:0'] = state[
          f'{module}.conv.weight'].numpy().transpose(2, 3, 1, 0)
      for leaf, name in (('beta', 'bias'), ('moving_mean', 'running_mean'),
                         ('moving_variance', 'running_var')):
        f[f'{bn}/{bn}/{leaf}:0'] = state[f'{module}.bn.{name}'].numpy()
    f['predictions/predictions/kernel:0'] = state[
        'predictions.weight'].numpy().T
    f['predictions/predictions/bias:0'] = state['predictions.bias'].numpy()
  from_h5 = inception_t.inception_model(checkpoint_path=h5)
  for a, b in zip(from_h5.state_dict().values(), state.values()):
    assert torch.equal(a, b)
  monkeypatch.setitem(sys.modules, 'h5py', None)
  with pytest.raises(ImportError, match='h5py'):
    inception_t.inception_model(checkpoint_path=h5)
  with pytest.raises(ValueError):
    inception_t.inception_model(version='V4')


def test_cli_flags_parse_as_the_jax_main():
  args = main_t.parse_args([
      '--workdir', '/m', '--mode', 'test_unseen', '--gin_config', 'a.gin',
      '--gin_config', 'b.gin', '--gin_bindings', 'GAN.seed = 3',
      '--device', 'cpu'])
  assert args.model_dir == '/m' and args.device == 'cpu'
  assert main_t.Mode(args.mode.upper()) is main_t.Mode.TEST_UNSEEN
  assert args.gin_config == ['a.gin', 'b.gin']
  assert args.gin_bindings == ['GAN.seed = 3']
  assert main_t.parse_args(['--model_dir', '/m']).device is None
  with pytest.raises(SystemExit):
    main_t.parse_args(['--model_dir', '/m', '--mode', 'EVAL'])
