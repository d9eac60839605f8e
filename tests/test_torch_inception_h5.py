"""Port parity: the Keras `.h5` InceptionV3 loader
(`eval.inception.load_keras_weights`), `inception_model(checkpoint_path=
'….h5')` and `python -m se3ds_torch.convert_inception`, against the JAX
package's loader, on `.h5` files written here by h5py from seeded random
weights under the Keras layer names (94 conv2d[_k] and
batch_normalization[_k] layers, so k sorts as a number, and the
predictions head), at the top level and under `model_weights/` (a
whole-model save) with `:0` leaf names. The converted state dicts are
torch.equal (both copy the same float32 values).
"""

import sys

import numpy as np
import pytest
import torch

h5py = pytest.importorskip('h5py')

from se3ds_torch import convert_inception as convert_cli  # noqa: E402
from se3ds_torch.eval import inception as inception_t  # noqa: E402
from se3ds_tpu.eval import inception as inception_j  # noqa: E402
from test_torch_serving import one_torch_thread  # noqa: E402,F401

pytestmark = pytest.mark.usefixtures('one_torch_thread')


def _keras_layers(seed):
  """{Keras layer name: {leaf: array}} in Keras layouts, from the port's
  module shapes in creation order."""
  with torch.device('meta'):
    shapes = {k: tuple(v.shape)
              for k, v in inception_t.InceptionV3().state_dict().items()}
  rs = np.random.RandomState(seed)
  rand = lambda *shape: rs.normal(0, 0.1, shape).astype(np.float32)
  layers = {}
  for k, module in enumerate(inception_t.conv_module_order()):
    suffix = f'_{k}' if k else ''
    out_f, in_f, kh, kw = shapes[f'{module}.conv.weight']
    layers[f'conv2d{suffix}'] = {'kernel': rand(kh, kw, in_f, out_f)}
    layers[f'batch_normalization{suffix}'] = {
        'beta': rand(out_f), 'moving_mean': rand(out_f),
        'moving_variance': rs.uniform(0.5, 1.5, out_f).astype(np.float32)}
  layers['predictions'] = {'kernel': rand(inception_t.POOL_DIM,
                                          inception_t.NUM_CLASSES),
                           'bias': rand(inception_t.NUM_CLASSES)}
  return layers


@pytest.fixture(scope='module', params=['top', 'model_weights'])
def h5_file(request, tmp_path_factory):
  path = str(tmp_path_factory.mktemp('h5') / 'inception_v3.h5')
  with h5py.File(path, 'w') as f:
    root = f.create_group('model_weights') if request.param != 'top' else f
    for layer, leaves in _keras_layers(7).items():
      group = root.create_group(layer).create_group(layer)
      for leaf, value in leaves.items():
        group.create_dataset(f'{leaf}:0', data=value)
  return path


def test_load_keras_weights_matches_jax(h5_file):
  got = inception_t.load_keras_weights(h5_file)
  want = inception_t.torch_state_dict_from_flax_inception(
      inception_j.load_keras_weights(h5_file))
  assert got.keys() == want.keys()
  for key in want:
    assert torch.equal(got[key], want[key]), key
  assert got['conv4.conv.weight'].shape == (192, 80, 3, 3)
  assert got['predictions.weight'].shape == (1000, 2048)


def test_inception_model_loads_the_h5(h5_file):
  model = inception_t.inception_model(checkpoint_path=h5_file)
  assert not model.training
  want = inception_t.load_keras_weights(h5_file)
  for key, value in model.state_dict().items():
    assert torch.equal(value, want[key]), key


def test_convert_inception_cli_round_trips(h5_file, tmp_path):
  out = str(tmp_path / 'inception_v3.pt')
  assert convert_cli.main(['--h5', h5_file, '--out', out, '--verify']) == 0
  loaded = inception_t.inception_model(checkpoint_path=out)
  want = inception_t.load_keras_weights(h5_file)
  for key, value in loaded.state_dict().items():
    assert torch.equal(value, want[key]), key


def test_without_h5py_the_error_names_the_converter(monkeypatch):
  monkeypatch.setitem(sys.modules, 'h5py', None)
  with pytest.raises(ImportError, match='se3ds_torch.convert_inception'):
    inception_t.inception_model(checkpoint_path='weights.h5')
