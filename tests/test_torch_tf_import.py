"""Port parity: TF checkpoint bundles (`train/tf_bundle.py`), the released
checkpoints' grammar (`train/tf_import.py`), `checkpoints.
import_tf_checkpoint`, `python -m se3ds_torch.convert_tf_checkpoint` and
`eval.inception.load_frozen_graph_v1`, against TensorFlow and the JAX
package on the CPU.

The only port test file that imports TensorFlow (~15 s per process),
and only in the fixture `tf`: every xdist worker collects every file.
The bundles are made here from seeded random weights: the generator's
(gen_dims 4, 64x128) and the discriminator's variables under the TF keys
that the JAX package's own grammar gives, in Keras layouts, written by
`tf.raw_ops.SaveV2`.

Tolerances: the converted state dicts are torch.equal to the JAX
package's variables carried across by `folding.torch_state_dict_from_flax`
(both copy the same float32 values); the eval forwards agree to atol 1e-5
(two CPU convolution libraries, as tests/test_torch_generator.py).
"""

import os

import jax
import numpy as np
import pytest
import torch

from se3ds_torch import convert_tf_checkpoint as convert_cli
from se3ds_torch.eval import inception as inception_t
from se3ds_torch.models import discriminator as disc_t
from se3ds_torch.models import folding as folding_t
from se3ds_torch.models import generator as gen_t
from se3ds_torch.models import inference as inference_t
from se3ds_torch.models import model_config as config_t
from se3ds_torch.train import checkpoints as checkpoints_t
from se3ds_torch.train import tf_bundle
from se3ds_torch.train import tf_import as tf_import_t
from se3ds_tpu.eval import inception as inception_j
from se3ds_tpu.models import discriminator as disc_j
from se3ds_tpu.models import generator as gen_j
from se3ds_tpu.train import tf_import as tf_import_j
from test_torch_serving import one_torch_thread  # noqa: F401
from test_torch_train_layers import _compiled
from test_torch_train_layers import _random_variables

pytestmark = pytest.mark.usefixtures('one_torch_thread')

ATTR = tf_import_t.ATTR_SUFFIX
H = 64
ATOL = 1e-5


@pytest.fixture(scope='module')
def tf():
  os.environ.setdefault('TF_CPP_MIN_LOG_LEVEL', '3')
  return pytest.importorskip('tensorflow')


def _save_v2(tf, prefix, tensors):
  tf.raw_ops.SaveV2(prefix=prefix, tensor_names=list(tensors),
                    shape_and_slices=[''] * len(tensors),
                    tensors=[tf.constant(v) for v in tensors.values()])


def _mixed_tensors():
  """Every decoded dtype, 0-d and empty tensors, and 600 keys of ~900
  unshared bytes each: TF's writer closes ~3 data blocks of 256 KiB."""
  rs = np.random.RandomState(0)
  tensors = {
      'a/f32': rs.rand(3, 4).astype(np.float32),
      'b/f64': rs.rand(5),
      'c/i32': np.int32(-7),
      'd/i64': rs.randint(-9, 9, (2, 3)).astype(np.int64),
      'e/u8': rs.randint(0, 256, (9,)).astype(np.uint8),
      'f/bool': rs.rand(4) > 0.5,
      'g/f16': rs.rand(2, 2).astype(np.float16),
      'h/empty': np.zeros((0, 3), np.float32),
      'i/scalar': np.float32(2.5),
  }
  for i in range(600):
    tensors[f'k/{i:04d}/{rs.bytes(450).hex()}'] = rs.rand(2).astype(
        np.float32)
  return tensors


def _assert_reads_like_tf(tf, prefix, tensors):
  ours, theirs = tf_bundle.BundleReader(prefix), tf.train.load_checkpoint(
      prefix)
  assert ours.get_variable_to_shape_map() == \
      theirs.get_variable_to_shape_map()
  want_dtypes = {k: v.as_numpy_dtype
                 for k, v in theirs.get_variable_to_dtype_map().items()}
  assert ours.get_variable_to_dtype_map() == want_dtypes
  for key, value in tensors.items():
    got, want = ours.get_tensor(key), theirs.get_tensor(key)
    assert got.dtype == np.asarray(want).dtype == np.asarray(value).dtype
    assert got.shape == np.shape(want) and np.array_equal(got, want), key


def test_reader_reads_what_tf_writes(tf, tmp_path):
  tensors = _mixed_tensors()
  prefix = str(tmp_path / 'saved')
  _save_v2(tf, prefix, tensors)
  assert os.path.getsize(prefix + '.index') > 2 * tf_bundle.BLOCK_SIZE
  _assert_reads_like_tf(tf, prefix, tensors)


def test_tf_reads_what_the_writer_writes(tf, tmp_path):
  tensors = _mixed_tensors()
  prefix = str(tmp_path / 'written')
  tf_bundle.write_bundle(prefix, tensors)
  assert os.path.getsize(prefix + '.index') > 2 * tf_bundle.BLOCK_SIZE
  _assert_reads_like_tf(tf, prefix, tensors)


def test_checkpoint_bundles_and_latest_checkpoint(tf, tmp_path):
  """A tf.train.Checkpoint's bundle (its object-graph string, the int64
  save_counter) and its directory's state file."""
  assert tf_bundle.latest_checkpoint(str(tmp_path)) is None
  ckpt = tf.train.Checkpoint(v=tf.Variable(np.arange(6.0).reshape(2, 3)),
                             w=tf.Variable(np.int32(3)))
  ckpt.save(str(tmp_path / 'ckpt'))
  path = ckpt.save(str(tmp_path / 'ckpt'))
  assert tf_bundle.latest_checkpoint(str(tmp_path)) == \
      tf.train.latest_checkpoint(str(tmp_path)) == path
  reader = tf_bundle.BundleReader(path)
  shapes = reader.get_variable_to_shape_map()
  assert {'_CHECKPOINTABLE_OBJECT_GRAPH',
          'save_counter' + ATTR} <= shapes.keys()
  assert reader.get_variable_to_dtype_map()['_CHECKPOINTABLE_OBJECT_GRAPH'] \
      == np.dtype(object)
  assert reader.get_tensor('save_counter' + ATTR) == np.int64(2)
  assert np.array_equal(reader.get_tensor('v' + ATTR),
                        np.arange(6.0).reshape(2, 3))
  with pytest.raises(ValueError, match='DT_STRING'):
    reader.get_tensor('_CHECKPOINTABLE_OBJECT_GRAPH')
  with pytest.raises(KeyError):
    reader.get_tensor('missing')


def test_a_flipped_data_byte_raises(tmp_path):
  prefix = str(tmp_path / 'b')
  tf_bundle.write_bundle(prefix, {'x': np.arange(100, dtype=np.float32)})
  data = tf_bundle.data_file(prefix, 0, 1)
  raw = bytearray(open(data, 'rb').read())
  raw[37] ^= 0x10
  open(data, 'wb').write(bytes(raw))
  with pytest.raises(ValueError, match='checksum'):
    tf_bundle.BundleReader(prefix).get_tensor('x')


# --- the grammar, against the JAX package's -----------------------------------


def _bundle_from_flax(variables, root, path_map):
  """{TF key: array} of Flax variables under the JAX grammar, in Keras
  layouts: BatchNorm gamma/beta/moving_*, transposed kernels HWOI
  (undoing the JAX import's transpose and flip), `spectral_conv_<k>_u`."""
  out = {'save_counter' + ATTR: np.int64(1)}
  leaves = jax.tree_util.tree_flatten_with_path(variables)[0]
  for k, (key_path, value) in enumerate(leaves):
    col, *module, leaf = [p.key for p in key_path]
    prefix = f'{root}/{path_map("/".join(module))}'
    value = np.asarray(value)
    if col == 'spectral':
      leaf = f'spectral_conv_{k}_u'
    elif col == 'batch_stats':
      leaf = {'mean': 'moving_mean', 'var': 'moving_variance'}[leaf]
    elif leaf == 'scale':
      leaf = 'gamma'
    elif leaf == 'bias' and module[-1] == 'bn':
      leaf = 'beta'
    elif leaf == 'kernel' and module[-1] == 'convt':
      value = value[::-1, ::-1].transpose(0, 1, 3, 2)
    out[f'{prefix}/{leaf}{ATTR}'] = np.ascontiguousarray(value)
  return out


def _cond(seed):
  rs = np.random.RandomState(seed)
  return {
      'proj_image': rs.uniform(0, 1, (1, H, 2 * H, 3)).astype(np.float32),
      'proj_depth': rs.uniform(0, 1, (1, H, 2 * H, 1)).astype(np.float32),
      'proj_mask': (rs.rand(1, H, 2 * H, 1) > 0.3).astype(np.float32),
      'blurred_mask': (rs.rand(1, H, 2 * H, 1) > 0.8).astype(np.float32),
  }


GENERATORS = {'r50': ('50', True), 'r50_no_blurred_mask': ('50', False),
              'r101': ('101', True)}
DISCRIMINATORS = {'d3': 3, 'd6': 6}


def _generator_kwargs(case):
  version, blurred = GENERATORS[case]
  return dict(gen_dims=4, z_dim=4, resnet_version=version,
              use_blurred_mask=blurred)


@pytest.fixture(scope='module')
def bundles(tf, tmp_path_factory):
  """case -> (Flax module, variables, bundle prefix, port template on the
  meta device), each made once."""
  made = {}

  def get(case):
    if case in made:
      return made[case]
    if case in GENERATORS:
      flax_model = gen_j.ResNetGenerator(image_size=H,
                                         **_generator_kwargs(case))
      variables = _random_variables(flax_model, 1, _cond(0), False)
      root, path_map = 'ema_generator', tf_import_j.flax_path_to_tf_prefix
      with torch.device('meta'):
        template = gen_t.ResNetGenerator(spectral_fold=False,
                                         **_generator_kwargs(case))
    else:
      n_layers = DISCRIMINATORS[case]
      flax_model = disc_j.SNMultiScaleDiscriminator(dis_dims=2,
                                                    n_layers=n_layers)
      variables = _random_variables(flax_model, 2,
                                    np.zeros((1, H, 2 * H, 4), np.float32))
      root = 'discriminator'
      path_map = tf_import_j.discriminator_path_map(n_layers)
      with torch.device('meta'):
        template = disc_t.SNMultiScaleDiscriminator(dis_dims=2,
                                                    n_layers=n_layers)
    prefix = str(tmp_path_factory.mktemp(case) / 'ckpt-1')
    _save_v2(tf, prefix, _bundle_from_flax(variables, root, path_map))
    made[case] = flax_model, variables, prefix, template
    return made[case]

  return get


def _port_kwargs(case):
  if case in GENERATORS:
    return {}
  return dict(root='discriminator',
              path_map=tf_import_t.discriminator_path_map(
                  DISCRIMINATORS[case]))


CASES = list(GENERATORS) + list(DISCRIMINATORS)


@pytest.mark.parametrize('case', CASES)
def test_jax_import_rebuilds_the_fixture(bundles, case):
  """The fixture is what the JAX package's importer reads back exactly."""
  _, variables, prefix, _ = bundles(case)
  kwargs = {}
  if case in DISCRIMINATORS:
    kwargs = dict(root='discriminator',
                  path_map=tf_import_j.discriminator_path_map(
                      DISCRIMINATORS[case]))
  rebuilt = tf_import_j.convert_tf_checkpoint(prefix, variables, **kwargs)
  for (path, a), (_, b) in zip(
      jax.tree_util.tree_flatten_with_path(variables)[0],
      jax.tree_util.tree_flatten_with_path(rebuilt)[0]):
    assert np.array_equal(a, b), path


@pytest.mark.parametrize('case', CASES)
def test_port_import_equals_the_jax_variables_carried_across(bundles, case):
  _, variables, prefix, template = bundles(case)
  got = tf_import_t.convert_tf_checkpoint(prefix, template,
                                          **_port_kwargs(case))
  want = folding_t.torch_state_dict_from_flax(variables, template)
  assert got.keys() == want.keys() == template.state_dict().keys()
  for key in want:
    assert got[key].dtype == torch.float32
    assert torch.equal(got[key], want[key]), key


# One generator's forward: the JAX compile is most of this file's time
# (~7 s at ResNet-50, ~15 s at ResNet-101 on one core), and the other
# generators' converted state dicts are torch.equal to the bridge's above.
@pytest.mark.parametrize('case', ['r50', 'd3', 'd6'])
def test_eval_forwards_match_jax(bundles, case):
  flax_model, variables, prefix, _ = bundles(case)
  if case in GENERATORS:
    port = gen_t.ResNetGenerator(spectral_fold=False,
                                 **_generator_kwargs(case))
    x = _cond(3)
    port_x = {k: torch.from_numpy(v) for k, v in x.items()}
  else:
    port = disc_t.SNMultiScaleDiscriminator(dis_dims=2,
                                            n_layers=DISCRIMINATORS[case])
    x = np.random.RandomState(3).normal(size=(1, H, 2 * H, 4)).astype(
        np.float32)
    port_x = torch.from_numpy(x)
  port.load_state_dict(tf_import_t.convert_tf_checkpoint(
      prefix, port, **_port_kwargs(case)))
  want = _compiled(lambda v, x: flax_model.apply(v, x, train=False),
                   variables, x)(variables, x)
  with torch.no_grad():
    got = port.eval()(port_x)
  if case in DISCRIMINATORS:  # per scale, every map
    got = [m for scale in got for m in scale]
    want = [m for scale in want for m in scale]
  assert len(got) == len(want)
  for g, w in zip(got, want):
    np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=ATOL)


# --- errors, import_tf_checkpoint and the CLI ---------------------------------


def test_missing_and_misshapen_keys_raise(bundles, tmp_path):
  _, variables, prefix, template = bundles('r50')
  reader = tf_bundle.BundleReader(prefix)
  tensors = {k: reader.get_tensor(k)
             for k in reader.get_variable_to_shape_map()}
  kernel = 'ema_generator/encoder/conv1/kernel' + ATTR
  missing = {k: v for k, v in tensors.items() if k != kernel}
  tf_bundle.write_bundle(str(tmp_path / 'missing'), missing)
  with pytest.raises(KeyError, match='encoder.conv1.weight'):
    tf_import_t.convert_tf_checkpoint(str(tmp_path / 'missing'), template)
  misshapen = dict(tensors, **{kernel: tensors[kernel][:, :, :, :2]})
  tf_bundle.write_bundle(str(tmp_path / 'misshapen'), misshapen)
  with pytest.raises(KeyError, match='shape'):
    tf_import_t.convert_tf_checkpoint(str(tmp_path / 'misshapen'), template)
  with pytest.raises(ValueError, match='spectral_fold=False'):
    tf_import_t.convert_tf_checkpoint(prefix, gen_t.ResNetGenerator(
        **_generator_kwargs('r50')))


def test_import_tf_checkpoint_by_name_map(tmp_path, capsys):
  """Resolved leaves come as stored and cast; unresolved ones keep the
  template's values and are reported; a shape mismatch raises."""
  model = torch.nn.Linear(3, 2)
  prefix = str(tmp_path / 'lin')
  weight = np.random.RandomState(4).rand(2, 3)
  tf_bundle.write_bundle(prefix, {'dense/kernel': weight,
                                  'dense/wide': np.zeros((2, 4))})
  bias = model.bias.detach().clone()
  state = checkpoints_t.import_tf_checkpoint(
      prefix, model, {'weight': 'dense/kernel'}.get)
  assert state['weight'].dtype == torch.float32
  assert torch.equal(state['weight'], torch.from_numpy(weight).float())
  assert torch.equal(state['bias'], bias)
  assert '1 unresolved' in capsys.readouterr().out
  with pytest.raises(ValueError, match='weight'):
    checkpoints_t.import_tf_checkpoint(prefix, model,
                                       {'weight': 'dense/wide'}.get)


def test_convert_cli_round_trips_into_se3ds_model(bundles, tmp_path):
  """A checkpoint directory -> the serving file -> SE3DSModel(ckpt_path=),
  whose weights are the serving form of the JAX variables carried
  across."""
  _, variables, prefix, _ = bundles('r50')
  directory = os.path.dirname(prefix)
  with open(os.path.join(directory, 'checkpoint'), 'w') as f:
    f.write('model_checkpoint_path: "ckpt-1"\n'
            'all_model_checkpoint_paths: "ckpt-1"\n')
  out = str(tmp_path / 'served.pt')
  argv = ['--tf_ckpt', directory, '--output', out, '--image_height', str(H),
          '--gen_dims', '4', '--z_dim', '4', '--resnet_version', '50']
  assert convert_cli.main(argv) == 0
  with pytest.raises(SystemExit, match='refusing'):
    convert_cli.main(argv)
  with pytest.raises(SystemExit, match='no TF checkpoint'):
    convert_cli.main(['--tf_ckpt', str(tmp_path), '--output',
                      str(tmp_path / 'x.pt')])
  cfg = config_t.SE3DSConfig(ckpt_path=out, image_height=H, gen_dims=4,
                             resnet_version='50', memory_frames=1)
  served = inference_t.SE3DSModel(cfg, device='cpu').model.state_dict()
  source = gen_t.ResNetGenerator(spectral_fold=False,
                                 **_generator_kwargs('r50'))
  source.load_state_dict(folding_t.torch_state_dict_from_flax(variables,
                                                              source))
  want = folding_t.serving_state_dict(source)
  assert served.keys() == want.keys()
  for key in want:
    assert torch.equal(served[key], want[key].to(served[key].dtype)), key


# --- the Inception V1 frozen graph -------------------------------------------


def test_load_frozen_graph_v1_matches_jax(tf, tmp_path):
  """A tiny graph with the reference's endpoints Mul:0 -> pool_3:0,
  logits:0; both loaders give the same features and softmax."""
  graph = tf.Graph()
  with graph.as_default():
    x = tf.compat.v1.placeholder(tf.float32, (None, 8, 8, 3), name='input')
    mul = tf.multiply(x, 2.0, name='Mul')
    pool = tf.reduce_mean(mul, axis=(1, 2), keepdims=True, name='pool_3')
    weights = tf.constant(np.random.RandomState(5).rand(3, 4), tf.float32)
    tf.matmul(tf.reshape(pool, (-1, 3)), weights, name='logits')
  path = str(tmp_path / 'v1.pb')
  with open(path, 'wb') as f:
    f.write(graph.as_graph_def().SerializeToString())
  assert (inception_t.INCEPTION_V1_INPUT, inception_t.INCEPTION_V1_OUTPUT,
          inception_t.INCEPTION_V1_FINAL_POOL) == (
              inception_j.INCEPTION_V1_INPUT, inception_j.INCEPTION_V1_OUTPUT,
              inception_j.INCEPTION_V1_FINAL_POOL)
  images = np.random.RandomState(6).rand(2, 8, 8, 3).astype(np.float32)
  got = inception_t.load_frozen_graph_v1(path)(images)
  want = inception_j.load_frozen_graph_v1(path)(images)
  for g, w in zip(got, want):
    np.testing.assert_array_equal(g, w)
  np.testing.assert_allclose(got[1].sum(-1), 1.0, rtol=1e-6)
