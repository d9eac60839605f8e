"""Port parity: the data pipeline against the JAX package, on the CPU.

The codecs (Example, TensorProto, TFRecord, PNG) decode the same bytes to
the same values and encode the same values to the same bytes; the
fixture writers write the same files for the same seed; the port's copy
of the native loader agrees with the port's Python path and with the JAX
package; and `R2RImageDataset` / `R2RVideoDataset` batches are
`np.array_equal` to the JAX pipeline's on every key, through the native
and through the Python path. Everything is exact: the pipeline is numpy
with the same `RandomState` draws in the same order.
"""

import io
import struct
import zlib

import numpy as np
import pytest
import torch
from PIL import Image

from se3ds_torch.data import datasets as datasets_t
from se3ds_torch.data import example_pb as example_pb_t
from se3ds_torch.data import native_loader as native_t
from se3ds_torch.data import png as png_t
from se3ds_torch.data import synthetic as synthetic_t
from se3ds_torch.data import tensorproto as tensorproto_t
from se3ds_torch.data import tfrecord as tfrecord_t
from se3ds_tpu.data import datasets as datasets_j
from se3ds_tpu.data import example_pb as example_pb_j
from se3ds_tpu.data import native_loader as native_j
from se3ds_tpu.data import png as png_j
from se3ds_tpu.data import synthetic as synthetic_j
from se3ds_tpu.data import tensorproto as tensorproto_j
from se3ds_tpu.data import tfrecord as tfrecord_j

HEIGHT = 32  # stored pano height of the fixtures (32x64)
SIZE = 16  # the model's image_size


def _equal_batches(got, want):
  assert got.keys() == want.keys()
  for key in want:
    if isinstance(want[key], list):
      assert got[key] == want[key], key
    else:
      assert got[key].dtype == want[key].dtype, key
      np.testing.assert_array_equal(got[key], want[key], err_msg=key)


# -- codecs -------------------------------------------------------------------


def test_example_codec_matches_jax():
  features = {'a_bytes': [b'xyz', b'pq'], 'b_float': [1.5, -2.25, 1e-30],
              'c_int': [7, -3, 1 << 40], 'd_scalar': 3, 'e_str': ['s']}
  data = example_pb_j.encode_example(features)
  assert example_pb_t.encode_example(features) == data
  assert example_pb_t.decode_example(data) == example_pb_j.decode_example(
      data)
  raw = synthetic_j.make_image_example(HEIGHT, dataset_type=2)
  assert example_pb_t.decode_example(raw) == example_pb_j.decode_example(raw)


@pytest.mark.parametrize('dtype', [np.float32, np.float64, np.int32,
                                   np.uint8, np.int64, np.uint16, np.bool_])
def test_tensorproto_codec_matches_jax(dtype):
  arr = (np.random.RandomState(1).rand(2, 3, 5) * 100).astype(dtype)
  data = tensorproto_j.encode_tensor(arr)
  assert tensorproto_t.encode_tensor(arr) == data
  got = tensorproto_t.decode_tensor(data)
  assert got.dtype == arr.dtype
  np.testing.assert_array_equal(got, tensorproto_j.decode_tensor(data))


def _record_file(tmp_path, records):
  path = str(tmp_path / 'x.tfrecord')
  with tfrecord_t.TFRecordWriter(path) as writer:
    for record in records:
      writer.write(record)
  return path


@pytest.mark.parametrize('native', [True, False], ids=['native', 'python'])
def test_tfrecord_reader_matches_jax_and_checks_only_when_asked(
    tmp_path, monkeypatch, native):
  """The default skips the checksums, as the JAX reader's does;
  verify_crc=True raises on a corrupted length CRC and on a corrupted data
  CRC; the bytes read and written equal the JAX reader's and writer's,
  with the checksums from the native loader and from Python."""
  if not native:
    monkeypatch.setattr(native_t, 'available', lambda: False)
  records = [b'hello', b'world' * 100, b'']
  path = _record_file(tmp_path, records)
  jax_path = str(tmp_path / 'jax.tfrecord')
  with tfrecord_j.TFRecordWriter(jax_path) as writer:
    for record in records:
      writer.write(record)
  assert open(path, 'rb').read() == open(jax_path, 'rb').read()
  for verify in (False, True):
    got = list(tfrecord_t.read_records(path, verify_crc=verify))
    assert got == records == list(tfrecord_j.read_records(path, verify))
  data = bytearray(open(path, 'rb').read())
  for offset, what in ((8, 'length'), (12 + len(records[0]), 'data')):
    corrupt = bytearray(data)
    corrupt[offset] ^= 0xFF
    bad = str(tmp_path / f'bad_{what}.tfrecord')
    open(bad, 'wb').write(bytes(corrupt))
    assert list(tfrecord_t.read_records(bad)) == records
    with pytest.raises(IOError, match=f'corrupted record {what} crc'):
      list(tfrecord_t.read_records(bad, verify_crc=True))
  assert tfrecord_t.list_files(str(tmp_path / '*.tfrecord')) == (
      tfrecord_j.list_files(str(tmp_path / '*.tfrecord')))
  with pytest.raises(FileNotFoundError):
    tfrecord_t.list_files(str(tmp_path / 'none*'))


def test_native_crc32c_matches_python_and_jax():
  rs = np.random.RandomState(5)
  for size in (0, 1, 7, 64, 100003):
    data = rs.randint(0, 256, size).astype(np.uint8).tobytes()
    want = tfrecord_j.crc32c(data)
    assert native_t.crc32c(data) == tfrecord_t.crc32c(data) == want
    assert tfrecord_t.masked_crc32c(data) == tfrecord_j.masked_crc32c(data)


def _filters(data):
  """The filter byte of each scanline of a non-interlaced PNG."""
  pos, idat, ihdr = 8, b'', None
  while pos < len(data):
    (length,) = struct.unpack('>I', data[pos:pos + 4])
    tag, payload = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + length]
    pos += 12 + length
    if tag == b'IHDR':
      ihdr = struct.unpack('>IIBBBBB', payload)
    elif tag == b'IDAT':
      idat += payload
  w, h, bit_depth, color_type = ihdr[:4]
  stride = w * {0: 1, 2: 3, 4: 2, 6: 4}[color_type] * bit_depth // 8 + 1
  raw = zlib.decompress(idat)
  return {raw[y * stride] for y in range(h)}


def _png_with_filters(image):
  """An 8-bit PNG whose scanlines cycle through the five filters (None,
  Sub, Up, Average, Paeth), each applied as the PNG standard defines."""
  h, w = image.shape[:2]
  bpp = image.shape[2] if image.ndim == 3 else 1
  rows = image.reshape(h, w * bpp).astype(np.int64)
  lines = bytearray()
  for y in range(h):
    kind = y % 5
    up = rows[y - 1] if y else np.zeros_like(rows[0])
    left = np.concatenate([np.zeros(bpp, np.int64), rows[y][:-bpp]])
    corner = np.concatenate([np.zeros(bpp, np.int64), up[:-bpp]])
    p = left + up - corner
    pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - corner)
    paeth = np.where((pa <= pb) & (pa <= pc), left,
                     np.where(pb <= pc, up, corner))
    pred = (0, left, up, (left + up) // 2, paeth)[kind]
    lines.append(kind)
    lines.extend(((rows[y] - pred) & 0xFF).astype(np.uint8).tobytes())
  ihdr = struct.pack('>IIBBBBB', w, h, 8, {1: 0, 2: 4, 3: 2}[bpp], 0, 0, 0)
  chunk = lambda tag, body: (struct.pack('>I', len(body)) + tag + body
                             + struct.pack('>I', zlib.crc32(tag + body)))
  return (b'\x89PNG\r\n\x1a\n' + chunk(b'IHDR', ihdr)
          + chunk(b'IDAT', zlib.compress(bytes(lines))) + chunk(b'IEND', b''))


def test_pure_png_decoder_on_filtered_scanlines_matches_pil_and_jax():
  """The pure decoder (the path on a machine without PIL) gives PIL's and
  the JAX decoder's values on filtered PNGs: images that PIL encodes with
  its adaptive filters (None, Sub, Up and Paeth occur; PIL's heuristic
  never picks Average), and PNGs whose scanlines cycle through all five
  filters, Average included."""
  rs = np.random.RandomState(2)
  y, x = np.mgrid[0:24, 0:40]
  smooth = (x * 5 + y * 3) % 256
  images = [
      np.stack([smooth, smooth[::-1], (x * y) % 256], -1).astype(np.uint8),
      ((x * x + y * y) // 3 % 256).astype(np.uint8),
      rs.randint(0, 256, (24, 40, 3)).astype(np.uint8),
      np.stack([smooth, (y * 9) % 256], -1).astype(np.uint8),
  ]
  seen = set()
  for image in images:
    buf = io.BytesIO()
    Image.fromarray(image).save(buf, format='PNG')
    for data in (buf.getvalue(), _png_with_filters(image)):
      seen |= _filters(data)
      got = png_t._decode_png_pure(data)
      np.testing.assert_array_equal(got, image)
      np.testing.assert_array_equal(got, png_j._decode_png_pure(data))
      np.testing.assert_array_equal(png_t.decode_png(data), image)
  assert seen == {0, 1, 2, 3, 4}, seen


@pytest.mark.parametrize('dtype,shape', [(np.uint8, (5, 7)),
                                         (np.uint8, (5, 7, 3)),
                                         (np.uint16, (5, 7))])
def test_png_encoder_matches_jax(dtype, shape):
  arr = np.random.RandomState(3).randint(0, np.iinfo(dtype).max,
                                         shape).astype(dtype)
  data = png_t.encode_png(arr)
  assert data == png_j.encode_png(arr)
  np.testing.assert_array_equal(png_t._decode_png_pure(data), arr)
  np.testing.assert_array_equal(png_t.decode_png(data), arr)


def test_fixture_files_equal_jax(tmp_path):
  for name, kwargs in (('image', dict(num_examples=2, height=16)),
                       ('image', dict(num_examples=1, height=16,
                                      dataset_type=2, seed=4)),
                       ('video', dict(num_examples=1, height=8, seed=5))):
    paths = []
    for tag, module in (('t', synthetic_t), ('j', synthetic_j)):
      paths.append(str(tmp_path / f'{name}_{tag}.tfrecord'))
      getattr(module, f'write_{name}_fixture')(paths[-1], **kwargs)
    assert open(paths[0], 'rb').read() == open(paths[1], 'rb').read()


# -- the native loader --------------------------------------------------------


@pytest.fixture(scope='module')
def fixture_dir(tmp_path_factory):
  """Image-pair records in two train files (MP3D) and one RE10K file, and
  video records in val_seen and val_unseen."""
  d = tmp_path_factory.mktemp('data')
  for i in range(2):
    synthetic_t.write_image_fixture(str(d / f'train-{i}.tfrecord'),
                                    num_examples=3, height=HEIGHT, seed=i)
  synthetic_t.write_image_fixture(str(d / 're10k-0.tfrecord'), num_examples=3,
                                  height=HEIGHT, seed=2, dataset_type=2)
  for split, seed in (('val_seen', 3), ('val_unseen', 4)):
    synthetic_t.write_video_fixture(str(d / f'{split}-0.tfrecord'),
                                    num_examples=3, height=HEIGHT, seed=seed)
  return d


def test_native_loader_builds_outside_the_jax_tree():
  assert native_t.available()
  path = native_t.library_path()
  assert path.exists() and path.parent.parts[-2:] == ('build', 'se3ds_torch')


@pytest.mark.parametrize('name', ['train-0', 're10k-0'])
def test_native_loader_matches_python_and_jax(fixture_dir, name):
  """The port's native reader and decoder against the port's Python path,
  the JAX Python path and (where it builds) the JAX native loader."""
  path = str(fixture_dir / f'{name}.tfrecord')
  records = list(tfrecord_t.read_records(path, verify_crc=True))
  assert list(native_t.read_records(path, verify_crc=True)) == records
  assert records == list(tfrecord_j.read_records(path))
  jax_native = native_j.available()  # builds native/ as the JAX tests do
  if jax_native:
    assert list(native_j.read_records(path, verify_crc=True)) == records
  for raw in records:
    native = native_t.decode_image_example(raw, HEIGHT)
    python = datasets_t._decode_image_example(raw, HEIGHT)
    jax_python = datasets_j._decode_image_example(raw, HEIGHT)
    others = [python, jax_python]
    if jax_native:
      others.append(native_j.decode_image_example(raw, HEIGHT))
    for other in others:
      for key in native:
        if key in ('filename', 'scan_id'):  # not decoded natively
          continue
        np.testing.assert_array_equal(native[key], other[key], err_msg=key)
    assert python.keys() == jax_python.keys()
    for key in python:
      np.testing.assert_array_equal(python[key], jax_python[key])


# -- the pipeline -------------------------------------------------------------


def _take(dataset, count, **kwargs):
  it = dataset.input_fn(**kwargs)
  return [next(it) for _ in range(count)]


IMAGE_CASES = {
    # Train: shuffle over both files, the random resize up to 2x, the
    # guidance-mask erasure, roll + flip, the crop, the batch transform.
    'train': (dict(image_size=SIZE, preprocessed_image_height=HEIGHT,
                   random_resize_max=2.0),
              dict(split='train', global_batch_size=4, shuffle=True,
                   shuffle_buffer_size=4, seed=3), 3),
    # Two hosts' shards of the same run.
    'train shard 0 of 2': (dict(image_size=SIZE,
                                preprocessed_image_height=HEIGHT),
                           dict(split='train', global_batch_size=4,
                                shuffle=True, shuffle_buffer_size=2, seed=5,
                                num_shards=2, shard_index=0), 2),
    'train shard 1 of 2': (dict(image_size=SIZE,
                                preprocessed_image_height=HEIGHT),
                           dict(split='train', global_batch_size=4,
                                shuffle=True, shuffle_buffer_size=2, seed=5,
                                num_shards=2, shard_index=1), 2),
    # Eval: the eval transform (one-hot masks), no shuffle, one epoch.
    'eval': (dict(image_size=SIZE, preprocessed_image_height=HEIGHT),
             dict(split='val', global_batch_size=2, num_epochs=1,
                  drop_remainder=False), 2),
    # RE10K records through the bounding-box crop.
    're10k': (dict(image_size=SIZE, preprocessed_image_height=HEIGHT,
                   re_10k_crop=True),
              dict(split='train', global_batch_size=3, shuffle=True,
                   shuffle_buffer_size=2, seed=7), 2),
}


@pytest.mark.parametrize('native', [True, False], ids=['native', 'python'])
@pytest.mark.parametrize('case', list(IMAGE_CASES))
def test_image_dataset_batches_equal_jax(fixture_dir, monkeypatch, case,
                                         native):
  ds_kwargs, input_kwargs, count = IMAGE_CASES[case]
  input_kwargs = dict(input_kwargs)
  pattern = {'eval': 'train-0', 're10k': 're10k-0'}.get(case, 'train-')
  input_kwargs['file_pattern'] = str(fixture_dir / f'{pattern}*.tfrecord')
  if not native:
    monkeypatch.setattr(native_t, 'available', lambda: False)
  got = _take(datasets_t.R2RImageDataset(data_dir=str(fixture_dir),
                                         **ds_kwargs), count, **input_kwargs)
  want = _take(datasets_j.R2RImageDataset(data_dir=str(fixture_dir),
                                          **ds_kwargs), count, **input_kwargs)
  for g, w in zip(got, want):
    _equal_batches(g, w)
  if case == 'train':
    assert got[0]['image'].shape == (4, SIZE, 2 * SIZE, 3)
    assert len({float(b['image'].sum()) for b in got}) == count


@pytest.mark.parametrize('split', ['val_seen', 'val_unseen'])
def test_video_dataset_batches_equal_jax(fixture_dir, split):
  kwargs = dict(image_size=SIZE, preprocessed_image_height=HEIGHT,
                data_dir=str(fixture_dir), horizontal_mask_ratio=0.25)
  got = list(datasets_t.R2RVideoDataset(**kwargs).input_fn(
      split, global_batch_size=2, num_epochs=1, drop_remainder=False))
  want = list(datasets_j.R2RVideoDataset(**kwargs).input_fn(
      split, global_batch_size=2, num_epochs=1, drop_remainder=False))
  assert len(got) == len(want) == 2
  for g, w in zip(got, want):
    _equal_batches(g, w)
  assert got[0]['one_hot_mask'].shape == (2, 8, SIZE, 2 * SIZE, 42)


def test_z_generator_modes_and_device_z():
  """cpu modes put the host z in the batch (the JAX draws); 'device'
  leaves it out for `device_z`, which draws from a torch.Generator."""
  raw = synthetic_t.make_image_example(height=HEIGHT)
  for mode, has_z in (('cpu_generator', True), ('device', False)):
    outs = []
    for lib in (datasets_t, datasets_j):
      ds = lib.R2RImageDataset(image_size=SIZE,
                               preprocessed_image_height=HEIGHT,
                               z_generator=mode)
      outs.append(ds._train_transform_fn(ds._parse(raw),
                                         np.random.RandomState(0)))
    assert ('z' in outs[0]) == has_z
    _equal_batches(*outs)
  with pytest.raises(ValueError, match='z_generator'):
    datasets_t.R2RImageDataset(image_size=SIZE, z_generator='gpu')
  z = datasets_t.device_z(torch.Generator().manual_seed(0), 4, z_dim=16)
  assert z.shape == (4, 16) and z.dtype == torch.float32
  assert torch.equal(z, datasets_t.device_z(
      torch.Generator().manual_seed(0), 4, z_dim=16))
