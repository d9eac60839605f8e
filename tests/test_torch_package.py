"""The port's package rules: no JAX imports, and how its kernels build."""

import ast
import pathlib
import shutil
import sys

import pytest

from se3ds_torch.ops import cuda_build

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'se3ds_tpu')
PORT_FILES = sorted((ROOT / 'se3ds_torch').rglob('*.py')) + [
    ROOT / 'chip_smoke.py']


def _imported_modules(tree):
  for node in ast.walk(tree):
    if isinstance(node, ast.Import):
      for alias in node.names:
        yield alias.name
    elif isinstance(node, ast.ImportFrom) and node.level == 0:
      yield node.module
    elif (isinstance(node, ast.Call) and node.args
          and isinstance(node.args[0], ast.Constant)
          and isinstance(node.args[0].value, str)
          and getattr(node.func, 'attr', getattr(node.func, 'id', None))
          in ('import_module', '__import__')):
      yield node.args[0].value


@pytest.mark.parametrize('path', PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_port_imports_no_jax(path):
  tree = ast.parse(path.read_text(), filename=str(path))
  for module in _imported_modules(tree):
    assert module.split('.')[0] not in FORBIDDEN, (path, module)


def test_port_files_found():
  names = {p.relative_to(ROOT).as_posix() for p in PORT_FILES}
  assert {'se3ds_torch/ops/splat_cuda.py', 'se3ds_torch/models/inference.py',
          'se3ds_torch/ops/epilogue_cuda.py', 'se3ds_torch/ops/wrap_cuda.py',
          'se3ds_torch/eval/metrics.py', 'se3ds_torch/eval/inception.py',
          'se3ds_torch/eval/fid.py', 'se3ds_torch/models/discriminator.py',
          'se3ds_torch/train/losses.py', 'se3ds_torch/train/state.py',
          'se3ds_torch/train/checkpoints.py', 'se3ds_torch/train/trainer.py',
          'se3ds_torch/utils/logger.py', 'se3ds_torch/utils/task_manager.py',
          'se3ds_torch/utils/image_grid.py',
          'se3ds_torch/utils/parameter_overview.py',
          'se3ds_torch/data/png.py', 'se3ds_torch/data/tfrecord.py',
          'se3ds_torch/data/example_pb.py', 'se3ds_torch/data/tensorproto.py',
          'se3ds_torch/data/native_loader.py', 'se3ds_torch/data/datasets.py',
          'se3ds_torch/data/synthetic.py', 'se3ds_torch/config.py',
          'se3ds_torch/main.py', 'se3ds_torch/ops/image.py',
          'se3ds_torch/inference/perturbation.py',
          'se3ds_torch/examples/mp3d_trajectory_demo.py',
          'se3ds_torch/examples/re10k_video_demo.py',
          'se3ds_torch/examples/vln_augmentation_demo.py',
          'se3ds_torch/parallel/mesh.py', 'se3ds_torch/utils/flops.py',
          'se3ds_torch/parallel/splat_shard.py',
          'se3ds_torch/models/spatial.py',
          'se3ds_torch/profile_training.py', 'chip_smoke.py',
          'se3ds_torch/train/tf_bundle.py', 'se3ds_torch/train/tf_import.py',
          'se3ds_torch/convert_tf_checkpoint.py',
          'se3ds_torch/convert_inception.py',
          'se3ds_torch/utils/math_utils.py', 'se3ds_torch/tracing.py'} <= names


@pytest.mark.parametrize('name', [
    'se3ds_torch/train/tf_bundle.py', 'se3ds_torch/train/tf_import.py',
    'se3ds_torch/train/checkpoints.py',
    'se3ds_torch/convert_tf_checkpoint.py'])
def test_checkpoint_import_needs_no_tensorflow(name):
  """The TF checkpoint reader and converter run where the port runs,
  which has neither TensorFlow nor h5py."""
  tree = ast.parse((ROOT / name).read_text(), filename=name)
  for module in _imported_modules(tree):
    assert module.split('.')[0] not in ('tensorflow', 'h5py'), module


def test_kernel_build_flags():
  """sm_90a, IEEE division and square root, never fast math, and nvcc's
  default -fmad=true, as PyTorch's own kernels build (the math library's
  atan2f/acosf then give PyTorch's bits). The sources keep every other
  float rounding like the plain version's with round-to-nearest
  intrinsics, which are never contracted (csrc/pixel.cuh)."""
  flags = ' '.join(cuda_build.NVCC_FLAGS)
  assert 'arch=compute_90a,code=sm_90a' in flags
  assert '-fmad' not in flags
  for bad in ('fast_math', 'prec-div=false', 'prec-sqrt=false'):
    assert bad not in flags
  assert cuda_build.sources() == ['epilogue.cu', 'splat.cu',
                                  'splat_exact.cu', 'wrap.cu']
  header = (cuda_build.CSRC_DIR / 'pixel.cuh').read_text()
  for intrinsic in ('__fadd_rn', '__fsub_rn', '__fmul_rn', '__fdiv_rn',
                    '__fsqrt_rn'):
    assert intrinsic in header
  epilogue = (cuda_build.CSRC_DIR / 'epilogue.cu').read_text()
  for intrinsic in ('__fadd_rn', '__fsub_rn', '__fmul_rn', '__frcp_rn',
                    '__fsqrt_rn'):
    assert intrinsic in epilogue
  assert '__fmul_rn' in (cuda_build.CSRC_DIR / 'wrap.cu').read_text()


def test_library_name_follows_the_source():
  path = cuda_build.library_path('splat.cu')
  assert path.parent == cuda_build.BUILD_DIR
  assert path.name.startswith('libsplat_') and path.suffix == '.so'
  assert path == cuda_build.library_path('splat.cu')


def test_load_fails_only_with_its_own_source(tmp_path, monkeypatch):
  """`load` compiles every missing source in one round, and raises only
  where the source it loads failed: a broken source beside it does not
  keep it from loading, and raises when it is loaded itself."""
  csrc, build = tmp_path / 'csrc', tmp_path / 'build'
  csrc.mkdir()
  (csrc / 'good.cu').write_text('extern "C" int answer() { return 42; }\n')
  (csrc / 'bad.cu').write_text('this is not C\n')
  gxx = shutil.which('g++')
  assert gxx, 'g++ builds the native data loader too'
  # A stand-in for nvcc: g++ on the source, whatever nvcc's flags.
  fake = tmp_path / 'nvcc'
  fake.write_text(f"""#!{sys.executable}
import subprocess, sys
out = sys.argv[sys.argv.index('-o') + 1]
sys.exit(subprocess.call(['{gxx}', '-shared', '-fPIC', '-x', 'c++', '-o',
                          out, sys.argv[-1]]))
""")
  fake.chmod(0o755)
  monkeypatch.setattr(cuda_build, 'CSRC_DIR', csrc)
  monkeypatch.setattr(cuda_build, 'BUILD_DIR', build)
  monkeypatch.setattr(cuda_build, '_nvcc', lambda: str(fake))
  monkeypatch.setattr(cuda_build, '_LOADED', {})
  assert cuda_build.load('good.cu').answer() == 42
  assert cuda_build.library_path('good.cu').exists()
  assert not cuda_build.library_path('bad.cu').exists()
  with pytest.raises(RuntimeError, match='bad.cu') as failed:
    cuda_build.load('bad.cu')
  assert 'good.cu' not in str(failed.value)
  with pytest.raises(RuntimeError, match='bad.cu'):
    cuda_build.build()


def test_library_name_follows_the_shared_headers(tmp_path, monkeypatch):
  """An edit to a csrc/*.cuh header renames (so rebuilds) every library."""
  for name in ('a.cu', 'pixel.cuh'):
    (tmp_path / name).write_text(name)
  monkeypatch.setattr(cuda_build, 'CSRC_DIR', tmp_path)
  before = cuda_build.library_path('a.cu')
  (tmp_path / 'pixel.cuh').write_text('edited')
  assert cuda_build.library_path('a.cu') != before
