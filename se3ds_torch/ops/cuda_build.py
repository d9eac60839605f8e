"""Builds the port's CUDA sources into shared libraries at first use.

Each `csrc/*.cu` file exposes a plain C interface and is compiled by
`nvcc` into its own shared library, loaded with `ctypes`. The library name
carries a hash of the source, the shared headers (`csrc/*.cuh`) and the
flags, so an edited source or header rebuilds and an unchanged one is
reused. Libraries go to `build/se3ds_torch/` at
the root of the checkout (listed in .gitignore). `build()` starts one
`nvcc` per source, all at once, and waits for all of them.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, Optional

CSRC_DIR = Path(__file__).resolve().parents[1] / 'csrc'
BUILD_DIR = Path(__file__).resolve().parents[2] / 'build' / 'se3ds_torch'

# sm_90a (Hopper), with nvcc's default -fmad=true, as PyTorch's own CUDA
# kernels are built, so the math library's atan2f and acosf give the
# bits of PyTorch's. The sources write every other float operation with
# round-to-nearest intrinsics, which are never fused, so each rounds like
# the separate PyTorch op of the plain version (csrc/pixel.cuh).
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-Xptxas=-v', '-shared', '-Xcompiler', '-fPIC')

_LOADED: Dict[str, ctypes.CDLL] = {}


def sources() -> list:
  """Names of every CUDA source of the port."""
  return sorted(p.name for p in CSRC_DIR.glob('*.cu'))


def _nvcc() -> str:
  found = shutil.which('nvcc')
  if found:
    return found
  default = '/usr/local/cuda/bin/nvcc'
  if os.path.exists(default):
    return default
  raise RuntimeError('nvcc not found: the CUDA kernels of se3ds_torch are '
                     'built from source on the machine with the card.')


def library_path(name: str) -> Path:
  """Where the library built from csrc/<name> lives."""
  digest = hashlib.sha1((CSRC_DIR / name).read_bytes())
  for header in sorted(CSRC_DIR.glob('*.cuh')):
    digest.update(header.read_bytes())
  digest.update(' '.join(NVCC_FLAGS).encode())
  return BUILD_DIR / f'lib{Path(name).stem}_{digest.hexdigest()[:16]}.so'


def _compile(names: Iterable[str]) -> Dict[str, str]:
  """Compiles, in parallel, each named source whose library is missing;
  returns {source: nvcc's output} for those that failed. The compiler's
  output (register and shared-memory use from -Xptxas=-v) is kept beside
  each library as `<library>.log`."""
  BUILD_DIR.mkdir(parents=True, exist_ok=True)
  running = []
  for name in names:
    out = library_path(name)
    if out.exists():
      continue
    tmp = out.with_name(f'{out.name}.{os.getpid()}.tmp')
    cmd = [_nvcc(), *NVCC_FLAGS, '-o', str(tmp), str(CSRC_DIR / name)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    running.append((name, out, tmp, proc))
  failures = {}
  for name, out, tmp, proc in running:
    log, _ = proc.communicate()
    out.with_name(out.name + '.log').write_text(log)
    if proc.returncode != 0:
      failures[name] = log
      continue
    os.replace(tmp, out)
  return failures


def _raise_for(failures: Dict[str, str]) -> None:
  if failures:
    raise RuntimeError('nvcc failed for ' + '\n'.join(
        f'{name}:\n{log}' for name, log in failures.items()))


def build(names: Optional[Iterable[str]] = None) -> Dict[str, Path]:
  """Compiles each named source (default: all) whose library is missing,
  in parallel; returns {source: library}. Raises RuntimeError naming the
  sources that failed."""
  names = sources() if names is None else list(names)
  _raise_for(_compile(names))
  return {name: library_path(name) for name in names}


def load(name: str) -> ctypes.CDLL:
  """The library built from csrc/<name>. Where it is missing, every
  missing library is compiled first, in parallel, so that a process's
  first kernels wait for one round of nvcc; only this source's failure
  raises here (another source raises when it is loaded)."""
  if name not in _LOADED:
    path = library_path(name)
    if not path.exists():
      failures = _compile(sources())
      if name in failures:
        _raise_for({name: failures[name]})
    _LOADED[name] = ctypes.CDLL(str(path))
  return _LOADED[name]
