"""Builds the port's CUDA sources (csrc/*.cu) into shared libraries with
a plain C interface and loads them with ctypes.

Each source compiles on its own with nvcc for sm_90a, at first use, into
`ble_tpu_torch/_build/` (listed in .gitignore); the library's file name
carries a hash of the source, the shared headers (csrc/*.cuh) and the
flags, so an edited source or header rebuilds.
`build()` starts one nvcc per source, all at once, and waits for them;
nvcc's output, with ptxas's register and spill report, is kept beside each
library as `<library>.log`. Each build adds one to the tracer's
`kernels_built` counter (utils/profiling.py).
"""

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time

import torch

from ble_tpu_torch.utils import profiling

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG, 'csrc')
BUILD_DIR = os.path.join(_PKG, '_build')

_COMMON_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-O3',
                 '-std=c++17', '-shared', '-Xcompiler', '-fPIC',
                 '-Xptxas', '-v')
# Per-source flags. physics.cu keeps every multiply and add rounding on its
# own (see the note at its top).
SOURCES = {
    'physics': ('--fmad=false',),
    'gp_window': (),
    'gp_observe': (),
    'gp_query': (),
}

_loaded = {}


def _nvcc() -> str:
  home = os.environ.get('CUDA_HOME') or os.environ.get('CUDA_PATH')
  candidates = [os.path.join(home, 'bin', 'nvcc')] if home else []
  candidates.append('/usr/local/cuda/bin/nvcc')
  for path in candidates:
    if os.path.isfile(path):
      return path
  found = shutil.which('nvcc')
  if found is None:
    raise RuntimeError('nvcc not found (set CUDA_HOME); the CUDA kernels '
                       'are built from csrc/ at first use')
  return found


def library_path(name: str) -> str:
  src = os.path.join(CSRC_DIR, f'{name}.cu')
  with open(src, 'rb') as f:
    digest = hashlib.sha256(f.read())
  for header in sorted(n for n in os.listdir(CSRC_DIR) if n.endswith('.cuh')):
    with open(os.path.join(CSRC_DIR, header), 'rb') as f:
      digest.update(f.read())
  digest.update(' '.join(_COMMON_FLAGS + SOURCES[name]).encode())
  return os.path.join(BUILD_DIR, f'lib{name}-{digest.hexdigest()[:16]}.so')


def build(names=None) -> dict:
  """Compiles the named sources (default: all) that are not built yet, one
  nvcc process each, in parallel. Returns {name: seconds} for what it
  built; raises with nvcc's output if a build fails."""
  with profiling.span('cuda_build.build'):
    names = list(SOURCES) if names is None else list(names)
    todo = [n for n in names if not os.path.isfile(library_path(n))]
    if not todo:
      return {}
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    start = time.perf_counter()
    for name in todo:
      out = library_path(name)
      tmp = f'{out}.{os.getpid()}.tmp'
      cmd = [nvcc, *_COMMON_FLAGS, *SOURCES[name], '-o', tmp,
             os.path.join(CSRC_DIR, f'{name}.cu')]
      procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT), tmp, out)
    seconds, failures = {}, []
    for name, (proc, tmp, out) in procs.items():
      output, _ = proc.communicate()
      seconds[name] = time.perf_counter() - start
      text = output.decode(errors='replace')
      if proc.returncode != 0:
        failures.append(f'{name}.cu:\n{text}')
        continue
      with open(f'{out}.log', 'w') as f:
        f.write(text)
      os.replace(tmp, out)
      profiling.count('kernels_built')
    if failures:
      raise RuntimeError('nvcc failed:\n' + '\n'.join(failures))
    return seconds


def load(name: str) -> ctypes.CDLL:
  """The ctypes handle of csrc/<name>.cu's library, building it if needed."""
  lib = _loaded.get(name)
  if lib is None:
    with profiling.span('cuda_build.load'):
      build([name])
      lib = ctypes.CDLL(library_path(name))
    _loaded[name] = lib
  return lib


@functools.lru_cache(maxsize=None)
def entry(name: str, function: str, argtypes: tuple):
  """The C entry point `function` of csrc/<name>.cu's library with its
  ctypes signature (`argtypes`, an int return) set once, when first asked
  for."""
  fn = getattr(load(name), function)
  fn.argtypes = list(argtypes)
  fn.restype = ctypes.c_int
  return fn


@functools.lru_cache(maxsize=None)
def sm_count(device_index: int) -> int:
  """The number of SMs of CUDA device `device_index`."""
  return torch.cuda.get_device_properties(device_index).multi_processor_count


def check(status: int, what: str) -> None:
  """Raises if a C entry point returned a CUDA error code."""
  if status != 0:
    raise RuntimeError(f'{what}: CUDA error {status}')


def check_buffers(device, specs) -> None:
  """Raises unless every (name, tensor, shape, dtype) of `specs` is a
  contiguous, 16-byte aligned CUDA tensor of that shape and dtype on
  `device`: what the kernels' C entry points take."""
  for name, a, shape, dtype in specs:
    if (tuple(a.shape) != tuple(shape) or a.dtype != dtype or
        not a.is_cuda or a.device != device or not a.is_contiguous() or
        a.data_ptr() % 16):
      raise ValueError(f'{name}: expected a contiguous, 16-byte aligned '
                       f'{dtype} {tuple(shape)} on {device}, got {a.dtype} '
                       f'{tuple(a.shape)} on {a.device}')
