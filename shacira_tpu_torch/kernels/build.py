"""Build and load the port's CUDA kernels.

Each ``shacira_tpu_torch/csrc/<name>.cu`` is compiled by ``nvcc`` for
Hopper (``sm_90a``) into ``build/kernels/lib<name>.so`` at the repository
root (a git-ignored directory) the first time it is needed, and loaded with
``ctypes``.  The sources expose a plain C interface (pointers, sizes and the
CUDA stream as integers), so the build takes seconds: no PyTorch headers.

There is no fallback: if ``nvcc`` is missing or a build fails, this raises.
"""
from __future__ import annotations

import ctypes
import functools
import os
import shutil
import subprocess
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / 'csrc'
BUILD_DIR = Path(__file__).resolve().parents[2] / 'build' / 'kernels'
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17', '-O3',
              '-shared', '-Xcompiler', '-fPIC')


def sources():
    """Names of every kernel source under ``csrc/``."""
    return sorted(p.stem for p in CSRC.glob('*.cu'))


def _nvcc() -> str:
    found = shutil.which('nvcc')
    if found:
        return found
    default = '/usr/local/cuda/bin/nvcc'
    if os.path.exists(default):
        return default
    raise RuntimeError('nvcc not found: the CUDA kernels cannot be built')


def _library_path(name: str) -> Path:
    return BUILD_DIR / f'lib{name}.so'


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless an up-to-date library exists."""
    src = CSRC / f'{name}.cu'
    if not src.exists():
        raise FileNotFoundError(src)
    lib = _library_path(name)
    if lib.exists() and lib.stat().st_mtime >= src.stat().st_mtime:
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f'.{os.getpid()}.tmp')
    cmd = [_nvcc(), *NVCC_FLAGS, '-o', str(tmp), str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f'nvcc failed for {src.name}:\n{proc.stderr}')
    os.replace(tmp, lib)       # atomic: a concurrent build never sees half
    return lib


def build_all() -> list:
    """Compile every source under ``csrc/`` at once, one ``nvcc`` each."""
    names = sources()
    with ThreadPoolExecutor(max_workers=len(names)) as pool:
        return list(pool.map(build, names))


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """Build if needed and load ``lib<name>.so``."""
    return ctypes.CDLL(str(build(name)))
