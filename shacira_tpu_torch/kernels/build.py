"""Build and load the port's CUDA kernels.

Each ``shacira_tpu_torch/csrc/<name>.cu`` is compiled by ``nvcc`` for
Hopper (``sm_90a``) into ``build/kernels/lib<name>.so`` at the repository
root (a git-ignored directory) the first time it is needed, and loaded with
``ctypes``.  The sources expose a plain C interface (pointers, sizes and the
CUDA stream as integers), so the build takes seconds: no PyTorch headers.

There is no fallback: if ``nvcc`` is missing or a build fails, this raises.

For measurement only, :func:`load` with ``count_atomics=True`` gives the
same source built with ``-DCOUNT_GLOBAL_ATOMICS`` into
``lib<name>_count.so``: its merging kernels also count the global float
atomics they issue, read and cleared by :func:`take_global_atomics`
(``COUNTING_SOURCES``: the sources with float atomics).  The wrappers on
the training path always load the normal build.
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


COUNT_FLAGS = ('-DCOUNT_GLOBAL_ATOMICS',)
COUNTING_SOURCES = ('paged_hash', 'scatter')


def _library_path(name: str, count_atomics: bool = False) -> Path:
    return BUILD_DIR / f'lib{name}{"_count" if count_atomics else ""}.so'


def compile_source(src: Path, lib: Path, flags=()) -> Path:
    """Compile the CUDA source ``src`` (with the extra nvcc ``flags``) into
    the shared library ``lib`` unless ``lib`` is newer than ``src``."""
    if not src.exists():
        raise FileNotFoundError(src)
    if lib.exists() and lib.stat().st_mtime >= src.stat().st_mtime:
        return lib
    lib.parent.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f'.{os.getpid()}.tmp')
    cmd = [_nvcc(), *NVCC_FLAGS, *flags, '-o', str(tmp), str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f'nvcc failed for {src.name}:\n{proc.stderr}')
    os.replace(tmp, lib)       # atomic: a concurrent build never sees half
    return lib


def build(name: str, count_atomics: bool = False) -> Path:
    """Compile ``csrc/<name>.cu`` unless an up-to-date library exists."""
    return compile_source(CSRC / f'{name}.cu',
                          _library_path(name, count_atomics),
                          COUNT_FLAGS if count_atomics else ())


def build_all() -> list:
    """Compile every source under ``csrc/`` at once, and the counting
    builds of ``COUNTING_SOURCES``, one ``nvcc`` each."""
    jobs = [(n, False) for n in sources()] + [
        (n, True) for n in sources() if n in COUNTING_SOURCES]
    with ThreadPoolExecutor(max_workers=len(jobs)) as pool:
        return list(pool.map(lambda j: build(*j), jobs))


@functools.cache
def load(name: str, count_atomics: bool = False) -> ctypes.CDLL:
    """Build if needed and load ``lib<name>.so`` (``lib<name>_count.so``
    with ``count_atomics``)."""
    return ctypes.CDLL(str(build(name, count_atomics)))


def take_global_atomics(lib: ctypes.CDLL) -> int:
    """The global atomics a counting build's kernels issued since the last
    call (waits for the device); clears the count."""
    count = ctypes.c_ulonglong(0)
    err = lib.take_global_atomics(ctypes.byref(count))
    if err != 0:
        raise RuntimeError(f'take_global_atomics: CUDA error {err}')
    return count.value
