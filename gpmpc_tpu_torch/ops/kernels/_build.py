"""Build and load the hand-written CUDA kernels.

Each `csrc/<name>.cu` is compiled by `nvcc` into its own shared library with a
plain C interface and loaded with `ctypes` (no PyTorch headers, so a build
takes seconds). Builds happen at first use, only from the sources in this
package, into `gpmpc_tpu_torch/_build/`; the library's file name carries a
hash of its source, the shared headers and the flags, so an edited source or
header is rebuilt. Nothing here
runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / 'csrc'
BUILD_DIR = Path(__file__).resolve().parents[2] / '_build'
# --split-compile=4 optimizes a source's many template instances on 4
# threads: K4's float source took 135 s without it and 87 s with it, five
# sources side by side on an 8-core host of an H100 (PERF.md).
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17', '-O3',
              '--split-compile=4', '-shared', '-Xcompiler', '-fPIC')

_loaded: dict[str, ctypes.CDLL] = {}


def find_nvcc() -> str:
    """Path of `nvcc`: $CUDA_HOME/bin, then /usr/local/cuda/bin, then PATH."""
    candidates = []
    if os.environ.get('CUDA_HOME'):
        candidates.append(Path(os.environ['CUDA_HOME']) / 'bin' / 'nvcc')
    candidates.append(Path('/usr/local/cuda/bin/nvcc'))
    for c in candidates:
        if c.is_file():
            return str(c)
    found = shutil.which('nvcc')
    if found is None:
        raise RuntimeError('nvcc not found: the CUDA kernels are built from '
                           'source at first use and need the CUDA toolkit')
    return found


def library_path(name: str) -> Path:
    """The library built from `csrc/<name>.cu`. Its name hashes the source,
    every `csrc/*.cuh` (a shared header edits every library that includes
    it) and the flags."""
    h = hashlib.sha256((CSRC / f'{name}.cu').read_bytes())
    for header in sorted(CSRC.glob('*.cuh')):
        h.update(header.name.encode() + b'\0' + header.read_bytes())
    h.update(' '.join(NVCC_FLAGS).encode())
    return BUILD_DIR / f'lib{name}-{h.hexdigest()[:16]}.so'


def _start_build(name: str, nvcc: str):
    """Start nvcc for one source, its output to a log file beside the
    library (a pipe could fill and stall it); returns (process, tmp path,
    final path, log path)."""
    out = library_path(name)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f'.{os.getpid()}.tmp')
    log = out.with_suffix(f'.{os.getpid()}.log')
    cmd = [nvcc, *NVCC_FLAGS, '-o', str(tmp), str(CSRC / f'{name}.cu')]
    with open(log, 'w') as f:
        proc = subprocess.Popen(cmd, stdout=f, stderr=subprocess.STDOUT)
    return proc, tmp, out, log


def _finish_build(name: str, started) -> float:
    """Wait for one source's nvcc and install its library; returns the
    wall-clock time (time.time()) at which nvcc wrote it."""
    proc, tmp, out, log = started
    proc.wait()
    text = log.read_text()
    log.unlink(missing_ok=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f'nvcc failed on csrc/{name}.cu '
                           f'(exit {proc.returncode}):\n{text}')
    written = tmp.stat().st_mtime
    os.replace(tmp, out)      # atomic: a concurrent build sees all or none
    return written


def build_all() -> tuple[float, dict[str, float]]:
    """Build every `csrc/*.cu` that is not built yet, one nvcc per source, all
    started together. Returns the wall seconds taken and each built
    source's seconds from the start until nvcc wrote its library."""
    t0, wall0 = time.perf_counter(), time.time()
    todo = sorted(p.stem for p in CSRC.glob('*.cu')
                  if not library_path(p.stem).is_file())
    if not todo:
        return time.perf_counter() - t0, {}
    nvcc = find_nvcc()
    running = {name: _start_build(name, nvcc) for name in todo}
    each = {name: _finish_build(name, started) - wall0
            for name, started in running.items()}
    return time.perf_counter() - t0, each


def load(name: str) -> ctypes.CDLL:
    """The loaded library built from `csrc/<name>.cu`, building it if needed."""
    lib = _loaded.get(name)
    if lib is None:
        if not library_path(name).is_file():
            _finish_build(name, _start_build(name, find_nvcc()))
        lib = ctypes.CDLL(str(library_path(name)))
        _loaded[name] = lib
    return lib
