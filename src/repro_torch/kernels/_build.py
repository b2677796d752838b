"""Build the CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/<name>.cu`` compiles into one shared library with a plain C
interface (no PyTorch headers, so a build takes seconds). Libraries go
to ``build/kernels/`` at the root of the checkout (listed in
``.gitignore``), named by a digest of the source, the shared headers
(``csrc/*.cuh``) and the flags, so an edited source or header is rebuilt
and a stale library is never loaded. The
compiler's report (``-Xptxas -v``: registers, shared memory, spills) is
kept beside each library as ``.log``.

Nothing is built when a module is imported: :func:`load` builds on first
use, and :func:`build` starts one ``nvcc`` per source, all at once.
There is no fallback: a missing ``nvcc`` or a failed build raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, Tuple

CSRC = Path(__file__).resolve().parents[1] / 'csrc'
BUILD_DIR = Path(__file__).resolve().parents[3] / 'build' / 'kernels'
SOURCES = ('fft_pencil', 'fft_matmul', 'fft_block')
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17', '-O3',
              '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v')

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin/nvcc``, else the CUDA
    toolkit's usual location, else the one on ``PATH``."""
    home = os.environ.get('CUDA_HOME') or os.environ.get('CUDA_PATH') or '/usr/local/cuda'
    cand = Path(home) / 'bin' / 'nvcc'
    if cand.exists():
        return str(cand)
    found = shutil.which('nvcc')
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME); the CUDA kernels are built "
            "from repro_torch/csrc on the machine with the card")
    return found


def library_path(name: str) -> Path:
    """Where the library of ``csrc/<name>.cu`` lives: named by a digest of
    that source, of every header in ``csrc`` (a source includes them by
    a quoted name, which ``nvcc`` finds beside it) and of the flags."""
    h = hashlib.sha256((CSRC / f'{name}.cu').read_bytes())
    for header in sorted(CSRC.glob('*.cuh')):
        h.update(header.name.encode() + b'\0' + header.read_bytes())
    h.update(' '.join(NVCC_FLAGS).encode())
    return BUILD_DIR / f'lib{name}-{h.hexdigest()[:12]}.so'


def build(names: Iterable[str] = SOURCES) -> Dict[str, Path]:
    """Compile every named source whose library is missing, one ``nvcc``
    process per source, all running at once. Returns name -> library."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = {name: library_path(name) for name in names}
    running: Dict[str, Tuple[subprocess.Popen, Path, Path]] = {}
    for name, lib in out.items():
        if lib.exists():
            continue
        tmp = lib.with_suffix(f'.{os.getpid()}.tmp')
        log = lib.with_suffix('.log')
        cmd = [nvcc(), *NVCC_FLAGS, '-o', str(tmp), str(CSRC / f'{name}.cu')]
        with open(log, 'w') as fh:
            proc = subprocess.Popen(cmd, stdout=fh, stderr=subprocess.STDOUT)
        running[name] = (proc, tmp, log)
    failed = []
    for name, (proc, tmp, log) in running.items():
        if proc.wait() != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{log.read_text()}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out[name])     # atomic: readers never see half a file
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return out


def build_log(name: str) -> str:
    """The compiler's report for the current build of ``name``."""
    return library_path(name).with_suffix('.log').read_text()


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build((name,))[name]))
            _LIBS[name] = lib
        return lib


def declare(lib: ctypes.CDLL, fn: str, n_ptrs: int, tail) -> None:
    """Set a launch function's signature: ``n_ptrs`` pointers, then the
    ``tail`` ctypes scalars, then the stream; it returns a CUDA error
    code."""
    f = getattr(lib, fn)
    f.argtypes = [ctypes.c_void_p] * n_ptrs + list(tail) + [ctypes.c_void_p]
    f.restype = ctypes.c_int
