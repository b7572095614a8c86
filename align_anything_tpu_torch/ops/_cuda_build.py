"""nvcc build and ctypes binding of the port's hand-written CUDA kernels.

Each source under ``csrc/`` has a plain C interface; ``CudaLibrary``
compiles it for sm_90a into the gitignored ``_build/`` directory at first
use (one shared library per hash of source + flags, so an edited source is
rebuilt and an unchanged one reused), loads it with ctypes and lets the
caller set the argument types.  Nothing is built when a module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import subprocess
import threading
from pathlib import Path
from typing import Callable

CSRC = Path(__file__).resolve().parents[1] / 'csrc'
BUILD_DIR = Path(__file__).resolve().parents[1] / '_build'
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17', '-O3',
              '-shared', '-Xcompiler', '-fPIC', '--ptxas-options=-v')


def _cuda_tool(name: str) -> str:
    from torch.utils.cpp_extension import CUDA_HOME  # noqa: PLC0415

    if CUDA_HOME is None:
        raise RuntimeError('CUDA toolkit not found: set CUDA_HOME')
    return os.path.join(CUDA_HOME, 'bin', name)


class CudaLibrary:
    """``csrc/<name>.cu`` built and loaded once per process.

    ``bind(lib)`` sets the ctypes signatures of the loaded library.
    ``build_log`` holds nvcc's and ptxas's output of the build this process
    ran (empty when the library was already built)."""

    def __init__(self, name: str, bind: Callable[[ctypes.CDLL], None]):
        self.name = name
        self.source = CSRC / f'{name}.cu'
        self._bind = bind
        self._lock = threading.Lock()
        self._lib: ctypes.CDLL | None = None
        self.build_log = ''

    def compile(self) -> Path:
        """Run nvcc unless the library for this source + flags exists;
        raises with nvcc's output if it fails."""
        src = self.source.read_bytes()
        tag = hashlib.sha256(src + ' '.join(NVCC_FLAGS).encode()
                             ).hexdigest()[:16]
        so = BUILD_DIR / f'{self.name}_{tag}.so'
        if not so.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = so.with_name(f'{so.name}.{os.getpid()}.tmp')
            proc = subprocess.run(
                [_cuda_tool('nvcc'), *NVCC_FLAGS, '-o', str(tmp), str(self.source)],
                capture_output=True, text=True)
            self.build_log = proc.stdout + proc.stderr
            if proc.returncode != 0:
                raise RuntimeError(
                    f'nvcc failed for {self.source}:\n{self.build_log}')
            os.replace(tmp, so)
        return so

    def tensor_core_counts(self) -> dict[str, int]:
        """Tensor-core instructions (HMMA, HGMMA) per kernel in the SASS of
        the built library (``cuobjdump -sass``), by mangled kernel name."""
        sass = subprocess.run(
            [_cuda_tool('cuobjdump'), '-sass', str(self.compile())],
            capture_output=True, text=True, check=True).stdout
        counts: dict[str, int] = {}
        name = None
        for line in sass.splitlines():
            if 'Function :' in line:
                name = line.split('Function :', 1)[1].strip()
                counts[name] = 0
            elif name is not None and ('HMMA' in line or 'HGMMA' in line):
                counts[name] += 1
        return counts

    def ptxas_resources(self) -> dict[str, dict[str, int]]:
        """Registers and spill bytes per kernel (mangled name) as ptxas
        reported them in ``build_log``; empty when this process did not
        build the library."""
        out: dict[str, dict[str, int]] = {}
        name = None
        for line in self.build_log.splitlines():
            found = (re.search(r"Compiling entry function '([^']+)'", line)
                     or re.search(r'Function properties for (\S+)', line))
            if found:
                name = found.group(1)
                out.setdefault(name, {})
                continue
            if name is None:
                continue
            spill = re.search(r'(\d+) bytes spill stores, (\d+) bytes spill '
                              r'loads', line)
            if spill:
                out[name]['spill_stores'] = int(spill.group(1))
                out[name]['spill_loads'] = int(spill.group(2))
            regs = re.search(r'Used (\d+) registers', line)
            if regs:
                out[name]['registers'] = int(regs.group(1))
        return out

    def load(self) -> ctypes.CDLL:
        with self._lock:
            if self._lib is None:
                lib = ctypes.CDLL(str(self.compile()))
                self._bind(lib)
                self._lib = lib
            return self._lib
