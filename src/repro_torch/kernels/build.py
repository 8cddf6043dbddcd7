"""Build a CUDA source into a plain-C shared library and load it with ctypes.

Every kernel of the port is one ``csrc/<name>.cu`` with ``extern "C"``
entry points that return ``cudaGetLastError()``.  :class:`CudaLibrary`
compiles it at first use with ``nvcc`` for ``sm_90a`` into
``<kernel dir>/build/<name>-<hash>/lib<name>.so`` (git-ignored; the hash
covers the source, the headers it includes and the flags), loads it, and
lets the kernel module declare its entry points' ctypes signatures.
Nothing is built or loaded when a module is imported.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Callable, Optional, Sequence

# Flags every kernel is built with; each library adds its own.
BASE_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC")


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    raise RuntimeError("nvcc not found: the port's kernels are built at "
                       "first use and need the CUDA toolkit")


class CudaLibrary:
    """One kernel source, built once per process and loaded with ctypes.

    ``bind`` receives the loaded ``ctypes.CDLL`` and sets ``argtypes`` and
    ``restype`` of its entry points (``c_void_p`` for pointers and the
    stream, so that ctypes never cuts a 64-bit value).  ``headers`` are
    the files the source includes from the repository: they are hashed
    with it, so that a changed header rebuilds the library."""

    def __init__(self, name: str, source: Path, flags: Sequence[str],
                 bind: Callable[[ctypes.CDLL], None],
                 headers: Sequence[Path] = ()):
        self.name = name
        self.source = Path(source)
        self.headers = tuple(Path(h) for h in headers)
        self.flags = tuple(BASE_FLAGS) + tuple(flags)
        self.build_root = self.source.parent.parent / "build"
        self._bind = bind
        self._lib: Optional[ctypes.CDLL] = None
        # What the last compile in this process reported: seconds and
        # nvcc's output (``-Xptxas -v``: registers, shared memory, spills).
        self.build_info: dict = {}

    def build(self) -> Path:
        """Compile the source if it has not been built with these flags
        yet; return the shared library's path."""
        digest = hashlib.sha256(
            b"".join(f.read_bytes() for f in (self.source, *self.headers))
            + " ".join(self.flags).encode()).hexdigest()
        out_dir = self.build_root / f"{self.name}-{digest[:16]}"
        lib = out_dir / f"lib{self.name}.so"
        if lib.exists():
            return lib
        compiler = nvcc()
        out_dir.mkdir(parents=True, exist_ok=True)
        t0 = time.perf_counter()
        # Build into a temporary name and rename: a concurrent process
        # never loads a half-written library.
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
        os.close(fd)
        try:
            # The source comes first, so that a library flag (``-l``)
            # follows the object that needs it.
            proc = subprocess.run(
                [compiler, str(self.source), *self.flags, "-o", tmp],
                capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {self.source.name} "
                                   f"({proc.returncode}):\n{proc.stdout}\n"
                                   f"{proc.stderr}")
            os.replace(tmp, lib)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
        self.build_info.update(seconds=time.perf_counter() - t0,
                               log=(proc.stdout + proc.stderr).strip())
        return lib

    def ptxas(self) -> dict:
        """{entry function: (registers, spill stores, spill loads)} from
        the last compile's ``-Xptxas -v`` output in this process (empty
        if the library was built by another process)."""
        out, cur = {}, None
        for line in self.build_info.get("log", "").splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                cur = m.group(1)
                out[cur] = [None, None, None]
                continue
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", line)
            if m and cur:
                out[cur][1:] = [int(m.group(1)), int(m.group(2))]
            m = re.search(r"Used (\d+) registers", line)
            if m and cur:
                out[cur][0] = int(m.group(1))
        return {k: tuple(v) for k, v in out.items()}

    def load(self) -> ctypes.CDLL:
        if self._lib is None:
            lib = ctypes.CDLL(str(self.build()))
            self._bind(lib)
            self._lib = lib
        return self._lib


def check_launch(err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err}")
