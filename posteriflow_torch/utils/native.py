"""The port's native libraries (csrc/): built at first use, loaded with
ctypes.

A `Library` compiles one source with its own compiler and flags into the
git-ignored ``posteriflow_torch/_build/`` as ``lib<stem>_<tag>.so``, the
tag the first 16 hex digits of sha256(source bytes + " ".join(flags)), so
a changed source or flag builds anew and an unchanged one is loaded from
the cache. The compiler writes a temporary file that `os.replace` moves
into place, and its output is kept beside the library as ``.log``; a
failed build raises RuntimeError with that output. The sources have plain
C interfaces, so a build takes seconds and needs neither ninja nor pybind.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Callable, Optional

import torch

BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
# nvcc arguments that do not key the name: ptxas's register and spill report
PTXAS_VERBOSE = ("-Xptxas", "-v")


def find_nvcc(default_home: str = "/usr/local/cuda") -> str:
    """Path of nvcc from $CUDA_HOME, then $PATH, then the toolkit's
    standard prefix. Raises RuntimeError if none has it."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(Path(on_path))
    candidates.append(Path(default_home) / "bin" / "nvcc")
    for c in candidates:
        if c.is_file() and os.access(c, os.X_OK):
            return str(c)
    raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit or "
                       "put nvcc on PATH")


@functools.lru_cache(maxsize=None)
def sm_count(device_index: int) -> int:
    """The number of SMs of the card `device_index`, read once."""
    return torch.cuda.get_device_properties(
        device_index).multi_processor_count


class Library:
    """`source` built by `compiler()` (looked up only when a build is
    needed; nvcc by default) with `flags`, then `extra`, which does not key
    the name. `load` sets `build_seconds` (None: the library was cached)
    and `build_log` (the compiler's output, kept beside the library)."""

    def __init__(self, source: Path, flags: tuple, stem: str,
                 compiler: Callable[[], str] = find_nvcc,
                 extra: tuple = PTXAS_VERBOSE):
        self.source = source
        self.flags = flags
        self.stem = stem
        self.compiler = compiler
        self.extra = extra
        self.build_seconds: Optional[float] = None
        self.build_log = ""
        self._lib: Optional[ctypes.CDLL] = None

    @property
    def path(self) -> Path:
        tag = hashlib.sha256(self.source.read_bytes()
                             + " ".join(self.flags).encode()).hexdigest()[:16]
        return BUILD_DIR / f"lib{self.stem}_{tag}.so"

    def command(self, compiler: str, output: Path) -> list:
        return [compiler, *self.flags, *self.extra, "-o", str(output),
                str(self.source)]

    def build(self) -> Path:
        """Compile the library unless it is there -> its path."""
        so = self.path
        log = so.with_suffix(".log")
        if not so.exists():
            so.parent.mkdir(parents=True, exist_ok=True)
            tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
            cmd = self.command(self.compiler(), tmp)
            t0 = time.perf_counter()
            try:
                proc = subprocess.run(cmd, capture_output=True, text=True)
            except OSError as e:
                raise RuntimeError(f"{cmd[0]} could not run: {e}") from e
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                raise RuntimeError(f"{' '.join(cmd)} failed with code "
                                   f"{proc.returncode}:\n{proc.stdout}\n"
                                   f"{proc.stderr}")
            log.write_text(proc.stdout + proc.stderr)
            os.replace(tmp, so)
            self.build_seconds = time.perf_counter() - t0
        self.build_log = log.read_text() if log.exists() else ""
        return so

    def load(self) -> ctypes.CDLL:
        if self._lib is None:
            self._lib = ctypes.CDLL(str(self.build()))
        return self._lib

    def bind(self, name: str, argtypes: list, restype=ctypes.c_int):
        """The library's C function `name`, its signature set."""
        fn = getattr(self.load(), name)
        fn.argtypes, fn.restype = argtypes, restype
        return fn
