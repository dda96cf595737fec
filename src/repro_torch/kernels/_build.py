"""Build, load and bind the port's hand-written CUDA sources.

Every kernel source (``kernels/<name>/<name>.cu``) has a plain C
interface. It is compiled with ``nvcc`` for ``sm_90a`` at its first use
into ``build/repro_torch_ext/`` at the repository root, as a shared
library whose name carries the hash of the source, of every ``*.cuh``
header beside it or in ``kernels/`` itself (``head_dims.cuh``, shared by
the attention sources) and of the flags (so an edited source or header
rebuilds), and loaded with ``ctypes``. Both directories are on nvcc's
include path. No PyTorch header is compiled, so a build takes
seconds. :func:`build_all` starts one ``nvcc`` per source, all at once,
and waits for them together.

Each source exports ``<prefix>_error_string(int)`` next to its launchers;
each launcher returns ``cudaGetLastError()`` right after its launch, and
:meth:`CudaLibrary.check` raises on anything but 0.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_ext"
NVCC_FLAGS = ("-O3", "-std=c++17", "-gencode", "arch=compute_90a,code=sm_90a",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
#: The kernels' own directory: its ``*.cuh`` headers are shared by every
#: source (on nvcc's include path, in every library's hash).
KERNELS_DIR = Path(__file__).resolve().parent


def _head_dims() -> Tuple[int, ...]:
    """The ``X(D)`` arms of ``head_dims.cuh``'s ``REPRO_HEAD_DIMS``."""
    text = (KERNELS_DIR / "head_dims.cuh").read_text()
    macro = text.split("#define REPRO_HEAD_DIMS(X)", 1)[1]
    return tuple(int(d) for d in re.findall(r"X\((\d+)\)", macro))


#: Head dims every attention kernel is instantiated for (the flash and
#: paged wrappers' ``HEAD_DIMS``), read from the list the CUDA sources
#: expand, ``head_dims.cuh``.
HEAD_DIMS = _head_dims()


def _head_dim_pairs() -> Tuple[Tuple[int, int], ...]:
    """The ``X(D, DV)`` arms of ``head_dims.cuh``'s
    ``REPRO_HEAD_DIM_PAIRS``."""
    text = (KERNELS_DIR / "head_dims.cuh").read_text()
    macro = text.split("#define REPRO_HEAD_DIM_PAIRS(X)", 1)[1]
    return tuple((int(a), int(b)) for a, b in
                 re.findall(r"X\((\d+),\s*(\d+)\)", macro))


#: (q/k head dim, value head dim) pairs with a narrower value head that
#: the bf16 flash kernels are instantiated for (``head_dims.cuh``).
HEAD_DIM_PAIRS = _head_dim_pairs()

#: ctypes argument types by short name, for the signature tables.
CTYPES = {"ptr": ctypes.c_void_p, "i64": ctypes.c_int64, "i32": ctypes.c_int,
          "f32": ctypes.c_float}

Signature = Tuple[Sequence[str], str]


def nvcc() -> str:
    """Path of the CUDA compiler (``$CUDA_HOME/bin/nvcc``, else the one
    on ``PATH``); raises when there is none."""
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the port's CUDA kernels are "
                           "built from source at first use and need the "
                           "CUDA toolkit")
    return found


class CudaLibrary:
    """One CUDA source, its compiled library and its bound functions.

    ``functions`` maps each exported launcher to ``(argument types,
    return type)`` by the short names of :data:`CTYPES`; ``prefix`` names
    the source's ``<prefix>_error_string``. ``info`` is filled at first
    load: library path, whether this process compiled it, compile
    seconds, and nvcc's ptxas report (registers, shared memory, spills).
    """

    def __init__(self, prefix: str, source: Path,
                 functions: Dict[str, Signature]):
        self.prefix = prefix
        self.source = Path(source)
        self.functions = dict(functions)
        self.info: Dict[str, object] = {}
        self._lib: Optional[ctypes.CDLL] = None
        self._lock = threading.Lock()

    def path(self) -> Path:
        """Where the library for the current source, headers and flags
        lives: ``build/repro_torch_ext/<prefix>_<hash>.so``, the hash over
        the source, each ``*.cuh`` of its directory and of
        :data:`KERNELS_DIR` (name and bytes, sorted by name) and the
        flags."""
        h = hashlib.sha256(self.source.read_bytes())
        for folder in self._include_dirs():
            for header in sorted(folder.glob("*.cuh")):
                h.update(header.name.encode() + b"\0" + header.read_bytes())
        h.update(" ".join(NVCC_FLAGS).encode())
        return BUILD_DIR / f"{self.prefix}_{h.hexdigest()[:16]}.so"

    def _include_dirs(self) -> List[Path]:
        """nvcc's include path: the source's directory, then
        :data:`KERNELS_DIR`."""
        dirs = [self.source.parent]
        if KERNELS_DIR.resolve() != self.source.parent.resolve():
            dirs.append(KERNELS_DIR)
        return dirs

    def _start(self) -> Optional[Tuple[subprocess.Popen, Path, List[str],
                                       float]]:
        """Start nvcc when the library is missing; None when it exists."""
        if self._lib is not None:
            return None
        path = self.path()
        if path.exists():
            return None
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(f".{os.getpid()}.tmp.so")
        includes = [a for d in self._include_dirs() for a in ("-I", str(d))]
        cmd = [nvcc(), *NVCC_FLAGS, *includes, "-o", str(tmp),
               str(self.source)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        return proc, tmp, cmd, time.perf_counter()

    def _finish(self, started) -> ctypes.CDLL:
        """Wait for a started build, then load and bind the library."""
        if self._lib is not None:
            return self._lib
        path = self.path()
        built, seconds, log = False, 0.0, ""
        if started is not None:
            proc, tmp, cmd, t0 = started
            log, _ = proc.communicate()
            seconds = time.perf_counter() - t0
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed ({proc.returncode}): "
                                   f"{' '.join(cmd)}\n{log}")
            os.replace(tmp, path)
            built = True
        lib = ctypes.CDLL(str(path))
        for name, (args, ret) in self.functions.items():
            fn = getattr(lib, name)
            fn.argtypes = [CTYPES[a] for a in args]
            fn.restype = CTYPES[ret]
        err_fn = getattr(lib, f"{self.prefix}_error_string")
        err_fn.argtypes = [ctypes.c_int]
        err_fn.restype = ctypes.c_char_p
        self.info.update(path=str(path), built=built, seconds=seconds,
                         ptxas=log)
        self._lib = lib
        return lib

    def load(self) -> ctypes.CDLL:
        """Compile the source (once per source hash) and load it; a failed
        compile raises with nvcc's output."""
        if self._lib is not None:
            return self._lib
        with self._lock:
            return self._finish(self._start())

    def check(self, err: int, name: str) -> None:
        """Raise when a launcher returned a CUDA error code."""
        if err != 0:
            msg = getattr(self._lib, f"{self.prefix}_error_string")(err)
            raise RuntimeError(f"{name} launch failed: CUDA error {err} "
                               f"({msg.decode()})")


def build_all(libraries: Iterable[CudaLibrary]) -> None:
    """Build every missing library with one nvcc each, all started
    together, then load them all. Every compiler process is waited for
    before the first failure is raised."""
    libs = list(libraries)
    for lib in libs:
        lib._lock.acquire()
    try:
        started = [lib._start() for lib in libs]
        errors = []
        for lib, st in zip(libs, started):
            try:
                lib._finish(st)
            except RuntimeError as exc:
                errors.append(exc)
        if errors:
            raise errors[0]
    finally:
        for lib in libs:
            lib._lock.release()
