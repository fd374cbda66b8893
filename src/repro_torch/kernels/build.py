"""Build and bind the hand-written CUDA kernels (plain C interface).

Each ``csrc/<name>.cu`` is compiled on first use, on the machine with the
card, into its own shared library with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v

and loaded with ``ctypes``. The library lands in ``_build/`` beside this
file (listed in ``.gitignore``) under a name that carries a hash of the
sources and flags, so an edited kernel is never served from a stale
build. ``build_all()`` starts one ``nvcc`` per source, all at once.

Every exported entry point takes tensor pointers and the CUDA stream as
``c_void_p``, sizes as ``c_int``, scalars as ``c_double``, and returns
``cudaGetLastError()`` after its launch; ``CudaLibrary.launch`` raises if
that is not 0 and otherwise counts one launch. The count is the evidence
that a run went through the kernel: it rises only where a kernel was
actually enqueued. A call made while the stream is being captured into
a CUDA graph enqueues nothing: it counts in ``recorded_counts()``
instead, and the graph's replays launch the kernel without a host call
(``repro_torch.solver.program`` counts those). A profiler trace names
each kernel by its own device name.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

P, I, D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double

#: Every library of this package, by source name (filled at import of
#: the kernel modules).
LIBRARIES: dict[str, "CudaLibrary"] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    fallback = Path("/usr/local/cuda/bin/nvcc")
    if fallback.exists():
        return str(fallback)
    raise RuntimeError("nvcc not found: the CUDA kernels are built on the "
                       "machine with the card (CUDA toolkit on PATH or in "
                       "/usr/local/cuda)")


class CudaLibrary:
    """One ``csrc/<name>.cu`` source: its build, its ctypes binding and
    the count of kernel launches made through it."""

    def __init__(self, name: str, signatures: dict[str, list]):
        self.name = name
        self.signatures = signatures      # symbol -> argtypes (stream last)
        self.launches = 0
        self.recorded = 0
        self.build_log = ""
        self._lib = None
        LIBRARIES[name] = self

    @property
    def source(self) -> Path:
        return CSRC / f"{self.name}.cu"

    def target(self) -> Path:
        h = hashlib.sha256()
        for f in sorted(CSRC.glob("*.cuh")) + [self.source]:
            h.update(f.read_bytes())
        h.update(" ".join(NVCC_FLAGS).encode())
        return BUILD_DIR / f"{self.name}-{h.hexdigest()[:16]}.so"

    def start_build(self):
        """Start ``nvcc`` for this source unless built; returns the
        process (or None when the library is already there)."""
        out = self.target()
        if out.exists():
            return None
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(self.source)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        proc.repro_tmp, proc.repro_out = tmp, out
        return proc

    def finish_build(self, proc) -> None:
        if proc is None:
            return
        log, _ = proc.communicate()
        self.build_log = log
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {self.source}:\n{log}")
        os.replace(proc.repro_tmp, proc.repro_out)

    def lib(self):
        if self._lib is None:
            self.finish_build(self.start_build())
            lib = ctypes.CDLL(str(self.target()))
            for sym, argtypes in self.signatures.items():
                fn = getattr(lib, sym)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.repro_error_string.argtypes = [ctypes.c_int]
            lib.repro_error_string.restype = ctypes.c_char_p
            lib.repro_smem_bytes.argtypes = [I, I, I, I]
            lib.repro_smem_bytes.restype = ctypes.c_int
            self._lib = lib
        return self._lib

    def smem_bytes(self, elem: int, n: int, P: int, S: int) -> int:
        """Dynamic shared memory per block (bytes) that the launcher gives
        the kernel for ``elem``-byte reals, ``n``-particle leaves, ``P``
        coefficients and ``S``-wide lists (the launcher's own rule, read
        back)."""
        return self.lib().repro_smem_bytes(elem, n, P, S)

    def launch(self, symbol: str, *args) -> None:
        """Call ``symbol`` with tensors (as device pointers), ints and
        floats, on the current stream of the first tensor's device
        (counted as a launch, or as recorded while that stream captures a
        CUDA graph)."""
        dev = next(a.device for a in args if isinstance(a, torch.Tensor))
        stream = torch.cuda.current_stream(dev).cuda_stream
        conv = []
        for a in args:
            if isinstance(a, torch.Tensor):
                conv.append(a.data_ptr() if a.numel() else None)
            elif a is None:
                conv.append(None)
            else:
                conv.append(a)
        if len(conv) + 1 != len(self.signatures[symbol]):
            raise TypeError(f"{self.name}:{symbol} takes "
                            f"{len(self.signatures[symbol]) - 1} arguments "
                            f"before the stream, got {len(conv)}")
        lib = self.lib()
        rc = getattr(lib, symbol)(*conv, stream)
        if rc != 0:
            msg = lib.repro_error_string(rc).decode()
            raise RuntimeError(f"{self.name}:{symbol} launch failed: "
                               f"{msg} (cudaError {rc})")
        if torch.cuda.is_current_stream_capturing():
            self.recorded += 1
        else:
            self.launches += 1


def build_all() -> dict[str, str]:
    """Build every registered library, one ``nvcc`` per source, all
    started together; returns each library's compiler log (``-Xptxas
    -v``: registers, shared memory and spills per kernel)."""
    procs = {name: lib.start_build() for name, lib in LIBRARIES.items()}
    for name, proc in procs.items():
        LIBRARIES[name].finish_build(proc)
    return {name: lib.build_log for name, lib in LIBRARIES.items()}


def launch_counts() -> dict[str, int]:
    return {name: lib.launches for name, lib in LIBRARIES.items()}


def reset_launch_counts() -> None:
    for lib in LIBRARIES.values():
        lib.launches = 0


def recorded_counts() -> dict[str, int]:
    """Launches per kernel recorded into CUDA graphs while capturing
    (never reset: a program reads the difference around its capture)."""
    return {name: lib.recorded for name, lib in LIBRARIES.items()}


def check_tensors(*tensors, dtype=None, device=None) -> None:
    """Raise unless every tensor is contiguous, of ``dtype`` and on
    ``device`` (the kernels index raw row-major memory)."""
    for t in tensors:
        if t is None:
            continue
        if not t.is_contiguous():
            raise ValueError("kernel operand must be contiguous")
        if dtype is not None and t.dtype != dtype:
            raise TypeError(f"kernel operand dtype {t.dtype} != {dtype}")
        if device is not None and t.device != device:
            raise ValueError(f"kernel operand on {t.device}, not {device}")


def on_cpu(t: torch.Tensor) -> bool:
    """True for a CPU tensor (the wrappers then run their plain version);
    False for a CUDA tensor (they launch the kernel); any other device
    raises."""
    if t.device.type == "cpu":
        return True
    if t.device.type == "cuda":
        return False
    raise ValueError(f"no kernel or plain version for device {t.device}")
