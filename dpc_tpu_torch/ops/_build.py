"""Build, load and count the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` is compiled on first use with ``nvcc`` for
``sm_90a`` into a shared library with a plain C interface, and loaded with
``ctypes``.  The library's file name carries a hash of its sources, so an
edited kernel is rebuilt and a stale one is never loaded.  Libraries go to
``dpc_tpu_torch/_kernels/`` (listed in ``.gitignore``).

Nothing here runs at import time: the CPU tests import every module of the
package on a machine with no ``nvcc`` and no card.

``LAUNCHES`` counts kernel launches by kernel name; each wrapper adds one
where it calls into the library, and nowhere else.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_kernels"
SOURCES = ("convgru", "nce", "maxpool")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

LAUNCHES: dict[str, int] = {"convgru_fwd": 0, "convgru_bwd": 0,
                            "nce_fwd": 0, "nce_bwd": 0,
                            "maxpool_relu_fwd": 0, "maxpool_relu_bwd": 0,
                            "maxpool_bwd_eq": 0}

_LIBS: dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels of dpc_tpu_torch "
                       "are built on first use and need the CUDA toolkit")


def lib_path(name: str) -> Path:
    h = hashlib.sha256()
    for src in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def _start_build(name: str) -> tuple[subprocess.Popen, Path, Path] | None:
    out = lib_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def build(names=SOURCES) -> dict[str, float]:
    """Compile every missing library, one ``nvcc`` per source, all started
    together.  Returns the wall seconds each build took (0 when cached).
    The compiler's report (registers, shared memory, spills) is kept
    beside each library as ``<lib>.log``."""
    t0 = time.perf_counter()
    jobs = {n: _start_build(n) for n in names}
    took = {}
    for name, job in jobs.items():
        if job is None:
            took[name] = 0.0
            continue
        proc, tmp, out = job
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{log}")
        out.with_suffix(".log").write_text(log)
        os.replace(tmp, out)
        took[name] = time.perf_counter() - t0
    return took


def build_log(name: str) -> str:
    p = lib_path(name).with_suffix(".log")
    return p.read_text() if p.exists() else ""


_SIGS = {
    "convgru": {"convgru_fwd": 11 * ["p"] + ["l"] + 4 * ["i"] + ["p"],
                "convgru_bwd": 17 * ["p"] + ["l"] + 4 * ["i"] + ["p"],
                "convgru_fwd_scratch_floats": 4 * ["i"],
                "convgru_bwd_scratch_floats": 4 * ["i"]},
    "nce": {"nce_fwd": 7 * ["p"] + ["l"] + 3 * ["i"] + ["p"],
            "nce_bwd": 7 * ["p"] + ["l"] + 3 * ["i"] + ["p"],
            "nce_fwd_scratch_floats": 3 * ["i"],
            "nce_bwd_scratch_floats": 3 * ["i"]},
    "maxpool": {fn: 3 * ["p"] + ["l"] + 4 * ["i"] + ["p"]
                for fn in ("maxpool_relu_fwd", "maxpool_relu_bwd",
                           "maxpool_bwd_eq")},
}
# entry points that return something other than a CUDA error code
_RESTYPES = {fn: "l" for fn in ("nce_fwd_scratch_floats", "nce_bwd_scratch_floats",
                                   "convgru_fwd_scratch_floats",
                                   "convgru_bwd_scratch_floats")}


def library(name: str) -> ctypes.CDLL:
    """The loaded kernel library ``name``, built first if needed."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build((name,))
            lib = ctypes.CDLL(str(lib_path(name)))
            kinds = {"p": ctypes.c_void_p, "i": ctypes.c_int,
                     "l": ctypes.c_longlong}
            for fn, sig in _SIGS[name].items():
                f = getattr(lib, fn)
                f.argtypes = [kinds[s] for s in sig]
                f.restype = kinds[_RESTYPES.get(fn, "i")]
            _LIBS[name] = lib
        return lib


def launch(lib_name: str, fn: str, *args) -> None:
    """Call ``fn`` of library ``lib_name`` on PyTorch's current stream and
    raise if the launch was refused.  Tensors are passed by data pointer;
    the caller keeps them alive across the call."""
    lib = library(lib_name)
    conv = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    stream = torch.cuda.current_stream().cuda_stream
    err = getattr(lib, fn)(*conv, stream)
    if err != 0:
        raise RuntimeError(f"CUDA kernel {fn} failed to launch: error {err}")
    LAUNCHES[fn] += 1


def scratch(lib_name: str, size_fn: str, device, *dims) -> torch.Tensor:
    """The f32 scratch an entry point of library ``lib_name`` needs, sized
    by its host-side function ``size_fn`` (no kernel launch, not counted)."""
    n = getattr(library(lib_name), size_fn)(*dims)
    return torch.empty(n, device=device, dtype=torch.float32)


def check_cuda_f32(*tensors) -> None:
    """The kernels take contiguous f32 tensors on one CUDA device."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev or t.device.type != "cuda":
            raise ValueError(f"kernel input on {t.device}, expected {dev} (cuda)")
        if t.dtype != torch.float32:
            raise TypeError(f"kernel input has dtype {t.dtype}; the kernels "
                            "take and return float32")
        if not t.is_contiguous():
            raise ValueError("kernel input must be contiguous")
