"""The JPEG codec of the frame pipeline (the port's counterpart of
``dpc_tpu/native``), bound with ``ctypes``.

The library is built with ``g++`` on first use into
``dpc_tpu_torch/_kernels/`` (listed in ``.gitignore``), from one of two
sources with the same C ABI (``jpeg_common.h``):

  * ``jpeg_libjpeg.cpp`` where libjpeg's headers are installed: the
    decode of ``dpc_tpu/native/jpeg_decoder.cpp``, pixel for pixel;
  * ``jpeg_nvjpeg.cpp`` where they are not and the CUDA toolkit has
    nvJPEG: entropy decode on the host, IDCT on the GPU, the pixels copied
    back to host memory.

There is no OpenCV or PIL chain: when neither library builds, the first
call raises with the compiler's message.  Exposes :func:`decode_file`,
:func:`decode_jpeg`, the pthread batch decode :func:`decode_jpeg_batch`,
:func:`jpeg_dims` and the encoder :func:`encode_jpeg`, which writes frame
trees (the port's counterpart of ``dpc_tpu/data/preprocess.py``'s frame
extraction).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

_DIR = Path(__file__).resolve().parent
BUILD_DIR = _DIR.parent / "_kernels"
_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None


def _cuda_home() -> Path:
    return Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))


def _commands() -> list[tuple[str, list[str]]]:
    """(backend, g++ arguments after -o OUT) in the order they are tried."""
    cuda = _cuda_home()
    return [
        ("libjpeg", [str(_DIR / "jpeg_libjpeg.cpp"), "-ljpeg", "-lpthread"]),
        ("nvjpeg", [str(_DIR / "jpeg_nvjpeg.cpp"), f"-I{cuda}/include",
                    f"-L{cuda}/lib64", f"-Wl,-rpath,{cuda}/lib64",
                    "-lnvjpeg", "-lcudart_static", "-lpthread", "-ldl",
                    "-lrt"]),
    ]


def _lib_path(backend: str) -> Path:
    h = hashlib.sha256()
    for src in ("jpeg_common.h", f"jpeg_{backend}.cpp"):
        h.update((_DIR / src).read_bytes())
    return BUILD_DIR / f"libdpcjpeg_{backend}-{h.hexdigest()[:12]}.so"


def _compile(out: Path, args: list[str]) -> str:
    """Build one backend into ``out``; returns the failure, '' on success."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = ["g++", "-O3", "-std=c++17", "-shared", "-fPIC", "-o", str(tmp),
           *args]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=300)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"{' '.join(cmd)}\n{e}"
    if proc.returncode != 0:
        return f"{' '.join(cmd)}\n{proc.stderr.strip()}"
    os.replace(tmp, out)
    return ""


def _open() -> ctypes.CDLL:
    """Open the first backend that builds and loads; raises with every
    compiler's and loader's message when none does."""
    errors = []
    for backend, args in _commands():
        out = _lib_path(backend)
        if not out.exists():
            err = _compile(out, args)
            if err:
                errors.append(f"{backend}: {err}")
                continue
        try:
            return ctypes.CDLL(str(out))
        except OSError as e:  # built elsewhere against a missing library
            errors.append(f"{backend}: {e}")
    raise RuntimeError("the JPEG codec of dpc_tpu_torch did not build "
                       "(libjpeg's headers or the CUDA toolkit's nvJPEG "
                       "are needed):\n" + "\n".join(errors))


def _load() -> ctypes.CDLL:
    global _LIB
    with _LOCK:
        if _LIB is not None:
            return _LIB
        lib = _open()
        u8 = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
        lib.dpc_jpeg_backend.argtypes = []
        lib.dpc_jpeg_backend.restype = ctypes.c_char_p
        lib.dpc_jpeg_init.argtypes = []
        lib.dpc_jpeg_init.restype = ctypes.c_int
        lib.dpc_jpeg_dims.argtypes = [
            ctypes.c_char_p, ctypes.c_int64,
            np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")]
        lib.dpc_jpeg_dims.restype = ctypes.c_int
        lib.dpc_jpeg_decode_resize.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, u8, ctypes.c_int32,
            ctypes.c_int32]
        lib.dpc_jpeg_decode_resize.restype = ctypes.c_int
        lib.dpc_jpeg_decode_batch.argtypes = [
            ctypes.POINTER(ctypes.c_char_p),
            np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
            ctypes.c_int, u8, ctypes.c_int32, ctypes.c_int32, ctypes.c_int]
        lib.dpc_jpeg_decode_batch.restype = ctypes.c_int
        lib.dpc_jpeg_encode.argtypes = [
            u8, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, u8,
            ctypes.c_int64]
        lib.dpc_jpeg_encode.restype = ctypes.c_int64
        status = lib.dpc_jpeg_init()
        if status != 0:
            raise RuntimeError(
                f"the {lib.dpc_jpeg_backend().decode()} JPEG codec failed "
                f"to initialise (status {status})")
        _LIB = lib
        return lib


def backend() -> str:
    """'libjpeg' or 'nvjpeg': the library this machine built."""
    return _load().dpc_jpeg_backend().decode()


def jpeg_dims(data: bytes) -> tuple[int, int]:
    """(height, width) from the JPEG header alone."""
    dims = np.zeros(2, np.int32)
    if _load().dpc_jpeg_dims(data, len(data), dims) != 0:
        raise ValueError("corrupt JPEG header")
    return int(dims[0]), int(dims[1])


def decode_jpeg(data: bytes, target_hw: Optional[tuple[int, int]] = None
                ) -> np.ndarray:
    """Decode (and optionally resize) one JPEG buffer to RGB uint8."""
    th, tw = jpeg_dims(data) if target_hw is None else target_hw
    out = np.empty((th, tw, 3), np.uint8)
    if _load().dpc_jpeg_decode_resize(
            data, len(data), out, -1 if target_hw is None else th,
            -1 if target_hw is None else tw) != 0:
        raise ValueError("corrupt JPEG")
    return out


def decode_file(path: str, target_hw: Optional[tuple[int, int]] = None
                ) -> np.ndarray:
    with open(path, "rb") as f:
        return decode_jpeg(f.read(), target_hw)


def decode_jpeg_batch(buffers: Sequence[bytes], th: int, tw: int,
                      threads: int = 4) -> tuple[np.ndarray, int]:
    """Decode N JPEGs into one ``[N, th, tw, 3]`` array with a pthread
    pool, the interpreter lock released; returns (array, #failures), the
    failed frames zeroed."""
    lib = _load()
    n = len(buffers)
    arr = (ctypes.c_char_p * n)(*buffers)
    lens = np.asarray([len(b) for b in buffers], np.int64)
    out = np.empty((n, th, tw, 3), np.uint8)
    failures = lib.dpc_jpeg_decode_batch(arr, lens, n, out, th, tw, threads)
    return out, int(failures)


def encode_jpeg(image: np.ndarray, quality: int = 90) -> bytes:
    """RGB uint8 ``[H, W, 3]`` → a baseline 4:2:0 JPEG."""
    if image.dtype != np.uint8 or image.ndim != 3 or image.shape[2] != 3:
        raise ValueError(f"expected uint8 [H, W, 3], got {image.dtype} "
                         f"{image.shape}")
    if not 1 <= quality <= 100:
        raise ValueError(f"quality {quality} outside [1, 100]")
    image = np.ascontiguousarray(image)
    h, w = image.shape[:2]
    out = np.empty(2 * h * w * 3 + 65536, np.uint8)
    n = _load().dpc_jpeg_encode(image, h, w, quality, out, out.size)
    if n <= 0:
        raise ValueError("JPEG encode failed")
    return out[:n].tobytes()


def encode_file(path: str, image: np.ndarray, quality: int = 90) -> None:
    with open(path, "wb") as f:
        f.write(encode_jpeg(image, quality))
