"""Build and load the port's CUDA kernels.

``csrc/*.cu`` compile for Hopper (``sm_90a``) at first use: one ``nvcc``
per source, all started together, into objects that link into one shared
library with a plain C interface, loaded with ``ctypes``. The build lands
in ``kernels/build/`` (ignored by git) and is reused while it is newer
than every source. Nothing here runs at import time, and there is no
fallback: a failed build or a refused launch raises.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Optional

CSRC = Path(__file__).with_name("csrc")
BUILD_DIR = Path(__file__).with_name("build")
LIB_NAME = "libreconic_kernels.so"

ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
# -Xptxas -v reports registers, shared memory and spills per kernel into
# the build log. Never --use_fast_math: the quantizer's division, the
# matmul's f32 sums and the attention's expf must stay IEEE.
NVCC_FLAGS = [*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
#: C entry points and their argument types (each returns an int
#: cudaError_t code unless ``RESTYPES`` says otherwise).
SIGNATURES = {
    "reconic_systolic_mm": [_P, _P, _P, _I, _I, _I, _I, _I, _P],
    "reconic_parse_packets": [_P, _P, _I, _P],
    "reconic_parse_packet_fields": [_P, _P, _I, _P],
    "reconic_quantize": [_P, _I, _P, _P, _I, _I, ctypes.c_float, _P],
    "reconic_dequantize": [_P, _P, _P, _I, _I, _I, _P],
    "reconic_flash_attention": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                                _I, _I, _I, _I, ctypes.c_float, _I, _P],
    "reconic_flash_attention_sm90": [_P, _P, _P, _P, _I, _I, _I, _I, _I,
                                     _I, _I, _I, _I, _I, ctypes.c_float,
                                     _P],
    "reconic_flash_attention_sm90_tf32": [_P, _P, _P, _P, _P, _L, _I, _I,
                                          _I, _I, _I, _I, _I, _I, _I, _I,
                                          ctypes.c_float, _P],
    "reconic_flash_attention_sm90_tf32_scratch_words": [_I, _I, _I, _I, _I],
    "reconic_flash_attention_splitkv": [_P, _P, _P, _P, _P, _L, _I, _I, _I,
                                        _I, _I, _I, _I, _I, _I, _I,
                                        ctypes.c_float, _I, _I, _I, _P],
    "reconic_flash_attention_splitkv_scratch_words": [_I, _I, _I, _I, _I],
    "reconic_flash_attention_splitkv_wave": [_I, _I, _I, _I],
    "reconic_ssd_scan": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _L, _I, _I, _I,
                         _I, _I, _I, _I, _P],
    "reconic_ssd_scan_work_floats": [_I, _I, _I, _I, _I, _I],
}
#: entry points that return something else than a cudaError_t code
RESTYPES = {"reconic_ssd_scan_work_floats": ctypes.c_longlong,
            "reconic_flash_attention_sm90_tf32_scratch_words":
                ctypes.c_longlong,
            "reconic_flash_attention_splitkv_scratch_words":
                ctypes.c_longlong}


@dataclass
class BuildResult:
    path: Path
    seconds: float      # 0.0 when an up-to-date library was reused
    log: str            # nvcc's output (ptxas register/spill report)


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (nvcc); the kernels "
                           "cannot be built")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def _run(procs) -> str:
    log = []
    for name, proc in procs:
        out, _ = proc.communicate()
        log.append(f"== {name}\n{out}")
        if proc.returncode != 0:
            for _, other in procs:
                if other.poll() is None:
                    other.kill()
                    other.wait()
            raise RuntimeError(f"nvcc failed on {name} "
                               f"(exit {proc.returncode}):\n{out}")
    return "".join(log)


def build(force: bool = False) -> BuildResult:
    """Compile ``csrc/*.cu`` into ``build/libreconic_kernels.so`` unless an
    up-to-date library is already there."""
    sources = sorted(CSRC.glob("*.cu"))
    inputs = sources + sorted(CSRC.glob("*.cuh"))
    lib = BUILD_DIR / LIB_NAME
    newest = max(p.stat().st_mtime for p in inputs)
    if not force and lib.exists() and lib.stat().st_mtime >= newest:
        return BuildResult(lib, 0.0, "")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    objs = [BUILD_DIR / (src.stem + ".o") for src in sources]
    log = _run([(src.name, subprocess.Popen(
        [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        for src, obj in zip(sources, objs)])
    tmp = BUILD_DIR / (LIB_NAME + f".{os.getpid()}.tmp")
    log += _run([("link", subprocess.Popen(
        [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))])
    os.replace(tmp, lib)
    return BuildResult(lib, time.perf_counter() - t0, log)


_lib: Optional[ctypes.CDLL] = None


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build().path))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = RESTYPES.get(name, ctypes.c_int)
        lib.reconic_error_string.argtypes = [ctypes.c_int]
        lib.reconic_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def launch(name: str, *args) -> None:
    """Call one C entry point on the current stream's arguments and raise
    if the launch was refused (the code is ``cudaGetLastError()``)."""
    lib = library()
    code = getattr(lib, name)(*args)
    if code != 0:
        msg = lib.reconic_error_string(code).decode()
        raise RuntimeError(f"{name}: CUDA error {code}: {msg}")


def check_cuda(name: str, *tensors) -> None:
    """Raise unless every tensor is contiguous on one CUDA device (what
    the kernels take)."""
    dev = tensors[0].device
    for t in tensors:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"{name}: tensors must share one CUDA device, "
                             f"got {[str(u.device) for u in tensors]}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")


def stream_ptr(device) -> int:
    """The raw ``cudaStream_t`` of PyTorch's current stream on ``device``."""
    import torch
    return torch.cuda.current_stream(device).cuda_stream
