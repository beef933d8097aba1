"""First-use build of the CUDA kernels in ``kernels/csrc``.

Each ``csrc/*.cu`` file is compiled by its own ``nvcc`` for Hopper
(``-gencode arch=compute_90a,code=sm_90a``), all started together, and the
objects are linked into ONE shared library with a plain C interface,
loaded with ``ctypes``. The library lives in
``kernels/build/<hash>/`` where the hash covers the sources and the
compiler flags, so an edited source rebuilds and an unchanged one is reused
within a checkout. The build is written under a temporary name and renamed
into place, so concurrent first users do not see a half-written file.

A build failure raises ``KernelBuildError`` with the compiler's output.

``python -m segmif_tpu_torch.kernels._build`` builds the library with
``-Xptxas -v`` and prints the compiler's per-kernel register, shared
memory and spill report.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Callable, List, Optional, Sequence

import torch

from ..utils.profiler import span

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parent / "build"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ARCH_FLAGS + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                           "-lineinfo"]
LIB_NAME = "libsegmif_kernels.so"

_vp = ctypes.c_void_p
_i32 = ctypes.c_int
_i64 = ctypes.c_int64
_f32 = ctypes.c_float

# C entry points: name -> argtypes (every pointer and the stream are
# c_void_p; every C function returns cudaGetLastError() as an int)
SIGNATURES = {
    "segmif_sr_attention": [_vp, _vp, _vp, _vp,            # q k v out
                            _i32, _i32, _i32, _i32, _i32,  # B N M H D
                            _i64, _i64, _i64,              # q strides b n h
                            _i64, _i64, _i64,              # k strides
                            _i64, _i64, _i64,              # v strides
                            _f32, _i32, _vp],              # scale dtype stream
    "segmif_sr_attention_bwd_dq": [_vp, _vp, _vp, _vp,     # q k v dO
                                   _vp, _vp, _vp,          # dq lse2 delta
                                   _i32, _i32, _i32, _i32,  # B N M H
                                   _i32,                   # D
                                   _i64, _i64, _i64,       # q strides b n h
                                   _i64, _i64, _i64,       # k strides
                                   _i64, _i64, _i64,       # v strides
                                   _i64, _i64, _i64,       # dO strides
                                   _f32, _vp],             # scale stream
    "segmif_sr_attention_bwd_dkv": [_vp, _vp, _vp, _vp,    # q k v dO
                                    _vp, _vp, _vp,         # lse2 delta
                                                           # partial
                                    _vp, _vp,              # dk dv
                                    _i32, _i32, _i32, _i32,  # B N M H
                                    _i32, _i32, _i32,      # D chunk nchunk
                                    _i64, _i64, _i64,      # q strides b n h
                                    _i64, _i64, _i64,      # k strides
                                    _i64, _i64, _i64,      # v strides
                                    _i64, _i64, _i64,      # dO strides
                                    _f32, _vp],            # scale stream
    "segmif_ffm_grams": [_vp, _vp, _vp, _vp, _vp,          # x1 x2 s w b
                         _vp, _vp,                         # partial out
                         _i32, _i32, _i32, _i32,           # B N chunk nchunk
                         _i32, _vp],                       # dtype stream
    "segmif_ffm_apply": [_vp, _vp, _vp, _vp, _vp,          # x1 x2 s w b
                         _vp, _vp, _vp,                    # mats be lnp
                         _vp, _vp,                         # o1 o2
                         _i32, _i32, _i32,                 # B N chunk
                         _i32, _vp],                       # dtype stream
    "segmif_ffm_bwd_reduce": [_vp, _vp, _vp, _vp, _vp,     # x1 x2 s g1 g2
                              _vp, _vp, _vp, _vp, _vp,     # wp bp mats be lnp
                              _vp, _vp,                    # partial out
                              _i32, _i32, _i32, _i32,      # B N chunk nchunk
                              _i32, _vp],                  # dtype stream
    "segmif_ffm_bwd_rows": [_vp, _vp, _vp, _vp, _vp,       # x1 x2 s g1 g2
                            _vp, _vp, _vp, _vp, _vp, _vp,  # wp bp mats sym
                                                           # be lnp
                            _vp, _vp, _vp,                 # dx1 dx2 ds
                            _vp, _vp,                      # partial out
                            _i32, _i32, _i32, _i32,        # B N chunk nchunk
                            _i32, _vp],                    # dtype stream
    "segmif_drdb_growth": [_vp, _i64, _vp, _vp, _vp,       # x x_ps rs w b
                           _i32, _i32, _i32,               # B H W
                           _i32, _vp],                     # dtype stream
    "segmif_drdb_tail": [_vp, _i64,                        # x x_ps
                         _vp, _vp, _vp, _vp, _vp, _i64,    # r1..r5 r_ps
                         _vp, _vp, _vp, _i64,              # wb bb out npix
                         _i32, _vp],                       # dtype stream
    "segmif_drdb_int8_growth": [_vp, _i64, _vp,            # x x_ps feat
                                _vp, _vp, _vp,             # w svk bias
                                _vp, _vp,                  # s_in invs
                                _i32, _i32, _i32,          # B H W
                                _i32, _vp],                # dtype stream
    "segmif_drdb_int8_tail": [_vp, _i64, _vp,              # x x_ps feat
                              _vp, _vp, _vp, _vp, _i64,    # wb svb bb out npix
                              _i32, _vp],                  # dtype stream
}

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


class KernelBuildError(RuntimeError):
    """nvcc is missing or refused the sources."""


_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def nvcc_path() -> Optional[str]:
    """nvcc from CUDA_HOME, /usr/local/cuda or PATH; None if absent."""
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    return shutil.which("nvcc")


def sources() -> List[Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest(extra: List[str]) -> str:
    h = hashlib.sha256()
    for p in sources() + sorted(CSRC.glob("*.cuh")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS + extra).encode())
    return h.hexdigest()[:16]


def compile_library(extra_flags: Optional[List[str]] = None) -> tuple:
    """Compile csrc/*.cu into the hashed build directory (if not built).

    Returns (library path, compiler output). Raises KernelBuildError."""
    extra = list(extra_flags or [])
    nvcc = nvcc_path()
    if nvcc is None:
        raise KernelBuildError(
            "nvcc not found (set CUDA_HOME or put nvcc on PATH)")
    out_dir = BUILD_ROOT / _digest(extra)
    lib_path = out_dir / LIB_NAME
    if lib_path.exists():
        return lib_path, ""
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = []
    for src in sources():   # nvcc reads the file type from the suffix
        obj = out_dir / f"{src.stem}.{os.getpid()}.o"
        cmd = [nvcc] + NVCC_FLAGS + extra + ["-c", "-o", str(obj), str(src)]
        procs.append((cmd, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    log, failed = "", False
    for cmd, _, proc in procs:
        out, _ = proc.communicate()
        log += " ".join(cmd) + "\n" + out
        failed |= proc.returncode != 0
    if not failed:
        tmp = out_dir / f"{LIB_NAME}.{os.getpid()}.tmp"
        cmd = [nvcc] + ARCH_FLAGS + ["-shared", "-o", str(tmp)] + \
            [str(obj) for _, obj, _ in procs]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        log += " ".join(cmd) + "\n" + proc.stdout + proc.stderr
        failed = proc.returncode != 0
    for _, obj, _ in procs:
        obj.unlink(missing_ok=True)
    (out_dir / "build.log").write_text(log)
    if failed:
        raise KernelBuildError(f"nvcc failed:\n{log}")
    os.replace(tmp, lib_path)
    return lib_path, log


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call (under the span
    ``kernels/library``, which times the build)."""
    global _lib
    with _lock:
        if _lib is None:
            with span("kernels/library"):
                path, _ = compile_library()
                lib = ctypes.CDLL(str(path))
                for name, argtypes in SIGNATURES.items():
                    fn = getattr(lib, name)
                    fn.argtypes = argtypes
                    fn.restype = ctypes.c_int
                lib.segmif_error_string.argtypes = [ctypes.c_int]
                lib.segmif_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def refuse_grad(*ts: torch.Tensor, instead: Optional[str] = None) -> None:
    """Raise if autograd would need a gradient through a forward-only
    kernel wrapper. ``instead``: the function whose autograd.Function
    carries the gradient."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in ts):
        hint = (f"call {instead}, whose autograd.Function carries the "
                "gradient" if instead else
                "call it under torch.inference_mode() or torch.no_grad()")
        raise RuntimeError(f"this CUDA kernel wrapper is forward-only; "
                           f"{hint}")


def needs_grad(*ts: torch.Tensor) -> bool:
    """Whether autograd records a graph through any of ``ts``."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


def acc_dtype(dtype: torch.dtype) -> torch.dtype:
    """The plain versions' arithmetic type: f32 for f32 and bf16 inputs
    (as the kernels accumulate), f64 for f64 (so that gradcheck can read
    their gradients)."""
    return torch.float64 if dtype == torch.float64 else torch.float32


def tf32_big(w: torch.Tensor) -> torch.Tensor:
    """``w`` rounded to TF32 (10 mantissa bits; nearest, ties away from
    zero) as the f32 kernels split their operands (``csrc/common.cuh``,
    ``tf32_big``: the f32 bits plus 0x1000, the low 13 bits cleared), in
    ``w``'s dtype. ``w - tf32_big(w)`` is exact, so the two halves sum to
    ``w`` again."""
    bits = w.float().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32).to(w.dtype)


def plain_vjp(name: str, plain: Callable, saved: Sequence[torch.Tensor],
              needs: Sequence[bool], cotangents) -> tuple:
    """The backward of a kernel's autograd.Function, under the span
    ``name``: the gradients of ``plain(*saved)`` (the kernel's plain
    PyTorch version) against the output cotangents, recomputed here with
    autocast off, for the saved inputs whose ``needs`` flag is set (None
    for the others). The JAX package's custom_vjp backwards recompute
    through XLA the same way; no kernel runs here."""
    with span(name):
        ins = [t.detach().requires_grad_(bool(n))
               for t, n in zip(saved, needs)]
        with torch.enable_grad(), torch.autocast(saved[0].device.type,
                                                 enabled=False):
            out = plain(*ins)
        outs = (out,) if torch.is_tensor(out) else tuple(out)
        wanted = [t for t in ins if t.requires_grad]
        got = iter(torch.autograd.grad(outs, wanted, cotangents)
                   if wanted else ())
        return tuple(next(got) if t.requires_grad else None for t in ins)


def check(err: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if err != 0:
        msg = library().segmif_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg}) at launch")


if __name__ == "__main__":
    lib_path, report = compile_library(["-Xptxas", "-v"])
    print(f"built {lib_path}")
    print(report)
