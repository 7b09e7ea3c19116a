"""Build the port's CUDA kernels at first use.

Counterpart: none in ``paddle_tpu`` (Pallas kernels compile through
XLA). Every ``csrc/*.cu`` source is compiled by ``nvcc`` for Hopper
(``sm_90a``) into a shared library with a plain C interface under
``build/paddle_tpu_torch/`` at the repository root, and loaded with
``ctypes``. Only sources in the repository are built. The library name
carries a digest of the source, the shared headers (``csrc/*.cuh``) and
the flags, so an edited source or header is rebuilt. A missing ``nvcc``
or a failed build raises; nothing falls back. ``library`` and ``call``
are the one ctypes path every kernel module launches through; ``call``
raises TypeError for a dtype the kernels do not take (float32 and
bfloat16), and ``kernel_dtypes`` is the functionals' routing rule for
it.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, List, Sequence

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "paddle_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

KERNEL_DTYPES = (torch.float32, torch.bfloat16)

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
build_log: Dict[str, str] = {}   # source name → nvcc's output (ptxas -v)


def sources() -> List[str]:
    return sorted(p.name for p in CSRC.glob("*.cu"))


def _nvcc() -> str:
    """nvcc from PATH, else $CUDA_HOME/bin, else /usr/local/cuda/bin."""
    found = shutil.which("nvcc")
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if found is None and home and os.path.exists(f"{home}/bin/nvcc"):
            found = f"{home}/bin/nvcc"
    if found is None:
        raise RuntimeError(
            "paddle_tpu_torch: nvcc not found (PATH, $CUDA_HOME/bin or "
            "/usr/local/cuda/bin); the CUDA kernels are built from "
            "kernels/csrc at first use")
    return found


def _target(name: str) -> Path:
    text = (CSRC / name).read_bytes() + b"".join(
        p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    flags = " ".join(NVCC_FLAGS).encode()
    digest = hashlib.sha256(text + flags).hexdigest()[:12]
    return BUILD_DIR / f"lib{Path(name).stem}-{digest}.so"


def build_all() -> Dict[str, Path]:
    """Compile every source not yet built, one ``nvcc`` per source, all
    started together. Returns source name → library path."""
    targets = {name: _target(name) for name in sources()}
    todo = {n: t for n, t in targets.items() if not t.exists()}
    if todo:
        nvcc = _nvcc()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        procs = {}
        for name, target in todo.items():
            tmp = target.with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / name)]
            procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT,
                                            text=True), tmp)
        failed = []
        for name, (proc, tmp) in procs.items():
            out, _ = proc.communicate()
            build_log[name] = out
            if proc.returncode != 0:
                failed.append(f"{name} (nvcc exit {proc.returncode}):\n{out}")
            else:
                os.replace(tmp, todo[name])
        if failed:
            raise RuntimeError("paddle_tpu_torch: kernel build failed: "
                               + "\n".join(failed))
    return targets


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>``, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build_all()[name]))
            _libs[name] = lib
        return lib


def library(name: str, argtypes: Dict[str, Sequence], ints: Iterable[str] = ()
            ) -> ctypes.CDLL:
    """``load(name)`` with each entry point's ctypes signature: for every
    key of ``argtypes``, its ``_f32`` and ``_bf16`` functions returning an
    int status; ``ints``: functions of no argument returning an int; and
    common.cuh's ``kernel_error_string`` and ``dropout_bits``."""
    lib = load(name)
    for fname, types in argtypes.items():
        for suffix in ("f32", "bf16"):
            fn = getattr(lib, f"{fname}_{suffix}")
            fn.argtypes = list(types)
            fn.restype = ctypes.c_int
    for fname in ints:
        getattr(lib, fname).restype = ctypes.c_int
    lib.kernel_error_string.argtypes = [ctypes.c_int]
    lib.kernel_error_string.restype = ctypes.c_char_p
    # common.cuh's debug entry: out, nb, nr, nc, s0, s1, rows, cols,
    # row_layout, stream
    lib.dropout_bits.argtypes = ([ctypes.c_void_p] + [ctypes.c_int] * 3
                                 + [ctypes.c_uint] * 2 + [ctypes.c_int] * 3
                                 + [ctypes.c_void_p])
    lib.dropout_bits.restype = ctypes.c_int
    return lib


def kernel_dtypes(*tensors) -> bool:
    """The routing rule of the functionals: every tensor (or dtype: what
    ``core.dispatch.amp_dtypes`` gives) in one dtype the kernels take
    (float32 or bfloat16)."""
    dts = [getattr(t, "dtype", t) for t in tensors]
    return dts[0] in KERNEL_DTYPES and all(d == dts[0] for d in dts)


def call(lib: ctypes.CDLL, name: str, dtype, device, *args) -> None:
    """Launch ``name``'s bf16 or f32 entry point (by ``dtype``) on the
    current stream of ``device``; any other dtype raises TypeError, a
    non-zero status RuntimeError with CUDA's error string."""
    if dtype not in KERNEL_DTYPES:
        raise TypeError(f"{name}: the kernels take float32 or bfloat16, "
                        f"got {dtype}")
    fn = getattr(lib, f"{name}_{'bf16' if dtype == torch.bfloat16 else 'f32'}")
    with torch.cuda.device(device):
        rc = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc} "
                           f"({lib.kernel_error_string(rc).decode()})")


def vec32(v):
    """A vector operand as the kernels take it: contiguous float32 (None
    stays None)."""
    return None if v is None else v.float().contiguous()
