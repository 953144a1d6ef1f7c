"""Build and bind the port's CUDA kernels: nvcc, ctypes.

Every `csrc/*.cu` is compiled to an object by its own nvcc process, all
started together, and the objects are linked into one shared library
with a plain C interface,

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
         -Xcompiler -fPIC -Xptxas -v -c csrc/<name>.cu -o <name>.o  (each)
    nvcc -gencode arch=compute_90a,code=sm_90a -shared \
         -o build/yt8m_tpu_torch/<hash>/libyt8m_kernels.so *.o

at first use, keyed on a hash of the sources (headers included) and
flags, under the checkout's `build/` directory. No PyTorch headers are
compiled, so the build takes seconds. Each C entry point launches on the stream it is
given, allocates nothing and returns `cudaGetLastError()`; the Python
wrappers allocate outputs with `torch.empty` and raise on a non-zero
return. Nothing here runs at import time: the CPU tests import every
module without nvcc.
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

CSRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "yt8m_tpu_torch"
LIB_NAME = "libyt8m_kernels.so"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (
    *ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
NVCC_TIMEOUT_S = 600

_P = ctypes.c_void_p
_I = ctypes.c_int
# C entry point -> argtypes. Every pointer and the stream are c_void_p
# (a bare Python int would be cut to 32 bits).
SIGNATURES = {
    "yt8m_dbof_cluster_maxpool_u8": [_P] * 8 + [_I] * 4 + [_P],
    "yt8m_dbof_cluster_maxpool_f32": [_P] * 8 + [_I] * 4 + [_P],
    "yt8m_moe_head_serving": [_P] * 5 + [_I] * 4 + [_P],
    "yt8m_exact_topk": [_P] * 3 + [_I] * 3 + [_P],
    "yt8m_netvlad_aggregate_u8": [_P] * 11 + [_I] * 4 + [_P],
    "yt8m_netvlad_aggregate_f32": [_P] * 11 + [_I] * 4 + [_P],
    "yt8m_lstm_recurrence": [_P] * 8 + [_I] * 4 + [_P],
    "yt8m_lstm_train_forward": [_P] * 10 + [_I] * 4 + [_P],
    "yt8m_lstm_train_backward": [_P] * 8 + [_I] * 4 + [_P],
    "yt8m_netvlad_core_forward": [_P] * 6 + [_I] * 4 + [_P],
    "yt8m_netvlad_core_backward": [_P] * 8 + [_I] * 5 + [_P],
}


def find_nvcc() -> str:
    """nvcc from $CUDA_HOME, then PATH, then /usr/local/cuda."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    which = shutil.which("nvcc")
    if which:
        cands.append(which)
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise FileNotFoundError(
        "nvcc not found ($CUDA_HOME/bin, PATH, /usr/local/cuda/bin)"
    )


def sources():
    return sorted(CSRC_DIR.glob("*.cu"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC_DIR.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_ROOT / source_hash() / LIB_NAME


class BuildResult:
    def __init__(self, path: Path, seconds: float, log: str, built: bool):
        self.path = path
        self.seconds = seconds
        self.log = log
        self.built = built


def build() -> BuildResult:
    """Compile the library unless this hash is already built: one nvcc
    process per source, all running at once, then one link."""
    lib = library_path()
    log_path = lib.with_name("nvcc.log")
    if lib.exists():
        log = log_path.read_text() if log_path.exists() else ""
        return BuildResult(lib, 0.0, log, built=False)
    lib.parent.mkdir(parents=True, exist_ok=True)
    nvcc = find_nvcc()
    tag = f"{os.getpid()}.tmp"
    t0 = time.perf_counter()
    procs = []
    for src in sources():
        obj = lib.with_name(f".{src.stem}.{tag}.o")
        cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
        procs.append((cmd, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    logs, failed = [], []
    try:
        for cmd, _, proc in procs:
            out, _ = proc.communicate(timeout=NVCC_TIMEOUT_S)
            logs.append(f"$ {' '.join(cmd)}\n{out}")
            if proc.returncode != 0:
                failed.append(proc.returncode)
    finally:
        for _, _, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    tmp = lib.with_name(f".{LIB_NAME}.{tag}")
    try:
        if not failed:
            cmd = [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp),
                   *(str(obj) for _, obj, _ in procs)]
            proc = subprocess.run(cmd, capture_output=True, text=True,
                                  timeout=NVCC_TIMEOUT_S)
            logs.append(f"$ {' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
            if proc.returncode != 0:
                failed.append(proc.returncode)
    finally:
        for _, obj, _ in procs:
            obj.unlink(missing_ok=True)
    seconds = time.perf_counter() - t0
    log = "\n".join(logs)
    if failed:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed (exit codes {failed}):\n{log}")
    log_path.write_text(log)
    os.replace(tmp, lib)
    return BuildResult(lib, seconds, log, built=True)


_lock = threading.Lock()
_lib = None


def library() -> ctypes.CDLL:
    """The kernel library, built and loaded on first call."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build().path))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.yt8m_cuda_error_string.argtypes = [ctypes.c_int]
            lib.yt8m_cuda_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def check_launch(name: str, code: int) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if code != 0:
        msg = library().yt8m_cuda_error_string(code).decode()
        raise RuntimeError(f"{name}: CUDA error {code} ({msg})")


def current_stream(device) -> ctypes.c_void_p:
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())
