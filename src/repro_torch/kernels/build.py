"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each source in repro_torch/csrc/ is compiled on its own into a shared
library with a plain C interface:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v -o <lib>.so <source>.cu

The libraries go to build/kernels/ under the repository root (listed in
.gitignore), named by a hash of the source text, the shared headers
(csrc/*.cuh) and the flags, so an edited source or header rebuilds and an
unchanged one loads the existing library.  Nothing is built when a module
is imported: the first wrapper call on a CUDA tensor builds its kernel,
and build_all() builds every kernel at once, one nvcc process per source,
all started together.  A failed build raises; no caller falls back to the
plain versions.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Tuple

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C signature of every kernel entry point: (library stem, symbol, argtypes)
SIGNATURES: Dict[str, Tuple[str, tuple]] = {
    # q, k_pages, v_pages, page_tables, q_offsets, true_lens, q_lens, out,
    # K, S, Hkv, G, D, page_size, n_max, window, scale, softcap, is_bf16,
    # stream
    "paged_prefill": ("paged_prefill_launch",
                      (_P,) * 8 + (_I,) * 8 + (_F, _F, _I, _P)),
    # q, k_pages, v_pages, block_table, cache_len, out, scratch, B, Hkv, G,
    # D, page_size, n_max, split, window, scale, softcap, is_bf16, stream
    "paged_decode": ("paged_decode_launch",
                     (_P,) * 7 + (_I,) * 8 + (_F, _F, _I, _P)),
    # q, k, v, o, lse, B, Sq, Skv, Hkv, G, D, causal, window, scale,
    # softcap, is_bf16, stream
    "flash_attention": ("flash_attention_launch",
                        (_P,) * 5 + (_I,) * 8 + (_F, _F, _I, _P)),
    # q, k_cache, v_cache, cache_len, out, scratch, B, S, Hkv, G, D, split,
    # window, scale, softcap, is_bf16, stream
    "dense_decode": ("dense_decode_launch",
                     (_P,) * 6 + (_I,) * 7 + (_F, _F, _I, _P)),
    # q, k, v, o, lse, do, dq, dk, dv, delta, B, Sq, Skv, Hkv, G, D, causal,
    # window, scale, softcap, is_bf16, stream
    "flash_backward": ("flash_backward_launch",
                       (_P,) * 10 + (_I,) * 8 + (_F, _F, _I, _P)),
    # x, dt, A, Bm, Cm, y, scratch, B, S, H, P, N, is_bf16, stream
    "mamba2_scan": ("mamba2_scan_launch", (_P,) * 7 + (_I,) * 6 + (_P,)),
    # r, k, v, w, u, y, scratch, B, S, H, K, V, is_bf16, stream
    "rwkv6_scan": ("rwkv6_scan_launch", (_P,) * 7 + (_I,) * 6 + (_P,)),
}

_loaded: Dict[str, ctypes._CFuncPtr] = {}


def nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found on PATH or in /usr/local/cuda/bin: "
                           "the CUDA kernels cannot be built")
    return path


def library_path(name: str, csrc: Path = CSRC) -> Path:
    """Where kernel `name`'s library lives: named by a hash of its source,
    every header of csrc (csrc/*.cuh, by name and text, in name order) and
    the flags, so an edited header rebuilds every library too."""
    h = hashlib.sha256((csrc / f"{name}.cu").read_bytes())
    for header in sorted(csrc.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _start(name: str):
    """Start nvcc for one source unless its library exists.  Returns
    (output path, temporary path, process or None)."""
    out = library_path(name)
    if out.exists():
        return out, None, None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    cmd = [nvcc(), *FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return out, tmp, proc


def _finish(name: str, out: Path, tmp: Path, proc) -> str:
    """Wait for one nvcc, move its library into place, return its log."""
    log, _ = proc.communicate()
    if proc.returncode != 0:
        if tmp.exists():
            tmp.unlink()
        raise RuntimeError(f"nvcc failed on csrc/{name}.cu "
                           f"(exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)          # atomic: concurrent builders never see half
    out.with_suffix(".log").write_text(log)
    return log


def build_all() -> Tuple[float, Dict[str, str]]:
    """Compile every kernel source, all nvcc processes started together.
    Returns (wall seconds, {name: compiler log}); a library that already
    exists is not rebuilt and reports its stored log."""
    t0 = time.perf_counter()
    started = {name: _start(name) for name in SIGNATURES}
    logs = {}
    for name, (out, tmp, proc) in started.items():
        if proc is None:
            log_file = out.with_suffix(".log")
            logs[name] = log_file.read_text() if log_file.exists() else ""
        else:
            logs[name] = _finish(name, out, tmp, proc)
    return time.perf_counter() - t0, logs


def kernel(name: str):
    """The ctypes entry point of kernel `name`, built on first use."""
    fn = _loaded.get(name)
    if fn is None:
        out, tmp, proc = _start(name)
        if proc is not None:
            _finish(name, out, tmp, proc)
        symbol, argtypes = SIGNATURES[name]
        fn = getattr(ctypes.CDLL(str(out)), symbol)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _loaded[name] = fn
    return fn


def check(name: str, err: int):
    """Raise if a launch returned a CUDA error."""
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError_t {err}")
