"""Build, load and count the hand-written CUDA kernels.

The kernels live in ``repro_torch/csrc/*.cu`` behind a plain C interface.
At first use every source is compiled with ``nvcc`` for ``sm_90a``, one
``nvcc -c`` per source, all started together, and the objects are linked
into one shared library under ``csrc/_build/`` (keyed by a hash of all the
sources and flags, so an edited source rebuilds) and bound with
``ctypes``: a build of seconds, where a PyTorch C++ extension takes
minutes.  Nothing is compiled or loaded at import, so the CPU tests import
every module without ``nvcc``.

``LAUNCHES`` counts kernel launches by name; each wrapper adds one where it
launches its kernel, and nowhere else.  ``kan_pipeline_layer.noise``
counts the B1 launches among ``kan_pipeline_layer``'s that carried the
partial-sum noise operand (the acim backend), ``kan_pipeline_layer.regs``
those that ran B1's register loop (``pipeline.b1_loop``).
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

from ..obs.metrics import setup_phase

__all__ = [
    "FILL_BLOCKS",
    "LAUNCHES",
    "launch_counts",
    "reset_launch_counts",
    "build",
    "sources",
    "library",
    "check",
    "check_spec",
    "ptr",
    "stream_args",
]

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = CSRC / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

LAUNCHES: collections.Counter = collections.Counter()

# blocks that fill the card: two resident blocks on each of the H100's 132
# SMs.  The kernels that split a reduction axis over blocks (B1's features,
# B2's keys) split until a call has about this many.
FILL_BLOCKS = 2 * 132

_LOCK = threading.Lock()
_LIB = None
_BUILD_INFO: dict = {}

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    # codes xraw lut lutp wc wcp wscale wb noise y codes_out ws
    # B F O f_log o_log nb kk ld splits fps row_tile loop | lo code_step
    # lut_scale hs mid nx_lo nx_scale | nx_num_codes device stream
    "kan_pipeline_layer": [_P] * 12 + [_I] * 12 + [_F] * 7 + [_I, _I, _P],
    # codes lut wc wb y ws | B F O nb kk ld splits fps | lo code_step |
    # device stream
    "kan_spline_fwd": [_P] * 6 + [_I] * 8 + [_F] * 2 + [_I, _P],
    # q k v qpos kpos out ws_o ws_ml | B S T Hkv G D bf16 kind window
    # splits | softcap scale | device stream
    "flash_attention_fwd": [_P] * 8 + [_I] * 10 + [_F] * 2 + [_I, _P],
    # x w load fs out ws | B Rt R C tile_rows chunks | ir_scale comp_scale
    # | adc_bits | device stream
    "cim_mac_fwd": [_P] * 6 + [_I] * 6 + [_F] * 2 + [_I, _I, _P],
}


def launch_counts() -> dict:
    """Snapshot of kernel launches by name since start or the last reset."""
    return dict(LAUNCHES)


def reset_launch_counts() -> None:
    LAUNCHES.clear()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def sources() -> list:
    """Every kernel source of the library, in a fixed order."""
    return sorted(CSRC.glob("*.cu"))


def build() -> dict:
    """Compile the kernel library if its hashed artifact is missing.

    Returns ``{"path", "seconds", "ptxas", "cached", "sources"}``;
    ``ptxas`` is the ``-Xptxas -v`` register / shared-memory report of the
    build.  The library is written under a temporary name and renamed into
    place, so concurrent first uses never load a half-written file.
    """
    with _LOCK:
        if _BUILD_INFO:
            return dict(_BUILD_INFO)
        srcs = sources()
        h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
        for src in srcs:
            h.update(src.name.encode() + b"\0" + src.read_bytes())
        lib_path = BUILD_DIR / f"kernels-{h.hexdigest()[:16]}.so"
        log_path = lib_path.with_suffix(".log")
        t0 = time.perf_counter()
        cached = lib_path.exists() and log_path.exists()
        if not cached:
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tag = f"{lib_path.stem}.{os.getpid()}"
            objs = [BUILD_DIR / f"{src.stem}.{tag}.o" for src in srcs]
            procs = [
                subprocess.Popen(
                    [_nvcc(), *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
                    stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                )
                for src, obj in zip(srcs, objs)
            ]
            logs, failed = [], []
            for src, proc in zip(srcs, procs):
                out, err = proc.communicate()
                logs.append(err + out)
                if proc.returncode != 0:
                    failed.append(f"{src.name} ({proc.returncode}):\n{err}")
            if failed:
                raise RuntimeError("nvcc failed: " + "\n".join(failed))
            tmp = lib_path.with_name(f"{tag}.so.tmp")
            proc = subprocess.run(
                [_nvcc(), "-shared", "-o", str(tmp), *map(str, objs)],
                capture_output=True, text=True,
            )
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc link failed ({proc.returncode}):\n{proc.stderr}")
            for obj in objs:
                obj.unlink()
            log_path.write_text("".join(logs))
            os.replace(tmp, lib_path)
        _BUILD_INFO.update(
            path=str(lib_path),
            seconds=time.perf_counter() - t0,
            ptxas=log_path.read_text(),
            cached=cached,
            sources=[str(src.relative_to(CSRC.parents[2])) for src in srcs],
        )
        return dict(_BUILD_INFO)


def library() -> ctypes.CDLL:
    """The loaded kernel library with every entry point's argtypes set.
    The first call's build (or cache check) and load count as
    ``setup.seconds{phase=kernel_build}``."""
    global _LIB
    if _LIB is None:
        with setup_phase("kernel_build"):
            info = build()
            lib = ctypes.CDLL(info["path"])
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.kan_error_string.argtypes = [ctypes.c_int]
        lib.kan_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def check_spec(spec) -> None:
    """Raise for a quantization spec the kernel library was not built for:
    an order outside 1..5 (the K+1 = 2..6 template instances, each held
    against its plain version on the card) or an SH-LUT over 48 KB of
    shared memory."""
    if not 1 <= spec.order <= 5:
        raise ValueError(f"kernel supports orders 1..5, got {spec.order}")
    if spec.codes_per_interval * (spec.order + 1) * 4 > 48 * 1024:
        raise ValueError(f"SH-LUT of LD={spec.ld} exceeds shared memory")


def check(status: int) -> None:
    """Raise if a launch returned a CUDA error (cudaGetLastError != 0)."""
    if status != 0:
        msg = library().kan_error_string(status).decode()
        raise RuntimeError(f"CUDA kernel launch failed: {msg} ({status})")


def ptr(t: torch.Tensor | None):
    """Device pointer of a tensor, or NULL for an absent operand."""
    return None if t is None else t.data_ptr()


def stream_args(device: torch.device) -> tuple:
    """(device index, current stream handle) for a launch on ``device``."""
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    return index, torch.cuda.current_stream(index).cuda_stream
