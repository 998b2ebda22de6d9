"""Build and bind the hand-written CUDA kernels in ``repro_torch/csrc``.

The sources compile with ``nvcc`` for ``sm_90a`` into one shared library
with a plain C interface, bound through ``ctypes`` (no PyTorch headers, so
a build takes seconds): one ``nvcc -c`` per source, all started together,
then one link. The library is built at first use into ``build/kernels/``
at the repository root, named by a hash of the sources, and reused while
the sources are unchanged. A build or launch failure raises; nothing
falls back to the plain versions.

Every wrapper counts its launches in ``LAUNCHES`` (one per kernel launch,
nowhere else), so a run can show that its path went through the kernels.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("interval_stab.cu", "frontier.cu", "merge_cover.cu",
           "retrieval_score.cu", "batched_mp.cu", "flash_attention.cu",
           "flash_fwd_wgmma.cu", "flash_attention_bwd.cu",
           "flash_bwd_wgmma.cu")
HEADERS = ("verdict.cuh", "flash_tiles.cuh", "flash_mma.cuh",
           "flash_bwd_args.cuh")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I32 = ctypes.c_int
_I64 = ctypes.c_int64
SIGNATURES = {
    # C entry point: pointers, then sizes, then the stream
    "reach_stab_packed": [_P] * 5 + [_I64, _I32, _P],
    "reach_stab_naive": [_P] * 11 + [_I64, _I32, _I32, _P],
    "reach_probe": [_P] * 6 + [_I64, _I64, _I32, _P],
    "reach_classify_emit": [_P] * 7 + [_I64, _I32, _P],
    "reach_merge_cover": [_P] * 7 + [_I64, _I32, _I32, _I32, _P],
    "reach_retrieval_score": [_P] * 3 + [_I64, _I32, _I32, _I32, _P],
    "reach_batched_mp": [_P] * 4 + [_I64] + [_I32] * 6 + [_P],
    "reach_flash_fwd": [_P] * 5 + [_I32] * 8 + [_I64, _P],
    "reach_flash_bwd_dq": [_P] * 7 + [_I32] * 8 + [_I64, _P],
    "reach_flash_bwd_dkv": [_P] * 8 + [_I32] * 8 + [_I64, _P],
    # not launches: the shared memory a block may opt in to on a device,
    # and the shared memory one flash block takes at a head dim (forward,
    # float32 or bfloat16; backward dq or dk/dv, float32 or bfloat16)
    "reach_max_smem": [_I32],
    "reach_flash_smem": [_I32, _I32],
    "reach_flash_bwd_smem": [_I32, _I32, _I32],
}


class Counters(dict):
    """Named integer counters with a ``reset()``."""

    def reset(self) -> None:
        for key in self:
            self[key] = 0


LAUNCHES = Counters(stab_packed=0, stab_naive=0, probe=0, classify_emit=0,
                    merge_cover=0, retrieval_score=0, batched_mp=0,
                    flash_fwd=0, flash_bwd_dq=0, flash_bwd_dkv=0)


class _Library:
    def __init__(self):
        self._lib = None
        self.path = None
        self.build_seconds = None     # None: loaded from an earlier build
        self.build_log = ""

    def _nvcc(self) -> str:
        found = shutil.which("nvcc")
        if found:
            return found
        fallback = Path("/usr/local/cuda/bin/nvcc")
        if fallback.exists():
            return str(fallback)
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit to build")

    def _build(self) -> Path:
        digest = hashlib.sha1()
        for name in SOURCES + HEADERS:
            digest.update((CSRC / name).read_bytes())
        digest.update(" ".join(NVCC_FLAGS).encode())
        out = BUILD_DIR / f"libreach_{digest.hexdigest()[:16]}.so"
        if out.exists():
            return out
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tag = f"{digest.hexdigest()[:16]}.{os.getpid()}"
        nvcc = self._nvcc()
        t0 = time.perf_counter()
        objs, procs = [], []
        for name in SOURCES:
            obj = BUILD_DIR / f"{Path(name).stem}.{tag}.o"
            cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(CSRC / name)]
            objs.append(obj)
            procs.append((cmd, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        logs, failed = [], []
        for cmd, proc in procs:
            log = proc.communicate()[0]
            logs.append(log)
            if proc.returncode != 0:
                failed.append(f"{' '.join(cmd)}\n{log}")
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        if not failed:
            cmd = [nvcc, *NVCC_FLAGS[:2], "-shared", "-o", str(tmp),
                   *map(str, objs)]
            r = subprocess.run(cmd, capture_output=True, text=True)
            logs.append(r.stdout + r.stderr)
            if r.returncode != 0:
                failed.append(f"{' '.join(cmd)}\n{r.stdout}{r.stderr}")
        for obj in objs:
            obj.unlink(missing_ok=True)
        self.build_seconds = time.perf_counter() - t0
        self.build_log = "".join(logs)
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        tmp.replace(out)
        return out

    def get(self):
        if self._lib is None:
            self.path = self._build()
            lib = ctypes.CDLL(str(self.path))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            self._lib = lib
        return self._lib


LIBRARY = _Library()


def launch(counter: str, fn_name: str, device, *args) -> None:
    """Launch one kernel on PyTorch's current stream of ``device``, raise
    if the launch was refused, and count it. Pointers are passed as ints."""
    import torch
    lib = LIBRARY.get()
    stream = torch.cuda.current_stream(device).cuda_stream
    err = getattr(lib, fn_name)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{fn_name} launch failed: CUDA error {err}")
    LAUNCHES[counter] += 1


_MAX_SMEM: dict = {}


def max_smem(device) -> int:
    """The shared memory, in bytes, that one block may opt in to on
    ``device`` (232,448 on an H100)."""
    import torch
    index = torch.device(device).index
    if index not in _MAX_SMEM:
        _MAX_SMEM[index] = LIBRARY.get().reach_max_smem(
            torch.cuda.current_device() if index is None else index)
        if _MAX_SMEM[index] <= 0:
            raise RuntimeError(f"cannot read the shared-memory limit of "
                               f"{device}")
    return _MAX_SMEM[index]


def check(t, name: str, shape=None, device=None, align: int = 4,
          dtype: str = "int32"):
    """Validate one CUDA operand of ``dtype`` (int32 unless named);
    returns its data pointer."""
    import torch
    if t.dtype != getattr(torch, dtype):
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if device is not None and t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if t.data_ptr() % align:
        raise ValueError(f"{name}: must be {align}-byte aligned")
    return t.data_ptr()
