"""Builds the CUDA sources under ``csrc/`` with ``nvcc`` and loads them with ctypes.

One shared library per ``.cu`` file, each with a plain C interface, all compiled
together (one ``nvcc`` process per source, started at once) the first time any
kernel is needed. Libraries are keyed by a hash of every file under ``csrc/``,
so an edit rebuilds them. Nothing is built when the module is imported. The
build holds a file lock, so processes started together (the ranks of one run)
build once and the others load what it built.

Every launch goes through ``on_device``: the tensor's card is made the current
device for it, so on a host with several GPUs rank k's kernels, and the
per-device attributes their C entries set (``cudaFuncSetAttribute``'s dynamic
shared-memory size, set at every launch), land on card k.
"""
from __future__ import annotations

import contextlib
import ctypes
import fcntl
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, List

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "magicdrive_v2_tpu_torch"
SOURCES = ("fused_qkv_attention", "flash_attention", "adaln_modulate")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

MAX_HEAD_DIM = 144  # kMaxD of csrc/attn_core.cuh

_libs: Dict[str, ctypes.CDLL] = {}
build_seconds = 0.0  # wall time of the last build in this process (0 if none was needed)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.isfile(cand):
        return cand
    raise RuntimeError("nvcc not found: the CUDA kernels of magicdrive_v2_tpu_torch "
                       "are compiled at first use and need the CUDA toolkit")


def source_hash() -> str:
    h = hashlib.sha256()
    for path in sorted(CSRC_DIR.iterdir()):
        if path.suffix in (".cu", ".cuh"):
            h.update(path.name.encode())
            h.update(path.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def _lib_path(name: str, tag: str) -> Path:
    return BUILD_DIR / f"lib{name}-{tag}.so"


def build_all() -> Dict[str, Path]:
    """Compile every missing library; returns name -> path. Raises on failure."""
    tag = source_hash()
    paths = {name: _lib_path(name, tag) for name in SOURCES}
    if all(p.is_file() for p in paths.values()):
        return paths
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # one build at a time; a process that waited finds the libraries built (the
    # lock goes with its holder's process, so a killed build leaves none behind)
    with open(BUILD_DIR / f".lock-{tag}", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        _build([name for name in SOURCES if not paths[name].is_file()], paths, tag)
    return paths


def _build(todo: List[str], paths: Dict[str, Path], tag: str) -> None:
    global build_seconds
    if not todo:
        return
    nvcc = _nvcc()
    t0 = time.time()
    procs = []
    for name in todo:
        tmp = paths[name].with_suffix(f".tmp{os.getpid()}.so")
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC_DIR), "-o", str(tmp),
               str(CSRC_DIR / f"{name}.cu")]
        log = open(BUILD_DIR / f"{name}-{tag}.log", "w")
        procs.append((name, tmp, log, subprocess.Popen(
            cmd, stdout=log, stderr=subprocess.STDOUT)))
    failed = []
    for name, tmp, log, proc in procs:
        rc = proc.wait()
        log.close()
        if rc != 0:
            failed.append(name)
        else:
            os.replace(tmp, paths[name])
    build_seconds = time.time() - t0
    if failed:
        logs = "\n".join(
            f"--- {name} ---\n" + (BUILD_DIR / f"{name}-{tag}.log").read_text()[-4000:]
            for name in failed)
        raise RuntimeError(f"nvcc failed for {failed}:\n{logs}")


def load(name: str) -> ctypes.CDLL:
    """The shared library of ``csrc/<name>.cu``, built first if needed."""
    lib = _libs.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build_all()[name]))
        _libs[name] = lib
    return lib


def ptxas_report(name: str) -> List[Dict[str, object]]:
    """What ``-Xptxas -v`` said about each kernel of ``csrc/<name>.cu`` in the log
    of its current build: function (mangled), registers, spill stores and loads
    (bytes)."""
    log = BUILD_DIR / f"{name}-{source_hash()}.log"
    rows: List[Dict[str, object]] = []
    for line in log.read_text().splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            rows.append(dict(function=m.group(1), registers=None, spill_stores=None,
                             spill_loads=None))
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and rows:
            rows[-1]["spill_stores"], rows[-1]["spill_loads"] = map(int, m.groups())
        m = re.search(r"Used (\d+) registers", line)
        if m and rows:
            rows[-1]["registers"] = int(m.group(1))
    return rows


@contextlib.contextmanager
def on_device(t):
    """The context of one launch on tensor ``t``'s card: that card is the current
    device inside it; yields the handle of its current stream."""
    import torch
    with torch.cuda.device(t.device):
        yield torch.cuda.current_stream(t.device).cuda_stream


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError {err}")


DTYPE_CODES = {"torch.bfloat16": 0, "torch.float32": 1}


def dtype_code(dtype) -> int:
    code = DTYPE_CODES.get(str(dtype))
    if code is None:
        raise TypeError(f"kernel takes bfloat16 or float32 tensors, got {dtype}")
    return code
