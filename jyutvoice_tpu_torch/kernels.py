"""Build, load and count the package's CUDA kernels.

Each `csrc/<name>.cu` exports a plain C function and is compiled by nvcc into
its own shared library under `_build/`, at first use; the libraries are loaded
with ctypes. Libraries are named by a hash of their source and of the local
headers it includes (`#include "..."`), so an edited source or header
rebuilds and an unchanged one is reused. `build_all()` starts one nvcc per
source at once.

`LAUNCHES` counts kernel launches per kernel entry point. A wrapper adds one
through `count_launch` where it launches its kernel and nowhere else;
`reset_launch_counts()` zeroes them. Both hold a lock, so launches from
several threads (a serving engine's worker beside a streaming lane's) keep
the counts exact.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import subprocess
import tempfile
import threading
from typing import Dict, List

import torch

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "_build")
KERNEL_SOURCES = ("flash_attention", "resblock_stage", "flash_stock", "flash_stock_bwd",
                  "int8_linear", "f32_gemm")
# entry points counted in LAUNCHES: kernels 1-3, then kernels 4 and 5 and
# the preparation of their operands (the three entry points of
# csrc/flash_stock_bwd.cu), then the DiT's 3xTF32 GEMM (csrc/f32_gemm.cu),
# then the int8 linear's row quantization and GEMM (the two entry points of
# csrc/int8_linear.cu)
KERNEL_NAMES = ("flash_attention", "resblock_stage", "flash_stock",
                "flash_stock_bwd_dkv", "flash_stock_bwd_dq", "flash_stock_bwd_prep",
                "f32_gemm", "int8_quant_rows", "int8_gemm")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

LAUNCHES: Dict[str, int] = {name: 0 for name in KERNEL_NAMES}
_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()  # builds and library loads
_COUNT_LOCK = threading.Lock()  # LAUNCHES


def count_launch(name: str) -> None:
    """Add one launch of `name` to LAUNCHES."""
    with _COUNT_LOCK:
        LAUNCHES[name] += 1


def reset_launch_counts() -> None:
    with _COUNT_LOCK:
        for name in LAUNCHES:
            LAUNCHES[name] = 0


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = os.path.join(cuda_home, "bin", "nvcc")
    return path if os.path.exists(path) else "nvcc"


_LOCAL_INCLUDE = re.compile(rb'^\s*#\s*include\s*"([^"]+)"', re.M)


def _source_bytes(path: str, seen: set) -> bytes:
    """A source and, recursively, the local headers it includes."""
    with open(path, "rb") as f:
        src = f.read()
    for header in _LOCAL_INCLUDE.findall(src):
        name = header.decode()
        if name not in seen:
            seen.add(name)
            src += _source_bytes(os.path.join(CSRC, name), seen)
    return src


def _lib_path(name: str) -> str:
    src = _source_bytes(os.path.join(CSRC, f"{name}.cu"), set())
    digest = hashlib.sha1(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return os.path.join(BUILD_DIR, f"lib{name}-{digest[:12]}.so")


def _start_build(name: str):
    """Start nvcc for one source into a temporary file; None if built."""
    out = _lib_path(name)
    if os.path.exists(out):
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, f"{name}.cu")]
    proc = subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
    )
    return proc, tmp, out


def _finish_build(name: str, started) -> None:
    if started is None:
        return
    proc, tmp, out = started
    log, _ = proc.communicate()
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{log}")
    os.replace(tmp, out)
    with open(out[:-3] + ".log", "w") as f:  # ptxas -v: registers, spills, shared memory
        f.write(log)


def build_all() -> None:
    """Compile every kernel source that has no library yet, all at once."""
    with _LOCK:
        started = {name: _start_build(name) for name in KERNEL_SOURCES}
        errors = []
        for name, st in started.items():
            try:
                _finish_build(name, st)
            except RuntimeError as e:
                errors.append(str(e))
        if errors:
            raise RuntimeError("\n".join(errors))


def load(name: str) -> ctypes.CDLL:
    """The loaded library of one kernel source, building it if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        with _LOCK:
            _finish_build(name, _start_build(name))
            lib = _LIBS.setdefault(name, ctypes.CDLL(_lib_path(name)))
    return lib


def ptxas_facts(name: str) -> Dict[str, str]:
    """Per compiled kernel function of one built source: 'N registers, S B
    spill stores, L B spill loads', from the ptxas -v lines of its build
    log (saved beside the library)."""
    with open(_lib_path(name)[:-3] + ".log") as f:
        log = f.read()
    facts, func = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            func = m.group(1)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and func:
            facts[func] = f"{m.group(1)} B spill stores, {m.group(2)} B spill loads"
        m = re.search(r"Used (\d+) registers", line)
        if m and func:
            facts[func] = f"{m.group(1)} registers, " + facts.get(func, "")
    return facts


def ptxas_warnings(name: str) -> List[str]:
    """The warnings of one built source's compile (e.g. wgmma instructions
    that ptxas serialized), from its build log."""
    with open(_lib_path(name)[:-3] + ".log") as f:
        return [line.strip() for line in f if "warning" in line.lower()]


def sass_opcode_count(name: str, opcode: str) -> Dict[str, int]:
    """Per kernel function of one built source, how many SASS instructions
    start with `opcode` (e.g. "HGMMA"), from cuobjdump -sass."""
    tool = os.path.join(os.path.dirname(_nvcc()), "cuobjdump")
    out = subprocess.run([tool if os.path.exists(tool) else "cuobjdump", "-sass",
                          _lib_path(name)], capture_output=True, text=True, check=True).stdout
    counts, func = {}, None
    for line in out.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            func = m.group(1)
            counts[func] = 0
        elif func and re.search(r"\*/\s+" + opcode + r"\b", line):
            counts[func] += 1
    return counts


def refuse_autograd(name: str, *tensors: torch.Tensor) -> None:
    """Raise when autograd would need a gradient through a forward-only
    kernel: its output would carry no grad_fn and silently cut the graph."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name} is forward-only (the JAX package has no backward for it): "
            "call it under torch.no_grad() or on tensors that need no gradient"
        )


def tracing() -> bool:
    """True while torch.export or torch.compile traces (dynamo, or an active
    FakeTensor mode): tensors made then are not real, so no cache may keep
    them and no kernel may be launched."""
    if torch.compiler.is_compiling():
        return True
    from torch._guards import detect_fake_mode

    return detect_fake_mode() is not None


def check(status: int, name: str) -> None:
    """Raise on a CUDA error code returned by a launch."""
    if status != 0:
        raise RuntimeError(f"CUDA error {status} launching the {name} kernel")
