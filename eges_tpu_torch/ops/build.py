"""Build the CUDA kernels with ``nvcc`` and load them with ctypes.

The sources in ``ops/csrc`` compile at first use into a shared library
with a plain C interface under ``build/eges_tpu_torch/`` in the
checkout, named by a hash of the sources and flags, so a changed source
rebuilds and an unchanged one loads at once.  A failed build raises.
"""

from __future__ import annotations

import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("recover.cu",)
HEADERS = ("field.cuh",)
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "eges_tpu_torch"
ARCH = "-gencode=arch=compute_90a,code=sm_90a"
FLAGS = (ARCH, "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
         "-Xptxas", "-v")


def nvcc_path() -> str:
    """``nvcc`` from PATH or the CUDA toolkit's usual home; raises when
    there is none."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       "the eges_tpu_torch kernels")


def source_hash() -> str:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_DIR / f"libeges_recover_{source_hash()}.so"


def nvcc_command(out: Path) -> list[str]:
    return [nvcc_path(), *FLAGS, "-o", str(out),
            *(str(CSRC / s) for s in SOURCES)]


_PTXAS_ENTRY = re.compile(r"Compiling entry function '(\w+)'")
_PTXAS_REGS = re.compile(r"Used (\d+) registers")
_PTXAS_SPILL = re.compile(
    r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill "
    r"loads")


def parse_ptxas(log: str) -> dict[str, dict[str, int]]:
    """Per-kernel registers, stack frame and spill bytes from the
    ``-Xptxas -v`` report."""
    out: dict[str, dict[str, int]] = {}
    cur = None
    for line in log.splitlines():
        m = _PTXAS_ENTRY.search(line)
        if m:
            cur = out.setdefault(m.group(1), {})
            continue
        if cur is None:
            continue
        m = _PTXAS_SPILL.search(line)
        if m:
            cur["stack_bytes"] = int(m.group(1))
            cur["spill_store_bytes"] = int(m.group(2))
            cur["spill_load_bytes"] = int(m.group(3))
        m = _PTXAS_REGS.search(line)
        if m:
            cur["registers"] = int(m.group(1))
    return out


def build() -> dict:
    """Compile the kernels unless the library for these sources exists.
    Returns ``{"path", "seconds", "built", "ptxas"}``; ``ptxas`` maps each
    kernel to its registers and spills when this call compiled."""
    out = library_path()
    log_path = out.with_suffix(".ptxas.txt")
    if out.exists():
        log = log_path.read_text() if log_path.exists() else ""
        return {"path": str(out), "seconds": 0.0, "built": False,
                "ptxas": parse_ptxas(log)}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(out.name + f".tmp{os.getpid()}")
    t0 = time.monotonic()
    proc = subprocess.run(nvcc_command(tmp), capture_output=True, text=True)
    seconds = time.monotonic() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{proc.stdout}\n{proc.stderr}")
    log_path.write_text(proc.stdout + proc.stderr)
    os.replace(tmp, out)
    return {"path": str(out), "seconds": seconds, "built": True,
            "ptxas": parse_ptxas(proc.stdout + proc.stderr)}
