"""Build the CUDA kernels with ``nvcc`` and load them with ctypes.

The sources in ``ops/csrc`` compile at first use into a shared library
with a plain C interface under ``build/eges_tpu_torch/`` in the
checkout, named by a hash of the sources and flags, so a changed source
rebuilds and an unchanged one loads at once.  Each source compiles in
its own ``nvcc`` process (``ladder.cu`` in one for each of its lane
counts), all started together, and one more links the objects.  A
failed build raises.  Each ``nvcc`` runs with a 1 GiB stack: the inlined
ladder of ``ladder.cu`` is one function of some thousands of products,
and ``cicc`` recurses past the usual 8 MiB on it and crashes.
"""

from __future__ import annotations

import hashlib
import os
import re
import resource
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("recover.cu", "verify.cu", "glue.cu", "tiling.cu", "profile.cu",
           "ladder.cu")
HEADERS = ("field.cuh", "launch.cuh")
# the lanes a row the pow and ladder kernels are built for
LANES = (1, 2, 4, 8)
# (source, its defines) of each nvcc: ladder.cu once for each lanes count
UNITS = tuple((s, ()) for s in SOURCES if s != "ladder.cu") + tuple(
    ("ladder.cu", (f"-DEG_LANES={t}",)) for t in LANES)
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "eges_tpu_torch"
ARCH = "-gencode=arch=compute_90a,code=sm_90a"
FLAGS = (ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def nvcc_path(tool: str = "nvcc") -> str:
    """``nvcc`` (or another tool of the CUDA toolkit) from PATH or the
    toolkit's usual home; raises when there is none."""
    found = shutil.which(tool)
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / tool
    if cand.exists():
        return str(cand)
    raise RuntimeError(f"{tool} not found: the CUDA toolkit is needed to "
                       "build the eges_tpu_torch kernels")


def source_hash() -> str:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    h.update(repr(UNITS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_DIR / f"libeges_recover_{source_hash()}.so"


def compile_command(source: str, obj: Path, defines=()) -> list[str]:
    return [nvcc_path(), *FLAGS, *defines, "-c", "-o", str(obj),
            str(CSRC / source)]


def link_command(objs: list[Path], out: Path) -> list[str]:
    return [nvcc_path(), ARCH, "-shared", "-o", str(out),
            *(str(o) for o in objs)]


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


_SASS_FUNCTION = re.compile(r"Function : (\w+)")
_SASS_INSTRUCTION = re.compile(r"/\*([0-9a-f]{4,})\*/\s+([^;]*?)\s*;")


def opcode(ins: str) -> str:
    """``"@!P0 BRA 0x4f0"`` -> ``"BRA"``."""
    return re.sub(r"^@!?\w+\s+", "", ins).split()[0]


def _target(ins: str) -> int:
    return int(ins.split()[-1], 16)


def parse_sass(listing: str) -> dict[str, list[tuple[int, str]]]:
    """``cuobjdump -sass`` output -> each function's instructions as
    ``(address, text)``, without the NOPs and the branch to itself after
    the last EXIT (neither issues)."""
    out: dict[str, list[tuple[int, str]]] = {}
    cur = None
    for line in listing.splitlines():
        m = _SASS_FUNCTION.search(line)
        if m:
            cur = out.setdefault(m.group(1), [])
            continue
        m = _SASS_INSTRUCTION.search(line)
        if m is None or cur is None:
            continue
        addr, ins = int(m.group(1), 16), m.group(2)
        op = opcode(ins)
        if op == "NOP" or (op == "BRA" and _target(ins) == addr):
            continue
        cur.append((addr, ins))
    return out


def sass(path) -> dict[str, list[tuple[int, str]]]:
    """The ``sm_90a`` code of each kernel of a built library."""
    proc = subprocess.run([nvcc_path("cuobjdump"), "-sass", str(path)],
                          capture_output=True, text=True, check=True)
    return parse_sass(proc.stdout)


def straight_line(code: list[tuple[int, str]]) -> bool:
    """No branch and no call: every instruction issues once a warp."""
    return not any(opcode(ins).startswith(("BRA", "BRX", "JMP", "CALL",
                                            "RET"))
                   for _, ins in code)


def loop_bodies(code: list[tuple[int, str]]) -> list[list[str]]:
    """The instructions of each loop: from a backward branch's target to
    the branch."""
    return [[i for a, i in code if _target(ins) <= a <= addr]
            for addr, ins in code
            if opcode(ins) == "BRA" and _target(ins) < addr]


def least_path(code: list[tuple[int, str]]) -> int:
    """The fewest instructions any thread's run of a kernel issues, from
    its entry to an EXIT: the shortest path through its code, where a
    predicated branch or EXIT may go either way and an unpredicated one
    always goes (a loop on the way counts once).  Raises on an indirect
    branch or a call, whose targets the listing does not give."""
    index = {a: i for i, (a, _) in enumerate(code)}
    dist = {0: 1}                     # instructions issued up to and at i
    todo = [0]
    best = None
    while todo:
        nxt = []
        for i in todo:
            ins = code[i][1]
            op = opcode(ins)
            cond = ins.startswith("@")
            if op.startswith(("BRX", "JMP", "CALL", "RET")):
                raise ValueError(f"no path count through {ins}")
            succ = []
            if op == "EXIT":
                best = dist[i] if best is None else min(best, dist[i])
            elif op.startswith("BRA"):
                succ.append(index[_target(ins)])
            if cond or not (op == "EXIT" or op.startswith("BRA")):
                succ.append(i + 1)
            for j in succ:
                if j < len(code) and j not in dist:
                    dist[j] = dist[i] + 1
                    nxt.append(j)
        todo = nxt
    if best is None:
        raise ValueError("no path reaches an EXIT")
    return best


# cicc's stack (measured on nvcc 12.9: the ladder built with 1 GiB and
# crashed with 8 MiB, and also with no limit, where threads fall back to a
# small default stack)
NVCC_STACK = 1 << 30


def _nvcc_stack() -> None:
    """In the child before exec: the soft stack limit to NVCC_STACK, or
    to the hard limit where that is lower."""
    _, hard = resource.getrlimit(resource.RLIMIT_STACK)
    soft = (NVCC_STACK if hard == resource.RLIM_INFINITY
            else min(NVCC_STACK, hard))
    resource.setrlimit(resource.RLIMIT_STACK, (soft, hard))


def _run_all(commands: list[list[str]]) -> str:
    """Run the commands at once; their joined output, or raise with the
    output of every one that failed."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True,
                              preexec_fn=_nvcc_stack)
             for c in commands]
    logs, failed = [], []
    for cmd, proc in zip(commands, procs):
        out, _ = proc.communicate()
        logs.append(out)
        if proc.returncode != 0:
            failed.append(f"{' '.join(cmd)} -> {proc.returncode}:\n{out}")
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return "".join(logs)


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
    tag = f"{source_hash()}.tmp{os.getpid()}"
    objs = [BUILD_DIR / f"{Path(s).stem}{i}_{tag}.o"
            for i, (s, _) in enumerate(UNITS)]
    tmp = out.with_name(out.name + f".tmp{os.getpid()}")
    t0 = time.monotonic()
    try:
        log = _run_all([compile_command(s, o, d)
                        for (s, d), o in zip(UNITS, objs)])
        _run_all([link_command(objs, tmp)])
    finally:
        for o in objs:
            o.unlink(missing_ok=True)
    seconds = time.monotonic() - t0
    log_path.write_text(log)
    os.replace(tmp, out)
    return {"path": str(out), "seconds": seconds, "built": True,
            "ptxas": parse_ptxas(log)}
