"""Build and load the hand-written Hopper kernels under ``csrc/``.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by ``nvcc``
for ``sm_90a`` into its own shared library, loaded with ``ctypes``; a body
shared by two sources lives in a ``csrc/*.cuh`` header.  The attention
sources build twice, once for the head dims up to 128 and once, as the
``_wide`` library, for 128 < D <= 256 (a ``-D`` flag picks the class), so
that the halves compile in parallel.  The build runs at first use, from
the sources in the checkout only, into ``build/repro_torch_kernels/`` at
the repository root; all libraries compile at once, one ``nvcc`` process
each.  A library's file name carries a hash of its source, the headers and
the flags, so an edited source is never served by a stale build.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
# library -> (source stem under csrc/, extra nvcc flags)
LIBRARIES = {
    "quant_matmul": ("quant_matmul", ()),
    "decode_attention": ("decode_attention", ()),
    "decode_attention_wide": ("decode_attention", ("-DREPRO_DMAX=256",)),
    "decode_attention_partials": ("decode_attention_partials", ()),
    "decode_attention_partials_wide": ("decode_attention_partials",
                                       ("-DREPRO_DMAX=256",)),
    "prefill_attention": ("prefill_attention", ()),
    "prefill_attention_wide": ("prefill_attention", ("-DREPRO_WIDE=1",)),
    "fake_quant": ("fake_quant", ()),
}
SOURCES = tuple(LIBRARIES)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")


def build_dir() -> Path:
    """``build/repro_torch_kernels`` under the repository root."""
    return Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"


class _Loaded:
    """The process's loaded kernel libraries (a process-wide resource:
    ``ctypes`` never unloads a library)."""
    libs: dict | None = None
    logs: dict = {}
    seconds: dict = {}      # each source's nvcc wall time, built here


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (looked on PATH and in /usr/local/cuda/bin): the "
            "CUDA kernels are built from source at first use")
    return path


def _flags(name: str) -> tuple:
    return (*NVCC_FLAGS, *LIBRARIES[name][1])


def _target(name: str, out: Path) -> Path:
    src = (CSRC / f"{LIBRARIES[name][0]}.cu").read_bytes()
    src += b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src + " ".join(_flags(name)).encode()).hexdigest()
    return out / f"{name}-{digest[:16]}.so"


def load() -> dict:
    """Build (once per source version) and load every kernel library;
    returns {name: ctypes.CDLL}."""
    if _Loaded.libs is not None:
        return _Loaded.libs
    out = build_dir()
    out.mkdir(parents=True, exist_ok=True)
    targets = {name: _target(name, out) for name in SOURCES}
    missing = [name for name, so in targets.items() if not so.exists()]
    nvcc = _nvcc() if missing else None
    jobs = {}
    t0 = time.perf_counter()
    try:
        for name in missing:
            so = targets[name]
            tmp = so.with_suffix(f".{os.getpid()}.tmp")
            log = so.with_suffix(".log")
            cmd = [nvcc, *_flags(name), "-o", str(tmp),
                   str(CSRC / f"{LIBRARIES[name][0]}.cu")]
            with open(log, "w") as fh:
                jobs[name] = (subprocess.Popen(cmd, stdout=fh,
                                               stderr=subprocess.STDOUT),
                              tmp, log)
    finally:
        codes = {}
        while len(codes) < len(jobs):
            for name, (proc, _, _) in jobs.items():
                if name not in codes and proc.poll() is not None:
                    codes[name] = proc.returncode
                    _Loaded.seconds[name] = time.perf_counter() - t0
            time.sleep(0.05)
    failed = []
    for name, (_, tmp, log) in jobs.items():
        if codes[name] != 0:
            failed.append(f"{name}: {log.read_text()[-2000:]}")
            continue
        os.replace(tmp, targets[name])
        _Loaded.logs[name] = log.read_text()
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    _Loaded.libs = {name: ctypes.CDLL(str(so)) for name, so in targets.items()}
    return _Loaded.libs


def function(lib: str, symbol: str, argtypes: list):
    """The C entry ``symbol`` of library ``lib`` with its ctypes signature
    (every entry returns the launch's cudaError_t as an int)."""
    fn = getattr(load()[lib], symbol)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def build_seconds() -> dict:
    """{source: nvcc wall seconds} of the sources built in this process."""
    return dict(_Loaded.seconds)


def ptxas_logs() -> dict:
    """``nvcc -Xptxas=-v`` output of the sources built in this process."""
    return dict(_Loaded.logs)


def sass_counts(lib: str, kernel: str, opcode: str) -> dict:
    """{mangled function name: count of ``opcode`` instructions} for each
    function of library ``lib`` whose name holds ``kernel``, from
    ``cuobjdump -sass`` of the built library (the toolkit beside nvcc)."""
    load()
    so = _target(lib, build_dir())
    tool = Path(_nvcc()).with_name("cuobjdump")
    text = subprocess.run([str(tool), "-sass", str(so)], capture_output=True,
                          text=True, check=True).stdout
    counts = {}
    for part in text.split("Function : ")[1:]:
        name, _, body = part.partition("\n")
        if kernel in name:
            counts[name.strip()] = len(re.findall(
                rf"\*/\s+(?:@!?U?P\w+\s+)?{opcode}[.\s]", body))
    return counts
