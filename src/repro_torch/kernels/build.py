"""Build and load the hand-written Hopper kernels under ``csrc/``.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by ``nvcc``
for ``sm_90a`` into its own shared library, loaded with ``ctypes``; a body
shared by two sources lives in a ``csrc/*.cuh`` header.  The attention
sources build twice, once for the head dims up to 128 and once, as the
``_wide`` library, for 128 < D <= 256 (a ``-D`` flag picks the class), so
that the halves compile in parallel.  The build runs at first use, from
the sources in the checkout only, into ``build/repro_torch_kernels/`` at
the repository root; all libraries compile at once, one ``nvcc`` process
each, and a caller may start them all (``start``) and wait only for those
it needs first (``load(names)``).  A library's file name carries a hash of its source, the headers and
the flags, so an edited source is never served by a stale build.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
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
    libs: dict = {}         # name -> ctypes.CDLL
    # name -> (nvcc process, temporary output, log, the thread that times it)
    jobs: dict = {}
    logs: dict = {}
    seconds: dict = {}      # each source's nvcc wall time, built here
    sass: dict = {}         # name -> ``cuobjdump -sass`` text
    t0: float | None = None


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


def start(names=SOURCES) -> None:
    """Start one ``nvcc`` process for each library of ``names`` that is not
    built yet, and return without waiting (``load`` waits)."""
    out = build_dir()
    out.mkdir(parents=True, exist_ok=True)
    for name in names:
        so = _target(name, out)
        if name in _Loaded.libs or name in _Loaded.jobs or so.exists():
            continue
        if _Loaded.t0 is None:
            _Loaded.t0 = time.perf_counter()
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        log = so.with_suffix(".log")
        cmd = [_nvcc(), *_flags(name), "-o", str(tmp),
               str(CSRC / f"{LIBRARIES[name][0]}.cu")]
        with open(log, "w") as fh:
            proc = subprocess.Popen(cmd, stdout=fh, stderr=subprocess.STDOUT)
        watch = threading.Thread(target=_watch, args=(name, proc),
                                 daemon=True)
        watch.start()
        _Loaded.jobs[name] = (proc, tmp, log, watch)


def _watch(name: str, proc) -> None:
    """Record ``proc``'s nvcc wall time (from the first start) at its end."""
    proc.wait()
    _Loaded.seconds[name] = time.perf_counter() - _Loaded.t0


def load(names=SOURCES) -> dict:
    """Build (once per source version) and load the kernel libraries
    ``names`` (a name or several; every library by default): the missing
    ones compile at once, one ``nvcc`` process each, beside any that
    ``start`` began; returns {name: ctypes.CDLL} of every library loaded
    so far."""
    names = (names,) if isinstance(names, str) else tuple(names)
    start(names)
    waiting = [n for n in names if n in _Loaded.jobs]
    for name in waiting:
        _Loaded.jobs[name][0].wait()
        _Loaded.jobs[name][3].join()
    failed = []
    for name in waiting:
        proc, tmp, log, _ = _Loaded.jobs.pop(name)
        if proc.returncode != 0:
            failed.append(f"{name}: {log.read_text()[-2000:]}")
            continue
        os.replace(tmp, _target(name, build_dir()))
        _Loaded.logs[name] = log.read_text()
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    for name in names:
        if name not in _Loaded.libs:
            _Loaded.libs[name] = ctypes.CDLL(str(_target(name, build_dir())))
    return _Loaded.libs


def function(lib: str, symbol: str, argtypes: list):
    """The C entry ``symbol`` of library ``lib`` with its ctypes signature
    (every entry returns the launch's cudaError_t as an int)."""
    fn = getattr(load(lib)[lib], symbol)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def build_seconds() -> dict:
    """{source: nvcc wall seconds} of the sources built in this process."""
    return dict(_Loaded.seconds)


def ptxas_logs() -> dict:
    """``nvcc -Xptxas=-v`` output of the sources built in this process."""
    return dict(_Loaded.logs)


def dump_sass(libs) -> dict:
    """{lib: ``cuobjdump -sass`` text} of the built libraries ``libs`` (the
    toolkit beside nvcc), one ``cuobjdump`` process each, all at once;
    each library is dumped once per process."""
    libs = (libs,) if isinstance(libs, str) else tuple(libs)
    todo = [lib for lib in libs if lib not in _Loaded.sass]
    load(todo)
    tool = Path(_nvcc()).with_name("cuobjdump")

    def dump(lib):
        _Loaded.sass[lib] = subprocess.run(
            [str(tool), "-sass", str(_target(lib, build_dir()))],
            capture_output=True, text=True, check=True).stdout

    with ThreadPoolExecutor(max(len(todo), 1)) as pool:
        list(pool.map(dump, todo))
    return {lib: _Loaded.sass[lib] for lib in libs}


def sass_counts(lib: str, kernel: str, opcode: str) -> dict:
    """{mangled function name: count of ``opcode`` instructions} for each
    function of library ``lib`` whose name holds ``kernel``, from
    ``cuobjdump -sass`` of the built library (``dump_sass``)."""
    text = dump_sass(lib)[lib]
    counts = {}
    for part in text.split("Function : ")[1:]:
        name, _, body = part.partition("\n")
        if kernel in name:
            counts[name.strip()] = len(re.findall(
                rf"\*/\s+(?:@!?U?P\w+\s+)?{opcode}[.\s]", body))
    return counts
