"""Build the port's native libraries and load them with ``ctypes``.

Two routes share one build directory:

  * the CUDA kernels, ``csrc/<name>.cu``, compiled by ``nvcc`` for
    ``sm_90a``;
  * host C++ libraries, ``csrc/<name>.cpp`` (the zstd decoder of the
    checkpoint reader, the WordPiece encoder), compiled by ``$CXX``, else ``c++`` on PATH, with
    ``-O3 -std=c++17 -shared -fPIC``; they need no CUDA toolkit, so they
    build wherever the port runs, on the CPU too.

Each source exposes a plain C interface and compiles on its own into
``build/msa_tpu_torch/<name>-<hash>.so`` at the repository root, where
``<hash>`` covers the source text, the shared headers ``csrc/*.cuh`` (CUDA
sources) and the compiler flags: a library is rebuilt only when one of
them changes.  The attention sources (``HEAD_DIM_SOURCES``) compile once a
head dim of ``HEAD_DIMS``, ``-DMSA_HEAD_DIM=<d>`` into the library
``<name>_d<d>`` (:func:`head_dim_library`), each its own compiler process:
the instantiations of one head dim are a quarter of the source's.  ptxas's
report (``-Xptxas -v``) is kept beside each CUDA library
(``<name>-<hash>.ptxas``) for :func:`resource_usage`.  Building a file with a C interface takes seconds, against
minutes for an extension that includes PyTorch's headers.  The build
happens at first use, never at import, and a failed build raises --
nothing falls back to the plain PyTorch versions or to a slower reader
(only the WordPiece encoder's caller keeps its pure-Python tokenizer).

Every CUDA entry point returns ``cudaGetLastError()`` after its launch; the
wrappers in ``msa_tpu_torch.ops`` raise on a non-zero code.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, List, Optional, Sequence

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "msa_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
HOST_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")
KERNELS = ("short_attention", "fused_joint_embed", "ln_quant", "flash2",
           "fused_adamw", "flash_attention", "short_attention_v1")
# The head dims every attention kernel is instantiated for; the wrappers run
# any other head dim d <= 256 on the smallest of them at or above d.
HEAD_DIMS = (16, 32, 64, 128, 256)
HEAD_DIM_SOURCES = ("short_attention", "short_attention_v1", "flash2",
                    "flash_attention")
# short_attention_v1's whole-row kernels stop at 128: above it v1 runs on
# short_attention's library (ops/short_attention.py routes it), so no
# library of the source is built there.
SOURCE_MAX_HEAD_DIM = {"short_attention_v1": 128}
_HEAD_DIM_LIBRARY = re.compile(r"(.+)_d(\d+)$")
DEFAULT_NVCC = "/usr/local/cuda/bin/nvcc"  # the CUDA toolkit's default prefix

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH, else the toolkit's
    default install prefix; raises when none exists."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(on_path)
    candidates.append(DEFAULT_NVCC)
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH): the CUDA "
        "kernels of msa_tpu_torch are compiled at first use")


def cxx_path() -> str:
    """``$CXX``, else ``c++`` on PATH; raises when neither exists."""
    cxx = os.environ.get("CXX") or shutil.which("c++")
    if not cxx or not shutil.which(cxx):
        raise RuntimeError(
            "no host C++ compiler (set CXX or put c++ on PATH): the host "
            "libraries of msa_tpu_torch are compiled at first use")
    return cxx


def source_head_dims(name: str) -> tuple:
    """The head dims of ``HEAD_DIMS`` that attention source ``name`` is
    built for."""
    top = SOURCE_MAX_HEAD_DIM.get(name, HEAD_DIMS[-1])
    return tuple(d for d in HEAD_DIMS if d <= top)


def head_dim_library(name: str, head_dim: int) -> str:
    """The library of attention source ``name`` built for ``head_dim`` (one
    of :func:`source_head_dims`)."""
    if name not in HEAD_DIM_SOURCES or head_dim not in source_head_dims(name):
        raise ValueError(f"no library of {name} at head dim {head_dim}")
    return f"{name}_d{head_dim}"


def libraries(names: Sequence[str] = KERNELS) -> List[str]:
    """The libraries of ``names``: an attention source (``HEAD_DIM_SOURCES``)
    stands for its library at every head dim it is built for, any other
    name for itself."""
    return [head_dim_library(n, d) if n in HEAD_DIM_SOURCES else n
            for n in names for d in (source_head_dims(n)
                                     if n in HEAD_DIM_SOURCES else (None,))]


def _split(name: str):
    """(source stem, head dim or None) of a library name."""
    m = _HEAD_DIM_LIBRARY.match(name)
    if m and m.group(1) in HEAD_DIM_SOURCES:
        return m.group(1), int(m.group(2))
    return name, None


def _source(name: str) -> Path:
    """``csrc/<stem>.cu`` where it exists, else ``csrc/<stem>.cpp``."""
    stem = _split(name)[0]
    cuda = CSRC / f"{stem}.cu"
    return cuda if cuda.exists() else CSRC / f"{stem}.cpp"


def _flags(name: str) -> Sequence[str]:
    if _source(name).suffix != ".cu":
        return HOST_FLAGS
    head_dim = _split(name)[1]
    return NVCC_FLAGS + ((f"-DMSA_HEAD_DIM={head_dim}",) if head_dim else ())


def library_path(name: str) -> Path:
    source = _source(name)
    digest = hashlib.sha256(source.read_bytes())
    if source.suffix == ".cu":
        for header in sorted(CSRC.glob("*.cuh")):  # a source may include any
            digest.update(header.name.encode())
            digest.update(header.read_bytes())
    digest.update(" ".join(_flags(name)).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def _ptxas_log(lib: Path) -> Path:
    return lib.with_suffix(".ptxas")


def build(name: str) -> Path:
    """Compile library ``name`` unless it is already built: ``csrc/<name>.cu``
    (else ``.cpp``), an attention source's library at one head dim
    (:func:`head_dim_library`), or, by the source's own name, that source
    with every head dim."""
    return _compile([name])[name]


def build_all(names: Sequence[str] = KERNELS,
              seconds: Optional[Dict[str, float]] = None) -> Dict[str, Path]:
    """Compile every library of ``names`` (:func:`libraries`: an attention
    source at each head dim) not built yet, one compiler process per
    library (``nvcc`` for a ``.cu``, the host compiler for a ``.cpp``), all
    started together; raises if any fails.  ``seconds``, if given, receives
    each compiled library's compile wall time."""
    return _compile(libraries(names), seconds)


def _compile(names: Sequence[str],
             seconds: Optional[Dict[str, float]] = None) -> Dict[str, Path]:
    """:func:`build_all` of the libraries ``names`` as named."""
    libs = {name: library_path(name) for name in names}
    todo = [name for name, lib in libs.items() if not lib.exists()]
    if not todo:
        return libs
    sources = {name: _source(name) for name in todo}
    compilers = {suffix: finder() for suffix, finder in
                 ((".cu", nvcc_path), (".cpp", cxx_path))
                 if any(s.suffix == suffix for s in sources.values())}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = []
    t0 = time.perf_counter()

    def finish(job):  # output and the wall time at which the compiler ended
        out = job[3].communicate()[0]
        return out, time.perf_counter() - t0

    try:
        for name in todo:
            # Compile to a private name, then rename: a concurrent build
            # never loads a half-written library.
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            source = sources[name]
            cmd = [compilers[source.suffix], *_flags(name), "-o", tmp,
                   str(source)]
            jobs.append((name, tmp, cmd, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        failed = []
        with ThreadPoolExecutor(len(jobs)) as pool:
            results = list(pool.map(finish, jobs))
        for (name, tmp, cmd, proc), (output, wall) in zip(jobs, results):
            if seconds is not None:
                seconds[name] = wall
            if proc.returncode != 0:
                failed.append(f"{os.path.basename(cmd[0])} failed for "
                              f"{sources[name].name} (exit {proc.returncode}):"
                              f"\n{' '.join(cmd)}\n{output}")
            else:
                if sources[name].suffix == ".cu":
                    _ptxas_log(libs[name]).write_text(output)
                os.replace(tmp, libs[name])
        if failed:
            raise RuntimeError("\n".join(failed))
    finally:
        for _, tmp, _, proc in jobs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            if os.path.exists(tmp):
                os.remove(tmp)
    return libs


def resource_usage(names: Sequence[str]) -> List[Dict[str, object]]:
    """What ``ptxas -v`` reported for every kernel of the CUDA libraries of
    ``names`` (:func:`libraries`; built first where they are not), read from
    the report the build keeps beside each: dicts of source (its file
    name), library, kernel (its mangled name), registers, static shared
    memory, stack frame and spill bytes, ``serialized``: the ptxas
    notices that it serialised the kernel's ``wgmma.mma_async``
    instructions, and ``setmaxnreg``: its notices that it ignored a
    ``setmaxnreg`` (a notice names its function, else it is the kernel being
    compiled).  Dynamic shared memory is the launcher's and is not in it."""
    found = []
    for name, lib in build_all(names).items():
        if _source(name).suffix != ".cu":
            continue
        text = _ptxas_log(lib).read_text()
        entry = None
        notices = []  # (the function named, else the kernel compiled, line)
        start = len(found)
        for line in text.splitlines():
            m = re.search(r"Compiling entry function '([^']+)'", line)
            if m:
                entry = {"source": _source(name).name, "library": name,
                         "kernel": m.group(1), "serialized": [],
                         "setmaxnreg": []}
                found.append(entry)
                continue
            kind = ("serialized" if "wgmma" in line and "serializ" in line
                    else "setmaxnreg" if "setmaxnreg" in line else None)
            if kind:
                named = re.search(r"'(_Z[^']+)'", line)
                notices.append((named.group(1) if named else entry and
                                entry["kernel"], kind, line.strip()))
                continue
            if entry is None:
                continue
            m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                          r"(\d+) bytes spill loads", line)
            if m:
                entry.update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                             spill_loads=int(m.group(3)))
            m = re.search(r"Used (\d+) registers", line)
            if m:
                entry["registers"] = int(m.group(1))
                smem = re.search(r"(\d+) bytes smem", line)
                entry["static_smem"] = int(smem.group(1)) if smem else 0
        by_name = {e["kernel"]: e for e in found[start:]}
        for kernel, kind, line in notices:
            if kernel not in by_name:
                raise RuntimeError(f"{name}: a {kind} notice for no kernel "
                                   f"ptxas compiled: {line}")
            by_name[kernel][kind].append(line)
    return found


def load(name: str, signatures: Dict[str, Sequence],
         restypes: Optional[Dict[str, type]] = None) -> ctypes.CDLL:
    """Build (if needed) and load library ``name``.

    ``signatures`` maps each C entry point to its ``argtypes``; an entry
    returns an ``int`` (a CUDA error code for a kernel) unless ``restypes``
    names another type for it.
    """
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build(name)))
            for fn, argtypes in signatures.items():
                getattr(lib, fn).argtypes = list(argtypes)
                getattr(lib, fn).restype = (restypes or {}).get(
                    fn, ctypes.c_int)
            _loaded[name] = lib
        return lib


def check(code: int, what: str) -> None:
    if code != 0:
        raise RuntimeError(f"{what}: CUDA error {code} at launch")
