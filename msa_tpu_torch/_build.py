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
them changes.  Building a file with a C interface takes seconds, against
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
              "-O3", "-shared", "-Xcompiler", "-fPIC")
HOST_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")
KERNELS = ("short_attention", "fused_joint_embed", "ln_quant", "flash2",
           "fused_adamw", "flash_attention", "short_attention_v1")
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


def _source(name: str) -> Path:
    """``csrc/<name>.cu`` where it exists, else ``csrc/<name>.cpp``."""
    cuda = CSRC / f"{name}.cu"
    return cuda if cuda.exists() else CSRC / f"{name}.cpp"


def _flags(source: Path) -> Sequence[str]:
    return NVCC_FLAGS if source.suffix == ".cu" else HOST_FLAGS


def library_path(name: str) -> Path:
    source = _source(name)
    digest = hashlib.sha256(source.read_bytes())
    if source.suffix == ".cu":
        for header in sorted(CSRC.glob("*.cuh")):  # a source may include any
            digest.update(header.name.encode())
            digest.update(header.read_bytes())
    digest.update(" ".join(_flags(source)).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` (else ``.cpp``) unless its library is
    already built."""
    return build_all([name])[name]


def build_all(names: Sequence[str] = KERNELS,
              seconds: Optional[Dict[str, float]] = None) -> Dict[str, Path]:
    """Compile every library of ``names`` not built yet, one compiler
    process per source (``nvcc`` for a ``.cu``, the host compiler for a
    ``.cpp``), all started together; raises if any fails.  ``seconds``, if
    given, receives each compiled source's compile wall time."""
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
            cmd = [compilers[source.suffix], *_flags(source), "-o", tmp,
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
    """What ``ptxas -v`` reports for every kernel of the sources ``names``
    (compiled with the build's flags to a scratch library, one ``nvcc`` per
    source, all started together): dicts of source, kernel (its mangled
    name), registers, static shared memory, stack frame and spill bytes,
    and ``serialized``: the ptxas notices that it serialised the kernel's
    ``wgmma.mma_async`` instructions (a notice names its function, else it
    is the kernel being compiled).  Dynamic shared memory is the launcher's
    and is not in it."""
    nvcc = nvcc_path()
    with tempfile.TemporaryDirectory() as tmp:
        procs = [(name, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-o",
             os.path.join(tmp, f"{name}.so"), str(CSRC / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
            for name in names]
        outputs = [(name, proc.communicate()[0], proc.returncode)
                   for name, proc in procs]
    found = []
    for name, text, code in outputs:
        if code != 0:
            raise RuntimeError(f"nvcc -Xptxas -v failed for {name}.cu:\n{text}")
        entry = None
        notices = []  # (the function named, else the kernel compiled, line)
        start = len(found)
        for line in text.splitlines():
            m = re.search(r"Compiling entry function '([^']+)'", line)
            if m:
                entry = {"source": f"{name}.cu", "kernel": m.group(1),
                         "serialized": []}
                found.append(entry)
                continue
            if "wgmma" in line and "serializ" in line:
                named = re.search(r"'(_Z[^']+)'", line)
                notices.append((named.group(1) if named else entry and
                                entry["kernel"], line.strip()))
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
        for kernel, line in notices:
            if kernel not in by_name:
                raise RuntimeError(f"{name}.cu: a wgmma notice for no kernel "
                                   f"ptxas compiled: {line}")
            by_name[kernel]["serialized"].append(line)
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
