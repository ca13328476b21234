"""Build the CUDA C++ kernels in ``csrc/`` and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface (no PyTorch headers) and
builds on its own into ``build/<name>-<hash>.so``, where the hash covers the
source, the shared headers and the flags: a changed source rebuilds, an
unchanged one is loaded as it is. ``build()`` starts one ``nvcc`` per
source, all at once, and waits for all of them; the first call of a kernel
wrapper builds what it needs. Nothing builds when a module is imported.

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas=-v -o build/<name>-<hash>.so csrc/<name>.cu

``-Xptxas=-v`` writes each kernel's registers, shared memory and spills into
``build/<name>-<hash>.log``.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import sys
import threading
import time
from pathlib import Path
from typing import Callable, Dict, Iterable, Optional

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD = PKG / "build"
DEFAULT_NVCC = Path("/usr/local/cuda/bin/nvcc")   # the toolkit's prefix
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def cache_bytecode() -> None:
    """Keep the bytecode of this process's later imports, and of every
    process it starts, under ``build/pycache``: where the environment says
    not to write bytecode (``PYTHONDONTWRITEBYTECODE``), every rank and
    child process would compile torch's and the port's sources anew,
    about a second of each start. The started processes inherit the
    setting through the environment."""
    prefix = str(BUILD / "pycache")
    os.environ.pop("PYTHONDONTWRITEBYTECODE", None)
    os.environ["PYTHONPYCACHEPREFIX"] = prefix
    sys.dont_write_bytecode = False
    sys.pycache_prefix = prefix


def sources() -> list:
    """Names of the kernels under csrc/ (one shared library each)."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def nvcc() -> str:
    """The CUDA compiler: $CUDA_HOME/bin/nvcc, else nvcc on PATH, else the
    toolkit's default install prefix."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    if DEFAULT_NVCC.exists():
        return str(DEFAULT_NVCC)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH "
                       "(the CUDA kernels build on the machine with the card)")


def target(name: str) -> Path:
    h = hashlib.sha256()
    for path in [CSRC / f"{name}.cu"] + sorted(CSRC.glob("*.cuh")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD / f"{name}-{h.hexdigest()[:16]}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """Build every named kernel (default: all of csrc/) that is not built
    yet, one nvcc process per source, all started together. Returns the
    seconds each build took (0.0 for one already built); raises with the
    compiler's output if any build fails."""
    names = sources() if names is None else list(names)
    BUILD.mkdir(parents=True, exist_ok=True)
    compiler = None
    procs = {}
    for name in names:
        out = target(name)
        if out.exists():
            continue
        compiler = compiler or nvcc()
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        log = open(out.with_suffix(".log"), "w")
        cmd = [compiler, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=log,
                                        stderr=subprocess.STDOUT),
                       log, tmp, out, time.monotonic())
    took = {name: 0.0 for name in names}
    failed = []
    for name, (proc, log, tmp, out, t0) in procs.items():
        rc = proc.wait()
        log.close()
        took[name] = time.monotonic() - t0
        if rc != 0:
            failed.append(f"{name} (nvcc exit {rc}):\n"
                          f"{out.with_suffix('.log').read_text()}")
            continue
        os.replace(tmp, out)    # atomic: a reader never sees half a library
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return took


def build_log(name: str) -> str:
    """What nvcc and ptxas printed for the current build of ``name``."""
    log = target(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def load(name: str, configure: Callable[[ctypes.CDLL], None]) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed.
    ``configure`` sets argtypes/restype on its entry points."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(target(name)))
            configure(lib)
            _libs[name] = lib
        return lib
