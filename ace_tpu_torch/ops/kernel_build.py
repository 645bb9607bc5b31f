"""Build and load the port's CUDA kernels.

Each source under ``ace_tpu_torch/csrc/`` exposes a plain C interface and
is compiled by ``nvcc`` for Hopper (``sm_90a``) into its own shared
library, loaded with ``ctypes``. Libraries are built at first use into
``build/kernels/`` at the repository root, named by a hash of the source,
the shared headers (``csrc/*.cuh``) and the flags, so an edited source or
header is rebuilt and an unchanged one is reused. :func:`build` starts one
``nvcc`` per missing library, all at once, and waits for all of them.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

_LIBRARIES: dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """Path of the CUDA compiler; raises if there is none."""
    candidates = [shutil.which("nvcc")]
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    candidates.append(os.path.join(cuda_home, "bin", "nvcc"))
    for path in candidates:
        if path and os.path.isfile(path):
            return path
    raise RuntimeError(
        "nvcc not found: the CUDA kernels need the CUDA toolkit "
        "(set CUDA_HOME or put nvcc on PATH)"
    )


def library_path(source: str) -> Path:
    """Where the library built from ``csrc/<source>`` lives."""
    src = CSRC_DIR / source
    headers = b"".join(h.read_bytes() for h in sorted(CSRC_DIR.glob("*.cuh")))
    digest = hashlib.sha256(
        src.read_bytes() + headers + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    return BUILD_DIR / f"{src.stem}-{digest}.so"


def build(sources: list[str]) -> dict[str, float]:
    """Compile the given ``csrc/`` sources that are not built yet, in
    parallel. Returns seconds per compiled source (0 for reused ones);
    the compiler's resource report (``-Xptxas=-v``) is kept beside each
    library as ``<name>.log``. Raises with the compiler output if any
    build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for source in sources:
        target = library_path(source)
        if target.exists():
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC_DIR / source)]
        proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )
        jobs[source] = (proc, tmp, target, time.perf_counter())
    seconds = {s: 0.0 for s in sources}
    failures = []
    for source, (proc, tmp, target, start) in jobs.items():
        output, _ = proc.communicate()
        seconds[source] = time.perf_counter() - start
        target.with_suffix(".log").write_text(output)
        if proc.returncode != 0:
            os.unlink(tmp)
            failures.append(f"{source}:\n{output}")
        else:
            os.replace(tmp, target)
    if failures:
        raise RuntimeError("nvcc failed for " + "\n".join(failures))
    return seconds


def build_variants(source: str,
                   texts: dict[str, str]) -> dict[str, ctypes.CDLL]:
    """Compile edited copies of ``csrc/<source>`` (variant name -> source
    text) under ``build/kernels/variants/``, beside copies of the shared
    headers, one ``nvcc`` each, all at once; load them. For profiles that
    compile parts of a kernel out."""
    out_dir = BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    for header in CSRC_DIR.glob("*.cuh"):
        shutil.copy(header, out_dir / header.name)
    stem = Path(source).stem
    jobs = {}
    for name, text in texts.items():
        src = out_dir / f"{stem}_{name.replace('+', '_')}.cu"
        src.write_text(text)
        lib = src.with_suffix(".so")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(lib), str(src)]
        jobs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True),
                      lib)
    libs = {}
    for name, (proc, lib) in jobs.items():
        output, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for variant {name}:\n{output}")
        libs[name] = ctypes.CDLL(str(lib))
    return libs


def build_log(source: str) -> str:
    """The compiler output kept from the build of ``source``."""
    log = library_path(source).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def load(source: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<source>``, built first if needed."""
    if source not in _LIBRARIES:
        build([source])
        _LIBRARIES[source] = ctypes.CDLL(str(library_path(source)))
    return _LIBRARIES[source]
