"""Build and load the package's CUDA kernels.

Each kernel library is one ``nvcc`` invocation over ``csrc/<name>.cu``
into a shared library with a plain C interface, loaded with ``ctypes``
(pointers and the stream travel as ``c_void_p``).  The library lands in
``nutpie_tpu_torch/_build/`` under a name that carries the hash of every
source in ``csrc/`` and of the flags, so an edited source rebuilds and an
unchanged one loads at once.  Nothing here runs when the package is
imported: the first call that needs a kernel builds it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
# nvcc contracts a*b+c into FMA by default; appending "-fmad=false" here
# gives a build whose rounding differs, which tells a rounding difference
# against the plain version from a semantic one
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-lineinfo")
# the step kernel is bound by bytes, so contraction buys it nothing; built
# without it, it rounds each product and sum as its plain version does,
# and in float64 follows it to the rounding of its sums, even through the
# warmup's adaptation, which amplifies any difference
KERNEL_FLAGS = {"step_kernel": ("-fmad=false",)}

_LOADED: dict = {}


def _nvcc() -> str:
    for cand in (os.environ.get("NVCC"), shutil.which("nvcc"),
                 "/usr/local/cuda/bin/nvcc"):
        if cand and Path(cand).exists():
            return cand
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build kernels")


def _source_hash() -> str:
    h = hashlib.sha256()
    for path in sorted(CSRC.glob("*")):
        if path.suffix in (".cu", ".cuh", ".h"):
            h.update(path.name.encode())
            h.update(path.read_bytes())
    h.update(" ".join(FLAGS).encode())
    h.update(repr(sorted(KERNEL_FLAGS.items())).encode())
    return h.hexdigest()[:16]


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless an up-to-date library exists."""
    return build_all([name])[name]


def build_all(names) -> dict:
    """Compile every ``csrc/<name>.cu`` that lacks an up-to-date library,
    one ``nvcc`` per source, all started together; ``{name: library}``."""
    digest = _source_hash()
    outs = {name: BUILD_DIR / f"lib{name}-{digest}.so" for name in names}
    procs = {}
    for name, out in outs.items():
        if out.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *FLAGS, *KERNEL_FLAGS.get(name, ()), "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.PIPE, text=True), tmp)
    failed = []
    for name, (proc, tmp) in procs.items():
        stdout, stderr = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {name}.cu ({proc.returncode}):\n"
                          f"{stdout}\n{stderr}")
        else:
            os.replace(tmp, outs[name])
    if failed:
        raise RuntimeError("\n".join(failed))
    return outs


def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load the library once per process."""
    lib = _LOADED.get(name)
    if lib is None:
        lib = _LOADED[name] = ctypes.CDLL(str(build(name)))
    return lib
