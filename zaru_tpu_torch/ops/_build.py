"""Builds the port's CUDA kernels and loads them through ctypes.

Each ``zaru_tpu_torch/csrc/*.cu`` source is compiled by its own ``nvcc``
process (all started together) into a shared library with a plain C
interface::

    nvcc -gencode arch=compute_90a,code=sm_90a -O3 --fmad=false -shared \
        -Xcompiler -fPIC -o <name>_<hash>.so <name>.cu

``--fmad=false`` (and no ``--use_fast_math``) keeps every multiply and add
rounded on its own: the samplers' index maps reproduce an exact f32
operation order, and a contracted FMA moves pixels. The BlazeBlock stage
kernel, the BlazeBlock kernel, the bottleneck kernel and the entry block
kernel are held to their plain versions at a tolerance, and are built with
``--fmad=true``
(:data:`FMAD_ON`); the
stage kernel's two layouts are two sources that
include one header (``blaze_stage.cuh``), so their builds run side by side.
The libraries go into ``zaru_tpu_torch/_build/``, named by a hash of the
source, the headers (``csrc/*.cuh``) and the flags, so an edited source
rebuilds and an unchanged one is loaded as it is. The build runs at first
use, never when a module is imported.

The loaded libraries are the module's one piece of state.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import time
from pathlib import Path

from .. import profiling

__all__ = ["FMAD_ON", "NVCC_FLAGS", "SOURCES", "build_all", "flags", "library"]

_PACKAGE_DIR = Path(__file__).resolve().parent.parent
_CSRC = _PACKAGE_DIR / "csrc"
_BUILD_DIR = _PACKAGE_DIR / "_build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
]
# sources compared at a tolerance
FMAD_ON = frozenset({"blaze_block", "blaze_stage", "blaze_stage_nhwc", "bottleneck_stage", "entry_block"})
SOURCES = {p.stem: p for p in sorted(_CSRC.glob("*.cu"))}

_libs: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("the CUDA toolkit (nvcc) was not found; set CUDA_HOME")
    return str(Path(CUDA_HOME) / "bin" / "nvcc")


def flags(name: str) -> list[str]:
    """The ``nvcc`` flags of ``csrc/<name>.cu``."""
    return [*NVCC_FLAGS, f"--fmad={'true' if name in FMAD_ON else 'false'}"]


def _target(name: str) -> Path:
    h = hashlib.sha256(SOURCES[name].read_bytes())
    for header in sorted(_CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(flags(name)).encode())
    return _BUILD_DIR / f"{name}_{h.hexdigest()[:16]}.so"


def build_all() -> float:
    """Compiles every source that has no up-to-date library, one ``nvcc``
    per source in parallel (the span ``zaru.build.kernels``; each source
    built is counted in ``profiling.counters["kernel_builds"]``). Returns
    the seconds it took; raises with the compiler's output if any build
    fails."""
    t0 = time.perf_counter()
    _BUILD_DIR.mkdir(exist_ok=True)
    todo = [(name, so) for name, so in ((name, _target(name)) for name in SOURCES) if not so.exists()]
    if not todo:
        return time.perf_counter() - t0
    with profiling.span("zaru.build.kernels"):
        procs = []
        for name, so in todo:
            tmp = so.with_suffix(f".{os.getpid()}.tmp")
            cmd = [_nvcc(), *flags(name), "-o", str(tmp), str(SOURCES[name])]
            procs.append((name, so, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
            )))
        failed = []
        for name, so, tmp, proc in procs:
            out, _ = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"{name}.cu:\n{out}")
            else:
                os.replace(tmp, so)
                profiling.counters["kernel_builds"] += 1
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return time.perf_counter() - t0


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _libs.get(name)
    if lib is None:
        so = _target(name)
        if not so.exists():
            build_all()
        lib = _libs[name] = ctypes.CDLL(str(so))
    return lib
