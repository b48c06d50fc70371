"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each `csrc/<name>.cu` has a plain C interface and is compiled, at first use,
into `flashfry_tpu_torch/_build/lib<name>-<hash>.so`, where the hash covers
the sources and the compiler flags: an unchanged tree reuses the library, an
edited one rebuilds. Only the sources in the package are used, and a failed
build raises with the compiler's output. The ptxas report (registers,
shared memory, spills) is kept beside the library as `<lib>.log`.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def nvcc_path() -> str:
    """nvcc of the CUDA toolkit PyTorch finds (CUDA_HOME, CUDA_PATH, PATH,
    or the default install location)."""
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found: set CUDA_HOME to the "
                           "directory that holds bin/nvcc")
    nvcc = os.path.join(CUDA_HOME, "bin", "nvcc")
    if not os.path.isfile(nvcc):
        raise RuntimeError("nvcc not found at %s" % nvcc)
    return nvcc


def library_path(name: str) -> Path:
    """Where csrc/<name>.cu builds to; the name carries a hash of the
    sources (every .cu/.cuh in csrc) and of NVCC_FLAGS."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC_DIR.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / ("lib%s-%s.so" % (name, h.hexdigest()[:16]))


def build(name: str) -> Path:
    """Compile csrc/<name>.cu unless its library already exists; returns the
    library's path. Raises RuntimeError when nvcc fails."""
    out = library_path(name)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, str(CSRC_DIR / ("%s.cu" % name))]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError("nvcc failed (exit %d): %s\n%s%s"
                           % (proc.returncode, " ".join(cmd), proc.stdout,
                              proc.stderr))
    Path(str(out) + ".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, out)  # atomic: a concurrent build sees all or nothing
    return out


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load csrc/<name>.cu's library."""
    return ctypes.CDLL(str(build(name)))


def stage1_library() -> ctypes.CDLL:
    lib = load("stage1")
    fn = lib.ff_stage1_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def descriptors_library() -> ctypes.CDLL:
    """csrc/descriptors.cu: the mismatch descriptors of off-target scoring."""
    lib = load("descriptors")
    p, i = ctypes.c_void_p, ctypes.c_int
    fn = lib.ff_descriptors_launch
    # (lo, hi, gi, gcodes, guide words, n, n_guides, L, act_n, w0, w1, stream)
    fn.argtypes = [p, p, p, p, p, ctypes.c_longlong, i, i, i, p, p, p]
    fn.restype = ctypes.c_int
    return lib


def stage1_variants_library() -> ctypes.CDLL:
    """csrc/stage1_variants.cu: the experiment tool's X1-X6."""
    lib = load("stage1_variants")
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for fn, extra in ((lib.ff_v1_gloop_launch, []),
                      (lib.ff_v3_int16_launch, []),
                      (lib.ff_v6_bf16out_launch, []),
                      (lib.ff_v5_tile_launch, [i]),
                      (lib.ff_expanded_launch, [i])):
        # (src, n, guides, g_rows, thr, [t_tile | mode], out, stream)
        fn.argtypes = [p, ll, p, i, i, *extra, p, p]
        fn.restype = ctypes.c_int
    return lib


def planes_library() -> ctypes.CDLL:
    """csrc/planes.cu: the plane build's expand of packed target words."""
    lib = load("planes")
    p, ll = ctypes.c_void_p, ctypes.c_longlong
    fn = lib.ff_expand_launch
    # (words, n, L, out, stride, start, stream)
    fn.argtypes = [p, ll, ctypes.c_int, p, ll, ll, p]
    fn.restype = ctypes.c_int
    return lib
