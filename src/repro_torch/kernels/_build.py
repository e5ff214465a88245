"""Build and bind the port's CUDA kernels.

The sources under ``csrc/`` are compiled by ``nvcc`` for ``sm_90a`` into
one shared library with a plain C interface, at first use, into
``build/`` beside this file (listed in ``.gitignore``). The library's
name carries a hash of the sources and flags, so an edited source is
rebuilt and a stale library is never loaded. Each ``.cu`` compiles in
its own ``nvcc`` process, all started together, and the objects are
linked once. Binding is by ``ctypes``: pointers and the stream go as
``c_void_p``, and each launch function returns ``cudaGetLastError()``,
which :func:`check` turns into an exception.

A missing ``nvcc`` or a failed compile raises; there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parent / "build"
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
COMPILE_FLAGS = ARCH + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                        "-Xptxas", "-v"]

_P, _I = ctypes.c_void_p, ctypes.c_int
SIGNATURES = {
    "decompress_maxsim_launch": ([_P] * 8 + [_I] * 6 + [_P], _I),
    "decompress_maxsim_smem_bytes": ([_I, _I], ctypes.c_size_t),
    "fused_rerank_launch": ([_P] * 10 + [_I] * 7 + [_P], _I),
    "fused_rerank_smem_bytes": ([_I, _I, _I], ctypes.c_size_t),
    "rt_error_string": ([_I], ctypes.c_char_p),
}

# most dynamic shared memory one block may use on Hopper
MAX_SMEM_BYTES = 232_448

_lock = threading.Lock()
_lib = None


def sources() -> list[pathlib.Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def library_path() -> pathlib.Path:
    h = hashlib.sha256(" ".join(COMPILE_FLAGS).encode())
    for src in sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"librepro_torch_{h.hexdigest()[:16]}.so"


def nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([pathlib.Path(home) / "bin" / "nvcc"] if home else []) + [
            pathlib.Path("/usr/local/cuda/bin/nvcc")]:
        if cand.is_file():
            return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on "
                           "PATH): the CUDA kernels cannot be built")
    return found


def _compile(out: pathlib.Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    exe = nvcc()
    tag = f"{out.stem}.{os.getpid()}.{threading.get_ident()}"
    cus = sorted(CSRC.glob("*.cu"))
    objs = [BUILD_DIR / f"{tag}.{cu.stem}.o" for cu in cus]
    procs = [subprocess.Popen([exe, *COMPILE_FLAGS, "-c", str(cu), "-o",
                               str(obj)], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for cu, obj in zip(cus, objs)]
    logs, failed = [], []
    for cu, p in zip(cus, procs):
        text, _ = p.communicate()
        logs.append(f"== nvcc {cu.name} (exit {p.returncode})\n{text}")
        if p.returncode != 0:
            failed.append(cu.name)
    log = out.with_suffix(".log")
    tmp = BUILD_DIR / f"{tag}.so"
    try:
        if not failed:
            link = subprocess.run([exe, *ARCH, "-shared", "-o", str(tmp),
                                   *map(str, objs)], capture_output=True,
                                  text=True)
            logs.append(f"== link (exit {link.returncode})\n"
                        f"{link.stdout}{link.stderr}")
            if link.returncode != 0:
                failed.append("link")
        log.write_text("\n".join(logs))
        if failed:
            raise RuntimeError(f"CUDA kernel build failed ({failed}); "
                               f"see {log}:\n" + "\n".join(logs)[-6000:])
        os.replace(tmp, out)     # atomic: concurrent builders never
    finally:                     # load a half-written library
        for f in objs + [tmp]:
            f.unlink(missing_ok=True)


def load() -> ctypes.CDLL:
    """The kernel library, built first if this source hash has none."""
    global _lib
    with _lock:
        if _lib is None:
            path = library_path()
            if not path.is_file():
                _compile(path)
            lib = ctypes.CDLL(str(path))
            for name, (argtypes, restype) in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = restype
            _lib = lib
        return _lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    if err != 0:
        msg = lib.rt_error_string(err).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {err} "
                           f"({msg})")


_count_lock = threading.Lock()


def count_launch(wrapper) -> None:
    """Add one to ``wrapper.launches`` (the plain-integer launch count a
    run reads to show that its path went through the kernel)."""
    with _count_lock:
        wrapper.launches += 1
