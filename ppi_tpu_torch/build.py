"""Build and load the port's hand-written kernels (``csrc/*.cu``).

Each kernel source is compiled at first use, with ``nvcc`` for ``sm_90a``
(or as host C with ``cc``, for the CPU tests' check of a kernel's C body),
into ``build/kernels/<hash of sources and flags>/`` and bound with
``ctypes`` through a plain C interface. A build is keyed by the source, the
generated headers written beside it and the flags, so a changed source or
header never reuses a stale library. The compiler's messages (with
``-Xptxas -v``: registers, shared memory and spills) are kept beside the
library in ``build.log``.

``LAUNCHES`` counts each kernel's launches in this process: every wrapper
adds one where it launches its kernel, and a run resets it to check that
its main path went through the kernels.
"""

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[1] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
HOST_CC_FLAGS = ("-x", "c", "-std=c99", "-O2", "-ffp-contract=off",
                 "-shared", "-fPIC")
# per-source nvcc flags. The rollout, ball-in-a-cup and palm-IK kernels
# round every operation of the scalar program once, as their plain
# versions' eager torch ops do: no FMA contraction. pen-v0's dynamics grow a 1e-7 difference in
# the state to 1e-2 within 20 control steps, so contraction alone moved the
# kernel that far from its plain version.
SOURCE_NVCC_FLAGS = {"rollout.cu": ("-fmad=false",),
                     "rollout_warp.cu": ("-fmad=false",),
                     "rollout_split.cu": ("-fmad=false",),
                     "bic_rollout.cu": ("-fmad=false",),
                     "bic_rollout_warp.cu": ("-fmad=false",),
                     "ik_palm.cu": ("-fmad=false",)}

# kernel name -> launches in this process
LAUNCHES = collections.Counter()


def _compiler(name: str, fallback: str) -> str:
    path = shutil.which(name) or (fallback if os.path.exists(fallback)
                                  else None)
    if path is None:
        raise RuntimeError(f"{name} not found: the kernels are built from "
                           "source at first use")
    return path


def build_library(source: str, headers=None, host: bool = False) -> Path:
    """Compile ``csrc/<source>`` into a shared library, once per distinct
    (source, headers, flags); returns its path.

    ``headers`` maps file names to generated text written beside the
    source (for example the rollout kernel's ``env_body.h``). ``host=True``
    compiles the file as host C with ``cc``; otherwise ``nvcc`` builds the
    CUDA kernel for sm_90a."""
    headers = dict(headers or {})
    text = (CSRC / source).read_text()
    flags = HOST_CC_FLAGS if host else NVCC_FLAGS + SOURCE_NVCC_FLAGS.get(
        source, ())
    parts = [source, text, " ".join(flags), "host" if host else "cuda"]
    for name in sorted(headers):
        parts += [name, headers[name]]
    key = hashlib.sha256("\0".join(parts).encode()).hexdigest()[:16]
    out_dir = BUILD_ROOT / key
    stem = Path(source).stem
    lib = out_dir / (f"{stem}_host.so" if host else f"{stem}.so")
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    for name, body in headers.items():
        (out_dir / name).write_text(body)
    src = out_dir / source
    src.write_text(text)
    # a temporary of this process and thread: two threads may build the
    # same key at once
    tmp = out_dir / f".{lib.name}.{os.getpid()}.{threading.get_ident()}"
    if host:
        cmd = [_compiler("cc", "/usr/bin/cc"), *flags, "-I", str(out_dir),
               "-o", str(tmp), str(src), "-lm"]
    else:
        cmd = [_compiler("nvcc", "/usr/local/cuda/bin/nvcc"), *flags,
               "-I", str(out_dir), "-o", str(tmp), str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    (out_dir / "build.log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"kernel build failed ({' '.join(cmd)}):\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib)  # atomic: a concurrent build never sees half a file
    return lib


_FUNCTIONS = {}  # (library path, symbol) -> ctypes function, once per process


def load_function(lib: Path, symbol: str, n_pointers: int, n_ints: int,
                  stream: bool):
    """The C function ``symbol`` of ``lib``, taking ``n_pointers`` pointers,
    then ``n_ints`` ints, then (``stream``) a ``cudaStream_t``, and
    returning an int error code."""
    if (lib, symbol) not in _FUNCTIONS:
        fn = getattr(ctypes.CDLL(str(lib)), symbol)
        fn.argtypes = ([ctypes.c_void_p] * n_pointers + [ctypes.c_int] * n_ints
                       + ([ctypes.c_void_p] if stream else []))
        fn.restype = ctypes.c_int
        _FUNCTIONS[(lib, symbol)] = fn
    return _FUNCTIONS[(lib, symbol)]
