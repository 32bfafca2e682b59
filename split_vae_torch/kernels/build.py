"""Builds the CUDA sources under csrc/ into shared libraries, at first use.

Each kernel module has one source, ``csrc/<name>.cu``, with a plain C
interface; nvcc compiles it for sm_90a into ``build/<name>_<digest>.so`` at
the repository root, where ``digest`` covers the source and the headers it
may include, so an edit rebuilds and an unchanged source is reused. The
compiler's report (registers, shared memory and spills of each kernel, from
``-Xptxas -v``) is kept beside the library as ``<name>_<digest>.log``.
``build_all`` starts one nvcc for each source at once. Also here: what every
wrapper needs to hand a tensor to such a library.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import tempfile
from typing import Dict, Optional, Tuple

import torch

_PACKAGE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC = os.path.join(_PACKAGE, "csrc")
_BUILD_DIR = os.path.join(os.path.dirname(_PACKAGE), "build")
_HEADERS = ("paste_taps.cuh", "philox.cuh")
NAMES = ("render", "crop", "render_windowed")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the kernels need the CUDA toolkit")


def library_path(name: str) -> str:
    """Where the library of csrc/<name>.cu goes, by the content of its sources."""
    sha = hashlib.sha256()
    for f in (f"{name}.cu",) + _HEADERS:
        with open(os.path.join(_CSRC, f), "rb") as fh:
            sha.update(fh.read())
    return os.path.join(_BUILD_DIR, f"{name}_{sha.hexdigest()[:16]}.so")


def _start(name: str) -> Tuple[str, Optional[str], Optional[subprocess.Popen]]:
    out = library_path(name)
    if os.path.exists(out):
        return out, None, None
    os.makedirs(_BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
           "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC", "-o", tmp,
           os.path.join(_CSRC, f"{name}.cu")]
    return out, tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                      text=True)


def _finish(name: str, out: str, tmp: Optional[str], proc: Optional[subprocess.Popen]) -> str:
    if proc is None:
        return out
    _, stderr = proc.communicate()
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed on {name}.cu ({proc.returncode}):\n{stderr}")
    with open(out[:-3] + ".log", "w") as f:
        f.write(stderr)
    os.replace(tmp, out)
    return out


def build(name: str) -> str:
    """Compiles csrc/<name>.cu (once per source content); returns the .so path."""
    return _finish(name, *_start(name))


def build_all() -> Dict[str, str]:
    """Compiles every source, the compilers running side by side; {name: .so path}."""
    started = [(name, _start(name)) for name in NAMES]
    done, errors = {}, []
    for name, job in started:  # wait for every compiler, also after a failure
        try:
            done[name] = _finish(name, *job)
        except RuntimeError as e:
            errors.append(e)
    if errors:
        raise errors[0]
    return done


def stream_of(t: torch.Tensor) -> int:
    """The current CUDA stream of t's device, as the integer a C function takes."""
    return torch.cuda.current_stream(t.device).cuda_stream


def check_tensor(t: torch.Tensor, dtype, name: str) -> None:
    """Raises unless t is what the kernels take: contiguous, on a GPU, of dtype."""
    if not t.is_cuda or t.dtype != dtype or not t.is_contiguous():
        raise ValueError(f"{name}: need a contiguous CUDA {dtype} tensor, got "
                         f"{t.dtype} on {t.device} (contiguous={t.is_contiguous()})")
