"""Host-scoped keys for the port's built native libraries.

Counterpart of ``criteria3d_tpu/utils/jaxcache.py``. The working tree, and
with it ``criteria3d_tpu_torch/build/``, outlives the host that built into
it, so a library built by one toolchain for one machine must not be loaded
on another. Each library's file name carries a hash of its source, its
flags, its compiler's ``--version`` output and its target: the card's
compute capability for ``nvcc``, this host's CPU-flag fingerprint for
``g++``. A new key builds a new file; an unchanged key loads the old one.
"""

from __future__ import annotations

import hashlib
import os
import platform
import shutil
import subprocess
import tempfile

__all__ = ["machine_fingerprint", "compiler_version", "library_path", "nvcc",
           "build_cuda_library"]


def machine_fingerprint() -> str:
    """A short stable hash of this host's CPU feature flags (jaxcache's
    logic; the JAX and jaxlib versions it adds key XLA's AOT code, which a
    g++ build does not have)."""
    flags = ""
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith(("flags", "Features")):
                    flags = " ".join(sorted(line.split(":", 1)[1].split()))
                    break
    except OSError:
        pass
    if not flags:
        flags = f"{platform.machine()}|{platform.processor()}"
    return hashlib.sha1(flags.encode()).hexdigest()[:12]


def compiler_version(compiler: str) -> str:
    """The output of ``compiler --version``; RuntimeError naming the
    compiler when it cannot be run."""
    try:
        proc = subprocess.run([compiler, "--version"], capture_output=True,
                              text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise RuntimeError(f"{compiler}: {e}") from e
    if proc.returncode != 0:
        raise RuntimeError(f"{compiler} --version failed ({proc.returncode}): "
                           f"{proc.stderr.strip()}")
    return proc.stdout


def library_path(build_dir: str, stem: str, source: str, *key: str) -> str:
    """``build_dir/lib<stem>_<hash>.so``, the hash over the source file's
    bytes and every part of ``key`` (flags, compiler version, target)."""
    digest = hashlib.sha256()
    with open(source, "rb") as f:
        digest.update(f.read())
    for part in key:
        digest.update(b"\0" + part.encode())
    return os.path.join(build_dir, f"lib{stem}_{digest.hexdigest()[:16]}.so")


def nvcc() -> str:
    """The CUDA toolkit's ``nvcc``: on the PATH, else under PyTorch's
    ``CUDA_HOME``; RuntimeError when there is none."""
    from torch.utils.cpp_extension import CUDA_HOME
    found = shutil.which("nvcc")
    if found:
        return found
    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       "the port's CUDA sources")


def build_cuda_library(build_dir: str, stem: str, source: str, flags: tuple,
                       verbose: bool = False) -> str:
    """Compile ``source`` with ``nvcc flags`` into ``build_dir`` (once per
    source, flags, nvcc version and the card's compute capability: the file
    name carries their hash) and return the library's path; a failed
    compile raises with nvcc's output."""
    import torch
    compiler = nvcc()
    major, minor = torch.cuda.get_device_capability()
    path = library_path(build_dir, stem, source, " ".join(flags),
                        compiler_version(compiler), f"sm_{major}{minor}")
    if os.path.exists(path):
        return path
    os.makedirs(build_dir, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=build_dir)
    os.close(fd)
    cmd = [compiler, *flags, "-o", tmp, source]
    if verbose:
        cmd.insert(1, "-Xptxas=-v")
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {os.path.basename(source)} "
                               f"({proc.returncode}):\n{proc.stdout}\n{proc.stderr}")
        if verbose:
            print(proc.stdout + proc.stderr, end="")
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return path
