"""Build the port's CUDA sources with ``nvcc`` at first use; load with ctypes.

Every ``csrc/*.cu`` compiles on its own into a shared library with a plain C
interface (no PyTorch headers, so a build takes seconds, not minutes), all
sources at once in parallel. Libraries go to ``build/repro_torch_kernels/``
at the root of the checkout, named by a hash of the source, the headers in
``csrc/`` and the source's flags: a source is rebuilt only when that hash
changes. ``hedm_reduce`` alone builds with ``--fmad=false``, which its
bit-exactness needs; the other kernels build with contraction on.
Each build writes the compiler's output (``-Xptxas=-v``: registers, shared
memory, spills) beside the library as ``<name>-<hash>.log``.

Nothing here runs at import time: the CPU tests import every module, and
this machine class has no ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Callable, Dict, Sequence, Tuple

from torch._subclasses.fake_tensor import FakeTensor
from torch.utils._python_dispatch import _get_current_dispatch_mode

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")
SOURCE_FLAGS: Dict[str, Tuple[str, ...]] = {"hedm_reduce": ("--fmad=false",)}

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def nvcc() -> str:
    """Path of ``nvcc``: under PyTorch's ``CUDA_HOME``, else on ``PATH``."""
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME:
        path = Path(CUDA_HOME) / "bin" / "nvcc"
        if path.exists():
            return str(path)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA toolkit is needed to "
                           "build the port's kernels")
    return found


def flags(name: str) -> Tuple[str, ...]:
    """The nvcc flags of ``csrc/<name>.cu``."""
    return NVCC_FLAGS + SOURCE_FLAGS.get(name, ())


def library_path(name: str) -> Path:
    """Where the library built from ``csrc/<name>.cu`` lives."""
    h = hashlib.sha256(" ".join(flags(name)).encode())
    for p in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build_all() -> Dict[str, Path]:
    """Build every stale ``csrc/*.cu``, one ``nvcc`` per source, all started
    together. Returns ``{name: library path}``; raises ``RuntimeError`` with
    the compiler's output when a build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    targets = {src.stem: library_path(src.stem)
               for src in sorted(CSRC.glob("*.cu"))}
    stale = {name: t for name, t in targets.items() if not t.exists()}
    if not stale:
        return targets
    compiler = nvcc()
    procs = {}
    for name, target in stale.items():
        tmp = target.with_name(f"{target.stem}.{os.getpid()}.tmp.so")
        with open(target.with_suffix(".log"), "w") as log:
            procs[name] = (subprocess.Popen(
                [compiler, *flags(name), "-o", str(tmp),
                 str(CSRC / f"{name}.cu")],
                stdout=log, stderr=subprocess.STDOUT), tmp)
    failed = []
    for name, (proc, tmp) in procs.items():
        rc = proc.wait()
        if rc == 0:
            os.replace(tmp, targets[name])
        else:
            failed.append(f"{name} (nvcc exit {rc}):\n"
                          + targets[name].with_suffix(".log").read_text())
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return targets


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if stale."""
    with _LOCK:
        if name not in _LIBS:
            path = library_path(name)
            if not path.exists():
                build_all()
            _LIBS[name] = ctypes.CDLL(str(path))
        return _LIBS[name]


def bind(name: str, symbol: str, argtypes: Sequence,
         restype=ctypes.c_int) -> Callable:
    """The C function ``symbol`` of ``csrc/<name>.cu``, typed."""
    fn = getattr(load(name), symbol)
    fn.argtypes = list(argtypes)
    fn.restype = restype
    return fn


def refuse_grad(name: str, *inputs) -> None:
    """Raise ``RuntimeError`` when grad mode is on and an input of the CUDA
    kernel ``name`` requires grad. The kernels have no backward and are
    called through ctypes, so autograd would record nothing: the output
    would carry no ``grad_fn`` and the gradient would be silently wrong.
    Training takes the plain mixers instead (``use_kernels=False``)."""
    import torch
    if torch.is_grad_enabled() and any(t.requires_grad for t in inputs):
        raise RuntimeError(
            f"{name} has no backward: a CUDA input requires grad. Call it "
            f"under torch.no_grad(), or train through the models' plain "
            f"mixers (use_kernels=False), as loss_fn does")


def traced(*inputs) -> bool:
    """Whether a kernel's call on ``inputs`` is traced rather than run: a
    fake tensor among them, or a dispatch mode (``FakeTensorMode``,
    ``FlopCounterMode``, `repro_torch.distributed.op_cost.OpCost`) active.
    Such a call goes through the kernel's dispatcher op, which the modes
    see; any other calls the launch directly, as the op's dispatch costs
    tens of microseconds a call on the host."""
    return (_get_current_dispatch_mode() is not None
            or any(isinstance(t, FakeTensor) for t in inputs))


def check(name: str, err: int) -> None:
    """Raise ``RuntimeError`` when a launch of ``csrc/<name>.cu`` returned a
    CUDA error (the library's ``<name>_error_string`` names it)."""
    if err:
        msg = bind(name, f"{name}_error_string", [ctypes.c_int],
                   ctypes.c_char_p)(err).decode()
        raise RuntimeError(f"{name} launch failed: CUDA error {err} ({msg})")
