"""The one seam between the port's kernel wrappers and their CUDA sources:
build with ``nvcc`` at first use, load with ctypes, then bind, launch,
check, count and register every hand-written kernel.

Every ``csrc/*.cu`` compiles on its own into a shared library with a plain C
interface (no PyTorch headers, so a build takes seconds, not minutes), all
sources at once in parallel. Libraries go to ``build/repro_torch_kernels/``
at the root of the checkout, named by a hash of the source, the headers in
``csrc/`` and the source's flags: a source is rebuilt only when that hash
changes. ``hedm_reduce`` and ``hedm_label`` build with ``--fmad=false``,
which their bit-exactness needs; the other kernels build with contraction
on.
Each build writes the compiler's output (``-Xptxas=-v``: registers, shared
memory, spills) beside the library as ``<name>-<hash>.log``.

A wrapper (``hedm_reduce``, ``flash_attention``, ``mamba2_scan``,
``rwkv6_wkv``, ``hedm_label``, ``mla_decode``) keeps its checks and
limits, its plain version (``reference``), its dispatch rule, its FLOP
count and the order in which it packs pointers and sizes. The rest is
here, once:

* :func:`on_card` is the device prologue: a CPU input runs the plain
  version, a CUDA input must be contiguous, any other device raises.
* :class:`Library` declares the C functions a wrapper calls, each with its
  ctypes argument types (the stream's handle appended), binds each at first use
  and caches it. :meth:`Library.launch` makes one call into the library
  under the device's guard on its current stream, raises through
  :func:`check` on a CUDA error and counts the call in the public
  function's ``launches`` (and ``launches_tc`` for a tensor-core kernel).
* :func:`op` makes a wrapper's launch function (the place that launches and
  counts) the dispatcher op ``repro_torch::<name>``
  (``torch.library.custom_op``): its fake implementation gives the outputs'
  shapes on fake tensors and its registered FLOP formula the wrapper's
  count, so `repro_torch.launch.dryrun` and
  `repro_torch.distributed.op_cost.OpCost` trace the card's program with no
  build and no launch. Only a traced call (:func:`traced`: a fake tensor,
  or a dispatch mode) goes through the op; any other calls the launch
  function directly, as the op's dispatch costs tens of microseconds a call
  on the host.

Nothing here builds or loads at import time: the CPU tests import every
module, and this machine class has no ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.utils._python_dispatch import (_disable_current_modes,
                                          _get_current_dispatch_mode)
from torch.utils.flop_counter import register_flop_formula

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")
SOURCE_FLAGS: Dict[str, Tuple[str, ...]] = {"hedm_reduce": ("--fmad=false",),
                                            "hedm_label": ("--fmad=false",)}

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
    if torch.is_grad_enabled() and any(t.requires_grad for t in inputs):
        raise RuntimeError(
            f"{name} has no backward: a CUDA input requires grad. Call it "
            f"under torch.no_grad(), or train through the models' plain "
            f"mixers (use_kernels=False), as loss_fn does")


#: types whose instances are never fake tensors: :func:`traced` skips the
#: slower ``isinstance`` for them, as it runs on every launch
_NEVER_FAKE = frozenset((torch.Tensor, bool, int, float))


def traced(*inputs) -> bool:
    """Whether a kernel's call on ``inputs`` is traced rather than run: a
    fake tensor among them, or a dispatch mode (``FakeTensorMode``,
    ``FlopCounterMode``, `repro_torch.distributed.op_cost.OpCost`) active.
    Such a call goes through the kernel's dispatcher op, which the modes
    see; any other calls the launch directly, as the op's dispatch costs
    tens of microseconds a call on the host."""
    if _get_current_dispatch_mode() is not None:
        return True
    for t in inputs:
        if type(t) not in _NEVER_FAKE and isinstance(t, FakeTensor):
            return True
    return False


def check(name: str, err: int) -> None:
    """Raise ``RuntimeError`` when a launch of ``csrc/<name>.cu`` returned a
    CUDA error (the library's ``<name>_error_string`` names it)."""
    if err:
        msg = bind(name, f"{name}_error_string", [ctypes.c_int],
                   ctypes.c_char_p)(err).decode()
        raise RuntimeError(f"{name} launch failed: CUDA error {err} ({msg})")


def on_card(name: str, *inputs) -> bool:
    """Whether the kernel ``name`` runs on ``inputs`` (one device, which the
    wrapper has checked): False on the CPU, where the wrapper runs its plain
    version; True for contiguous CUDA tensors. Any other device, or a
    non-contiguous CUDA tensor, raises ``ValueError``."""
    first = inputs[0]
    if first.is_cpu:
        return False
    if not first.is_cuda:
        raise ValueError(f"unsupported device {first.device}")
    for t in inputs:
        if not t.is_contiguous():
            raise ValueError(f"{name} needs contiguous inputs")
    return True


class Library:
    """The C functions of ``csrc/<name>.cu`` that a wrapper calls. ``args``
    maps each symbol to its ctypes argument types up to the last, the
    stream's handle, which :meth:`launch` appends. ``counts`` is the
    wrapper's public function: its ``launches`` counts the calls and, where
    the library has a tensor-core kernel (``tc``, its symbol),
    ``launches_tc`` counts the calls of that one."""

    def __init__(self, name: str, args: Dict[str, Sequence],
                 counts: Callable, tc: Optional[str] = None):
        self.name, self.args, self.counts, self.tc = name, args, counts, tc
        self._functions: Dict[str, Callable] = {}
        counts.launches = 0
        if tc is not None:
            counts.launches_tc = 0

    def function(self, symbol: str) -> Callable:
        """The C function ``symbol``, bound with its types at first use."""
        fn = self._functions.get(symbol)
        if fn is None:
            fn = self._functions[symbol] = bind(
                self.name, symbol, [*self.args[symbol], ctypes.c_void_p])
        return fn

    def launch(self, symbol: str, device, *args) -> None:
        """One call of ``symbol`` on ``args`` and the current stream of
        ``device``, under its device guard: ``RuntimeError`` on a CUDA
        error, else the call counted."""
        fn = self._functions.get(symbol) or self.function(symbol)
        with torch.cuda.device(device):
            err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
        check(self.name, err)
        self.counts.launches += 1
        if symbol == self.tc:
            self.counts.launches_tc += 1


def op(name: str, schema: str, launch: Callable, fake: Callable,
       flops: Callable, raw: bool = False) -> Callable:
    """Register ``launch`` as the dispatcher op ``repro_torch::<name>`` of
    ``schema``, with ``fake`` as its fake implementation and ``flops`` as
    its FLOP formula: ``flops`` takes the schema's arguments with each
    tensor replaced by its shape or, with ``raw``, the tensors themselves
    (for work that depends on their values; it runs with no dispatch mode
    active, so the modes do not count what it computes). Returns the
    wrapper's entry, which takes the schema's arguments: the op when
    :func:`traced` says the call is traced, else ``launch`` itself."""
    custom = torch.library.custom_op(f"repro_torch::{name}", launch,
                                     mutates_args=(), schema=schema)
    custom.register_fake(fake)
    if raw:
        def formula(*args, out_val=None, **kwargs):
            with _disable_current_modes():
                return flops(*args, **kwargs)
    else:
        def formula(*args, out_shape=None, **kwargs):
            return flops(*args, **kwargs)
    register_flop_formula(getattr(torch.ops.repro_torch, name),
                          get_raw=raw)(formula)

    def run(*args):
        return (custom if traced(*args) else launch)(*args)
    return run
