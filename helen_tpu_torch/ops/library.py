"""The bottom of the ops layer: the kernel library, the declaration of its
entry points, the checked-argument helpers every kernel family uses, and the
card's limits. It imports no other module of ``ops``.

Hand-written CUDA kernels (``ops/csrc/*.cu``, compiled with nvcc for
``sm_90a`` into one shared library with a C ABI and loaded with ctypes)
carry every bi-GRU window. The library builds at first use
(:func:`build_kernels`), from the sources in ``ops/csrc``, into
``utils.build.build_dir("kernels")`` under a name keyed on a hash of the
sources and flags, so a fresh checkout builds it by itself. A failed build
raises with nvcc's stderr.

Each kernel family (one module of ``ops``) declares its own C entries: a
table ``ENTRIES`` of each name's ``restype`` and ``argtypes``, and where
the family has one, ``check_fit(lib)``, which holds its Python fit rules
to the C ones and raises where they disagree. The family hands both to
:func:`register` when it is imported; registering builds and loads
nothing. :func:`get_lib` loads the library once and applies every
registered table and check to it; a family registered later has them
applied at once. A launch calls :func:`get_lib` (one unlocked check once
loaded) and the entry, and maps a nonzero return through
:func:`raise_on`.

A tool that times variants of a source loads each build with
:func:`load_variant` (the tables' entries that build holds declared, no
fit checked) and launches the wrappers into it inside
:func:`launching_into`.
"""
from __future__ import annotations

import contextlib
import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
from ctypes import c_char_p, c_int
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch

Layer = Dict[str, Dict[str, torch.Tensor]]
Outputs = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]
#: a family's C entries: name -> (restype, argtypes)
Entries = Dict[str, Tuple[type, Sequence[type]]]

#: one direction's params, in the order the kernel library takes them
KEYS = ("w_ih", "w_hh", "b_ih", "b_hh")

#: the kernels' sources
CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
_ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
#: nvcc flags of each source's object; the library links them with -shared
NVCC_FLAGS = (*_ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def nvcc() -> str:
    """The nvcc to build with: on PATH, else under ``$CUDA_HOME/bin``."""
    found = shutil.which("nvcc")
    if found:
        return found
    cand = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin): the CUDA window "
                       "kernels build from source at first use")


def build_kernels() -> str:
    """Compile ``ops/csrc/*.cu`` into the kernel library unless a build of
    these exact sources exists; returns its path. Each source compiles in
    its own nvcc process, all started together, then one nvcc links the
    objects. nvcc's ``-Xptxas -v`` reports (registers, shared memory,
    spills) are kept beside the library as ``<library>.log``."""
    from helen_tpu_torch.utils.build import build_dir

    sources = sorted(glob.glob(os.path.join(CSRC, "*.cu"))
                     + glob.glob(os.path.join(CSRC, "*.cuh")))
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sources:
        with open(path, "rb") as f:
            digest.update(f.read())
    so = os.path.join(build_dir("kernels"),
                      f"libgru_window-{digest.hexdigest()[:16]}.so")
    if os.path.exists(so):
        return so
    tmp = f"{so}.tmp{os.getpid()}"
    compiler = nvcc()
    objs, procs = [], []
    for src in (s for s in sources if s.endswith(".cu")):
        obj = f"{tmp}.{os.path.basename(src)}.o"
        cmd = [compiler, *NVCC_FLAGS, "-c", "-o", obj, src]
        objs.append(obj)
        procs.append((cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.PIPE, text=True)))
    log, failed = [], None
    for cmd, proc in procs:
        out, err = proc.communicate()
        log.append(f"$ {' '.join(cmd)}\n{out}{err}")
        if proc.returncode != 0 and failed is None:
            failed = f"nvcc failed (exit {proc.returncode}): {' '.join(cmd)}\n{err}"
    if failed is None:
        cmd = [compiler, *_ARCH, "-shared", "-o", tmp, *objs]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            failed = (f"nvcc link failed (exit {proc.returncode}): {' '.join(cmd)}\n"
                      f"{proc.stderr}")
    for obj in objs:
        if os.path.exists(obj):
            os.remove(obj)
    if failed is not None:
        raise RuntimeError(failed)
    with open(so + ".log", "w") as f:
        f.write("\n".join(log))
    os.replace(tmp, so)
    return so


# ---------------------------------------------------------------------------
# the entry points: each family's table and fit check, applied once per
# library loaded
# ---------------------------------------------------------------------------

#: the library's own entries: the error strings and the card's queries
ENTRIES: Entries = {
    "gru_window_error_string": (c_char_p, [c_int]),
    "gru_window_smem_optin": (c_int, []),
    "gru_window_sm_count": (c_int, []),
}

_lock = threading.Lock()
#: the library launches go to (the shipped one, or a variant in launching_into)
_lib: Optional[ctypes.CDLL] = None
#: the shipped library once loaded, its every registered family declared
_shipped: Optional[ctypes.CDLL] = None
_families = [(ENTRIES, None)]


def _declare(lib: ctypes.CDLL, entries: Entries) -> None:
    for name, (restype, argtypes) in entries.items():
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = restype, argtypes


def register(entries: Entries, check_fit: Optional[Callable[[ctypes.CDLL], None]] = None
             ) -> None:
    """Declare a family's C entries and its fit check on every library
    loaded: on the loaded one now, if there is one, else at the load."""
    with _lock:
        _families.append((entries, check_fit))
        if _shipped is not None:
            _declare(_shipped, entries)
            if check_fit is not None:
                check_fit(_shipped)


def _load() -> ctypes.CDLL:
    global _lib, _shipped
    with _lock:
        if _shipped is None:
            lib = ctypes.CDLL(build_kernels())
            for entries, check_fit in _families:
                _declare(lib, entries)
                if check_fit is not None:
                    check_fit(lib)
            _shipped = _lib = lib
        return _lib


def get_lib() -> ctypes.CDLL:
    """The loaded kernel library (built first if needed), every registered
    family's entries declared and fits checked."""
    lib = _lib
    return lib if lib is not None else _load()


def raise_on(err: int, name: str) -> None:
    """Raise on a nonzero return of the entry ``name``, with CUDA's message."""
    if err != 0:
        lib = _shipped if _shipped is not None else get_lib()
        msg = lib.gru_window_error_string(err).decode()
        raise RuntimeError(f"{name} launch failed: CUDA error {err} ({msg})")


def load_variant(path: str, *tables: Entries) -> ctypes.CDLL:
    """A tool's build of some of ``ops/csrc`` (a variant of a source): the
    entries of ``tables`` that it holds declared, no fit checked (a variant
    may change the constants the checks hold)."""
    lib = ctypes.CDLL(path)
    for entries in tables:
        _declare(lib, {n: e for n, e in entries.items() if hasattr(lib, n)})
    return lib


@contextlib.contextmanager
def launching_into(variant: ctypes.CDLL):
    """Every wrapper launches into ``variant`` while the block runs; a failed
    launch is named through the shipped library's error strings."""
    global _lib
    shipped = get_lib()
    with _lock:
        _lib = variant
    try:
        yield variant
    finally:
        with _lock:
            _lib = shipped


# ---------------------------------------------------------------------------
# checked arguments
# ---------------------------------------------------------------------------

def check(name: str, t: torch.Tensor, shape, dtype, device) -> None:
    """Raise unless ``t`` is a contiguous ``dtype`` tensor of ``shape`` on
    ``device``."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def cuda_device(t: torch.Tensor, name: str) -> torch.device:
    """``t``'s device, which must be a CUDA one."""
    if t.device.type != "cuda":
        raise ValueError(f"{name} runs on CUDA or CPU tensors, got {t.device}")
    return t.device


def layer_args(layer: Layer, D: int, H: int, device, wdtype=torch.float32) -> list:
    """Checked pointers of both directions' ``[w_ih, w_hh, b_ih, b_hh]``:
    weights of ``wdtype`` (float32, or bf16 for the fast tier), biases
    float32."""
    args = []
    for d in ("fwd", "bwd"):
        prm = layer[d]
        check(f"{d}.w_ih", prm["w_ih"], (D, 3 * H), wdtype, device)
        check(f"{d}.w_hh", prm["w_hh"], (H, 3 * H), wdtype, device)
        check(f"{d}.b_ih", prm["b_ih"], (3 * H,), torch.float32, device)
        check(f"{d}.b_hh", prm["b_hh"], (3 * H,), torch.float32, device)
        args += [prm[k].data_ptr() for k in KEYS]
    return args


def empty(dev, *shape) -> torch.Tensor:
    """A new float32 tensor of ``shape`` on ``dev``."""
    return torch.empty(shape, dtype=torch.float32, device=dev)


def outputs(T: int, B: int, H: int, dev) -> Outputs:
    """A window layer's new outputs: ``out_f``, ``out_b`` ``(T, B, H)``,
    ``h_f``, ``h_b`` ``(B, H)``, float32."""
    return empty(dev, T, B, H), empty(dev, T, B, H), empty(dev, B, H), empty(dev, B, H)


def stream(dev) -> int:
    """The handle of ``dev``'s current CUDA stream."""
    return torch.cuda.current_stream(dev).cuda_stream


# ---------------------------------------------------------------------------
# the card's limits
# ---------------------------------------------------------------------------

#: the dynamic shared memory a block may opt in to on Hopper (H100 and H200:
#: 232,448 bytes), the fit functions' budget off the card; on the card the
#: wrappers read the device's own limit
HOPPER_SMEM_OPTIN = 232_448
#: the grid recurrences' barrier counters, one per direction, 128 bytes
#: apart (uint32)
GRID_COUNTERS = 64


def device_smem_budget() -> int:
    """The current CUDA device's opt-in shared memory per block, in bytes."""
    return get_lib().gru_window_smem_optin()


_card_lock = threading.Lock()
#: (SMs, opt-in shared memory per block) of each CUDA device, by index
_card: Dict[int, Tuple[int, int]] = {}


def card_limits(device=None) -> Tuple[int, int]:
    """(SMs, opt-in shared memory per block in bytes) of ``device`` (a CUDA
    device or its index; default the current one, index 0 where no CUDA
    device is visible), read once per device."""
    index = torch.device("cuda", device) if isinstance(device, int) else device
    index = torch.device(index).index if index is not None else None
    if index is None:
        index = torch.cuda.current_device() if torch.cuda.is_available() else 0
    with _card_lock:
        if index not in _card:
            with torch.cuda.device(index):
                _card[index] = (get_lib().gru_window_sm_count(), device_smem_budget())
        return _card[index]
