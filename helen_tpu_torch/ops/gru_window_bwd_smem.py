"""Pass 1 of the in-projection backward as a gate pass, a recurrence with
``W_hh^T`` in shared memory and a dx pass: the kernels' binding, their fit
rule and their plain versions.

Three hand-written CUDA kernels (``ops/csrc/gru_window_bwd_smem.cu``, in
the library that ops.gru_window builds), with K1/K2's projection
(ops.gru_window_smem), carry ``bwd_rec``, pass 1 of
:func:`ops.gru_window_bwd.bigru_window_bwd`, where :func:`bwd_fits_smem`
holds:

* the gate pass, parallel over the window's ``T * B`` rows: ``xp = x @
  W_ih + b_ih`` (``bigru_window_proj_in1`` / ``_in2``) and
  :func:`bigru_window_bwd_hp`, ``hp = h_prev @ W_hh`` without ``b_hh``,
  each into a ``(2, T, B, 3H)`` float32 scratch;
* :func:`bigru_window_bwd_rec_smem`, the recurrence: one block per
  (rows, direction) holding the direction's ``W_hh^T`` in shared memory;
  writes pass 2's scratch ``dxp (2, T, B, 3H)`` and ``dhp_n (2, T, B, H)``,
  and ``dh0`` per direction;
* :func:`bigru_window_bwd_dx` (later layers only): ``dxp_dir @ W_ih^T``
  per direction, ``(2, T, B, D)``; the caller adds the two.

Every sum is taken in the order of the one-launch ``bwd_rec_kernel``
(``csrc/gru_window_bwd.cu``), whose cotangent lines the recurrence shares
(``gru_cell_bwd``), so on the card the two designs give the same bits.
The rows per block come from the forward recurrence's rule
(:func:`ops.gru_window_smem.rec_block_rows`).

On a CPU tensor each wrapper computes its plain version; on a CUDA tensor
it launches its kernel or raises. Each launch adds one to
``ops.gru_window_bwd.launch_counts`` under the kernel's name. Chained —
``x @ w_ih + b_ih``, :func:`bwd_hp_plain`, :func:`bwd_rec_smem_plain`,
:func:`bwd_dx_plain` — the plain versions are
``gru_window_bwd.bigru_window_bwd_rec_plain`` to the bit.
"""
from __future__ import annotations

import ctypes
import threading
from typing import Tuple

import torch

from helen_tpu_torch.ops import gru_window as gw
from helen_tpu_torch.ops import gru_window_bwd as gb
from helen_tpu_torch.ops.gru_window import Layer
from helen_tpu_torch.ops.gru_window_encdec import HOPPER_SMEM_OPTIN
from helen_tpu_torch.ops.gru_window_smem import REC_MAX_THREADS, REC_SPLIT, rec_block_rows

#: pass 1's outputs: (dxp (2, T, B, 3H), dhp_n (2, T, B, H), dh0_f, dh0_b)
RecOutputs = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def bwd_rec_smem_bytes(h: int, rows: int) -> int:
    """Dynamic shared memory of one recurrence block: ``dhp`` double-buffered
    (``rows`` rows of ``3h`` rounded up to 4 floats) and one direction's
    ``W_hh^T`` ``(3h, h)``, float32; csrc/gru_window_bwd_smem.cu
    ``bwd_rec_smem``."""
    return 4 * (2 * rows * (-(-3 * h // 4) * 4) + 3 * h * h)


def bwd_fits_smem(h: int, b: int, budget: int = 0) -> bool:
    """Whether the recurrence takes hidden size ``h`` at batch ``b``: at
    ``rec_block_rows(b)`` rows per block, its shared memory within
    ``budget`` bytes (default :data:`HOPPER_SMEM_OPTIN`) and its threads
    within the launch bound. Up to H=131 at 8 rows (B > 264), 135 at 4."""
    rows = rec_block_rows(b)
    threads = (REC_SPLIT if rows >= 2 else 1) * h
    return (h > 0 and threads <= REC_MAX_THREADS
            and bwd_rec_smem_bytes(h, rows) <= (budget or HOPPER_SMEM_OPTIN))


def require_fit(name: str, H: int, B: int) -> None:
    """Raise unless the recurrence takes ``H`` at batch ``B``."""
    if not bwd_fits_smem(H, B):
        rows = rec_block_rows(B)
        raise ValueError(f"{name}: W_hh^T at H={H} and {rows} rows per block take "
                         f"{bwd_rec_smem_bytes(H, rows)} bytes of shared memory (budget "
                         f"{HOPPER_SMEM_OPTIN}) or {REC_SPLIT * H} threads (max "
                         f"{REC_MAX_THREADS}); bwd_rec_kernel takes it")


# ---------------------------------------------------------------------------
# plain versions (CPU path, tests, and the on-card comparison)
# ---------------------------------------------------------------------------

def bwd_hp_plain(h0_f, h0_b, out_f, out_b, layer: Layer) -> torch.Tensor:
    """``h_prev @ W_hh`` per direction, no bias: ``(2, T, B, 3H)``."""
    return torch.stack([gb._h_prev(out, h0, rev) @ layer[d]["w_hh"]
                        for d, out, h0, rev in (("fwd", out_f, h0_f, False),
                                                ("bwd", out_b, h0_b, True))])


def bwd_rec_smem_plain(xp: torch.Tensor, hp: torch.Tensor, h0_f, h0_b, out_f, out_b,
                       dout_f, dout_b, dh_f, dh_b, layer: Layer) -> RecOutputs:
    """The recurrence given ``xp`` (``b_ih`` added) and ``hp`` (without
    ``b_hh``), both ``(2, T, B, 3H)``: ``gru_window_bwd.unwind_gates`` per
    direction. Returns ``(dxp, dhp_n, dh0_f, dh0_b)``."""
    res = [gb.unwind_gates(xp[i], hp[i] + layer[d]["b_hh"], gb._h_prev(out, h0, rev),
                           dout, dh, layer[d]["w_hh"], rev)
           for i, (d, out, h0, dout, dh, rev) in enumerate(
               (("fwd", out_f, h0_f, dout_f, dh_f, False),
                ("bwd", out_b, h0_b, dout_b, dh_b, True)))]
    return (torch.stack([r[0] for r in res]), torch.stack([r[1] for r in res]),
            res[0][2], res[1][2])


def bwd_dx_plain(dxp: torch.Tensor, layer: Layer) -> torch.Tensor:
    """``dxp_dir @ W_ih^T`` per direction: ``(2, T, B, D)``."""
    return torch.stack([dxp[i] @ layer[d]["w_ih"].T for i, d in enumerate(("fwd", "bwd"))])


# ---------------------------------------------------------------------------
# binding and launches (the arguments checked by the caller)
# ---------------------------------------------------------------------------

_bind_lock = threading.Lock()
_bound = None


def get_lib() -> ctypes.CDLL:
    """The kernel library with this module's entry points declared."""
    global _bound
    lib = gw.get_lib()
    with _bind_lock:
        if _bound is not lib:
            p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
            lib.bigru_window_bwd_hp.restype = i
            lib.bigru_window_bwd_hp.argtypes = [p] * 7 + [i, i, i, p]
            lib.bigru_window_bwd_rec_smem.restype = i
            lib.bigru_window_bwd_rec_smem.argtypes = [p] * 18 + [i, i, i, i, p]
            lib.bigru_window_bwd_dx.restype = i
            lib.bigru_window_bwd_dx.argtypes = [p] * 4 + [i, i, i, i, p]
            lib.bigru_window_bwd_rec_smem_bytes.restype = ll
            lib.bigru_window_bwd_rec_smem_bytes.argtypes = [i, i]
            if any(lib.bigru_window_bwd_rec_smem_bytes(h, r) != bwd_rec_smem_bytes(h, r)
                   for h in (1, 37, 128, 131, 132) for r in (1, 2, 4, 8)):
                raise RuntimeError("the backward recurrence's fit disagrees with "
                                   "csrc/gru_window_bwd_smem.cu")
            _bound = lib
    return lib


def _stream(dev) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def _count(err: int, name: str, counts=None) -> None:
    gw._raise_on(err, name)
    (gb.launch_counts if counts is None else counts)[name] += 1


def launch_hp(h0_f, h0_b, out_f, out_b, w_hh_f, w_hh_b, dev, counts=None,
              name: str = "bigru_window_bwd_hp") -> torch.Tensor:
    """The gate pass's hp product, counted as ``name`` in ``counts``: by
    default in ``gru_window_bwd.launch_counts``, or in the xp route's own
    (ops.gru_window_xp_bwd)."""
    T, B, H = out_f.shape
    hp = torch.empty((2, T, B, 3 * H), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = get_lib().bigru_window_bwd_hp(
            h0_f.data_ptr(), h0_b.data_ptr(), out_f.data_ptr(), out_b.data_ptr(),
            w_hh_f.data_ptr(), w_hh_b.data_ptr(), hp.data_ptr(), T, B, H, _stream(dev))
    _count(err, name, counts)
    return hp


def launch_rec(xp, hp, h0_f, h0_b, out_f, out_b, dout_f, dout_b, dh_f, dh_b,
               w_hhT_f, w_hhT_b, b_hh_f, b_hh_b, dev) -> RecOutputs:
    T, B, H = out_f.shape
    e = lambda *s: torch.empty(s, dtype=torch.float32, device=dev)  # noqa: E731
    dxp, dhpn, dh0_f, dh0_b = e(2, T, B, 3 * H), e(2, T, B, H), e(B, H), e(B, H)
    with torch.cuda.device(dev):
        err = get_lib().bigru_window_bwd_rec_smem(
            *(t.data_ptr() for t in (xp, hp, h0_f, h0_b, out_f, out_b, dout_f, dout_b, dh_f,
                                     dh_b, w_hhT_f, w_hhT_b, b_hh_f, b_hh_b, dxp, dhpn,
                                     dh0_f, dh0_b)),
            T, B, H, rec_block_rows(B), _stream(dev))
    _count(err, "bigru_window_bwd_rec_smem")
    return dxp, dhpn, dh0_f, dh0_b


def launch_dx(dxp, w_ihT_f, w_ihT_b, dev) -> torch.Tensor:
    _, T, B, H3 = dxp.shape
    D = w_ihT_f.shape[1]
    dx = torch.empty((2, T, B, D), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = get_lib().bigru_window_bwd_dx(
            dxp.data_ptr(), w_ihT_f.data_ptr(), w_ihT_b.data_ptr(), dx.data_ptr(),
            T, B, H3 // 3, D, _stream(dev))
    _count(err, "bigru_window_bwd_dx")
    return dx


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def _check_stream(out_f, out_b, h0_f, h0_b, dev) -> Tuple[int, int, int]:
    T, B, H = out_f.shape
    for n, t, shape in (("out_f", out_f, (T, B, H)), ("out_b", out_b, (T, B, H)),
                        ("h0_f", h0_f, (B, H)), ("h0_b", h0_b, (B, H))):
        gw._check(n, t, shape, torch.float32, dev)
    return T, B, H


def _check_weight(layer: Layer, key: str, shape, dev) -> None:
    for d in ("fwd", "bwd"):
        gw._check(f"{d}.{key}", layer[d][key], shape, torch.float32, dev)


def bigru_window_bwd_hp(h0_f, h0_b, out_f, out_b, layer: Layer) -> torch.Tensor:
    """``h_prev @ W_hh`` per direction over the window, no bias:
    ``(2, T, B, 3H)``."""
    if out_f.device.type == "cpu":
        return bwd_hp_plain(h0_f, h0_b, out_f, out_b, layer)
    dev = gw._cuda_device(out_f, "bigru_window_bwd_hp")
    _, _, H = _check_stream(out_f, out_b, h0_f, h0_b, dev)
    _check_weight(layer, "w_hh", (H, 3 * H), dev)
    return launch_hp(h0_f, h0_b, out_f, out_b, layer["fwd"]["w_hh"], layer["bwd"]["w_hh"],
                     dev)


def bigru_window_bwd_rec_smem(xp, hp, h0_f, h0_b, out_f, out_b, dout_f, dout_b, dh_f, dh_b,
                              layer: Layer) -> RecOutputs:
    """The recurrence over ``xp`` and ``hp`` ``(2, T, B, 3H)``: ``(dxp,
    dhp_n, dh0_f, dh0_b)``. Raises where :func:`bwd_fits_smem` does not
    hold."""
    args = (h0_f, h0_b, out_f, out_b, dout_f, dout_b, dh_f, dh_b)
    if xp.device.type == "cpu":
        return bwd_rec_smem_plain(xp, hp, *args, layer)
    dev = gw._cuda_device(xp, "bigru_window_bwd_rec_smem")
    T, B, H = _check_stream(out_f, out_b, h0_f, h0_b, dev)
    require_fit("bigru_window_bwd_rec_smem", H, B)
    for n, t, shape in (("xp", xp, (2, T, B, 3 * H)), ("hp", hp, (2, T, B, 3 * H)),
                        ("dout_f", dout_f, (T, B, H)), ("dout_b", dout_b, (T, B, H)),
                        ("dh_f", dh_f, (B, H)), ("dh_b", dh_b, (B, H))):
        gw._check(n, t, shape, torch.float32, dev)
    _check_weight(layer, "w_hh", (H, 3 * H), dev)
    _check_weight(layer, "b_hh", (3 * H,), dev)
    whT = [layer[d]["w_hh"].T.contiguous() for d in ("fwd", "bwd")]
    return launch_rec(xp, hp, *args, *whT, layer["fwd"]["b_hh"], layer["bwd"]["b_hh"], dev)


def bigru_window_bwd_dx(dxp: torch.Tensor, layer: Layer) -> torch.Tensor:
    """``dxp_dir @ W_ih^T`` per direction: ``(2, T, B, D)``."""
    if dxp.device.type == "cpu":
        return bwd_dx_plain(dxp, layer)
    dev = gw._cuda_device(dxp, "bigru_window_bwd_dx")
    _, T, B, H3 = dxp.shape
    gw._check("dxp", dxp, (2, T, B, H3), torch.float32, dev)
    D = layer["fwd"]["w_ih"].shape[0]
    _check_weight(layer, "w_ih", (D, H3), dev)
    wT = [layer[d]["w_ih"].T.contiguous() for d in ("fwd", "bwd")]
    return launch_dx(dxp, *wT, dev)
