"""Pass 1 of the in-projection backward as a gate pass, a recurrence with
``W_hh^T`` in shared memory and a dx pass: the kernels' binding, their fit
rule and their plain versions.

Three hand-written CUDA kernels (``ops/csrc/gru_window_bwd_smem.cu``, in
the kernel library of ops.library), with K1/K2's projection
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
:data:`launch_counts` (``ops.gru_window_bwd.launch_counts``) under the
kernel's name. Chained — ``x @ w_ih + b_ih``, :func:`bwd_hp_plain`,
:func:`bwd_rec_smem_plain`, :func:`bwd_dx_plain` — the plain versions are
``gru_window_bwd.bigru_window_bwd_rec_plain`` to the bit. The backward
recurrence's plain lines (:func:`unwind_gates`, :func:`h_prev_of`) are here,
and every backward's plain version runs them.
"""
from __future__ import annotations

from ctypes import c_int as i, c_longlong as ll, c_void_p as p
from typing import Dict, Tuple

import torch

from helen_tpu_torch.ops import library
from helen_tpu_torch.ops.gru_window_smem import REC_MAX_THREADS, REC_SPLIT, rec_block_rows
from helen_tpu_torch.ops.library import (
    HOPPER_SMEM_OPTIN,
    Layer,
    check,
    cuda_device,
    empty,
    get_lib,
    raise_on,
    stream,
)

#: pass 1's outputs: (dxp (2, T, B, 3H), dhp_n (2, T, B, H), dh0_f, dh0_b)
RecOutputs = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]

#: launches of each pass of the in-projection backward since the last
#: ``gru_window_bwd.reset_launch_counts()`` — counted where the kernel is
#: launched and nowhere else; ``ops.gru_window_bwd`` holds it as its
#: ``launch_counts``
launch_counts: Dict[str, int] = {"bigru_window_bwd_rec": 0,
                                 "bigru_window_bwd_wgrad": 0,
                                 # pass 1's kernels: the one-launch design
                                 "bigru_window_bwd_rec_chain": 0,
                                 # and the other (here)
                                 "bigru_window_bwd_hp": 0,
                                 "bigru_window_bwd_rec_smem": 0,
                                 "bigru_window_bwd_dx": 0}


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

def h_prev_of(out: torch.Tensor, h0: torch.Tensor, rev: bool) -> torch.Tensor:
    """Each step's previous hidden: the output stream shifted one step
    (forward direction: out[t-1]; backward direction: out[t+1]), h0 at the
    window boundary."""
    if rev:
        return torch.cat([out[1:], h0[None]], dim=0)
    return torch.cat([h0[None], out[:-1]], dim=0)


def unwind_gates(xp: torch.Tensor, hp: torch.Tensor, h_prev: torch.Tensor,
                 dout: torch.Tensor, dh_final: torch.Tensor, w_hh: torch.Tensor,
                 rev: bool):
    """The backward recurrence given both projections, ``xp`` (``b_ih``
    added) and ``hp = h_prev @ w_hh + b_hh``, each (T, B, 3H): the gates
    recomputed for the whole window at once, the carry unwound step by step
    (helen_tpu's equations, ``gru_pallas_train.py:51-62``, ``_bwd_dir``
    ``:151-163``).

    :returns: (dxp (T, B, 3H), dhp_n (T, B, H), dh0 (B, H))"""
    T, _, H3 = xp.shape
    H = H3 // 3
    r = torch.sigmoid(xp[..., :H] + hp[..., :H])
    z = torch.sigmoid(xp[..., H:2 * H] + hp[..., H:2 * H])
    hp_n = hp[..., 2 * H:]
    n = torch.tanh(xp[..., 2 * H:] + r * hp_n)
    dxp = [None] * T
    dhpn = [None] * T
    carry = dh_final
    for t in (range(T) if rev else range(T - 1, -1, -1)):
        dh = dout[t] + carry
        dz = dh * (h_prev[t] - n[t])
        da = dh * (1.0 - z[t]) * (1.0 - n[t] * n[t])
        dr = da * hp_n[t]
        drpre = dr * r[t] * (1.0 - r[t])
        dzpre = dz * z[t] * (1.0 - z[t])
        dxp[t] = torch.cat([drpre, dzpre, da], dim=-1)
        dhpn[t] = da * r[t]
        dhp = torch.cat([drpre, dzpre, dhpn[t]], dim=-1)
        carry = dh * z[t] + dhp @ w_hh.T
    return torch.stack(dxp), torch.stack(dhpn), carry


def bwd_hp_plain(h0_f, h0_b, out_f, out_b, layer: Layer) -> torch.Tensor:
    """``h_prev @ W_hh`` per direction, no bias: ``(2, T, B, 3H)``."""
    return torch.stack([h_prev_of(out, h0, rev) @ layer[d]["w_hh"]
                        for d, out, h0, rev in (("fwd", out_f, h0_f, False),
                                                ("bwd", out_b, h0_b, True))])


def bwd_rec_smem_plain(xp: torch.Tensor, hp: torch.Tensor, h0_f, h0_b, out_f, out_b,
                       dout_f, dout_b, dh_f, dh_b, layer: Layer) -> RecOutputs:
    """The recurrence given ``xp`` (``b_ih`` added) and ``hp`` (without
    ``b_hh``), both ``(2, T, B, 3H)``: :func:`unwind_gates` per direction.
    Returns ``(dxp, dhp_n, dh0_f, dh0_b)``."""
    res = [unwind_gates(xp[k], hp[k] + layer[d]["b_hh"], h_prev_of(out, h0, rev),
                        dout, dh, layer[d]["w_hh"], rev)
           for k, (d, out, h0, dout, dh, rev) in enumerate(
               (("fwd", out_f, h0_f, dout_f, dh_f, False),
                ("bwd", out_b, h0_b, dout_b, dh_b, True)))]
    return (torch.stack([r[0] for r in res]), torch.stack([r[1] for r in res]),
            res[0][2], res[1][2])


def bwd_dx_plain(dxp: torch.Tensor, layer: Layer) -> torch.Tensor:
    """``dxp_dir @ W_ih^T`` per direction: ``(2, T, B, D)``."""
    return torch.stack([dxp[k] @ layer[d]["w_ih"].T for k, d in enumerate(("fwd", "bwd"))])


# ---------------------------------------------------------------------------
# binding and launches (the arguments checked by the caller)
# ---------------------------------------------------------------------------

#: the C entries of csrc/gru_window_bwd_smem.cu
ENTRIES = {"bigru_window_bwd_hp": (i, [p] * 7 + [i, i, i, p]),
           "bigru_window_bwd_rec_smem": (i, [p] * 18 + [i, i, i, i, p]),
           "bigru_window_bwd_dx": (i, [p] * 4 + [i, i, i, i, p]),
           "bigru_window_bwd_rec_smem_bytes": (ll, [i, i])}


def check_fit(lib) -> None:
    """Raise where :func:`bwd_rec_smem_bytes` disagrees with the source's."""
    if any(lib.bigru_window_bwd_rec_smem_bytes(h, r) != bwd_rec_smem_bytes(h, r)
           for h in (1, 37, 128, 131, 132) for r in (1, 2, 4, 8)):
        raise RuntimeError("the backward recurrence's fit disagrees with "
                           "csrc/gru_window_bwd_smem.cu")


library.register(ENTRIES, check_fit)


def _count(err: int, name: str, counts=None) -> None:
    raise_on(err, name)
    (launch_counts if counts is None else counts)[name] += 1


def launch_hp(h0_f, h0_b, out_f, out_b, w_hh_f, w_hh_b, dev, counts=None,
              name: str = "bigru_window_bwd_hp") -> torch.Tensor:
    """The gate pass's hp product, counted as ``name`` in ``counts``: by
    default in :data:`launch_counts`, or in the xp route's own
    (ops.gru_window_xp_bwd)."""
    T, B, H = out_f.shape
    hp = empty(dev, 2, T, B, 3 * H)
    with torch.cuda.device(dev):
        err = get_lib().bigru_window_bwd_hp(
            h0_f.data_ptr(), h0_b.data_ptr(), out_f.data_ptr(), out_b.data_ptr(),
            w_hh_f.data_ptr(), w_hh_b.data_ptr(), hp.data_ptr(), T, B, H, stream(dev))
    _count(err, name, counts)
    return hp


def launch_rec(xp, hp, h0_f, h0_b, out_f, out_b, dout_f, dout_b, dh_f, dh_b,
               w_hhT_f, w_hhT_b, b_hh_f, b_hh_b, dev) -> RecOutputs:
    T, B, H = out_f.shape
    dxp, dhpn = empty(dev, 2, T, B, 3 * H), empty(dev, 2, T, B, H)
    dh0_f, dh0_b = empty(dev, B, H), empty(dev, B, H)
    with torch.cuda.device(dev):
        err = get_lib().bigru_window_bwd_rec_smem(
            *(t.data_ptr() for t in (xp, hp, h0_f, h0_b, out_f, out_b, dout_f, dout_b, dh_f,
                                     dh_b, w_hhT_f, w_hhT_b, b_hh_f, b_hh_b, dxp, dhpn,
                                     dh0_f, dh0_b)),
            T, B, H, rec_block_rows(B), stream(dev))
    _count(err, "bigru_window_bwd_rec_smem")
    return dxp, dhpn, dh0_f, dh0_b


def launch_dx(dxp, w_ihT_f, w_ihT_b, dev) -> torch.Tensor:
    _, T, B, H3 = dxp.shape
    D = w_ihT_f.shape[1]
    dx = empty(dev, 2, T, B, D)
    with torch.cuda.device(dev):
        err = get_lib().bigru_window_bwd_dx(
            dxp.data_ptr(), w_ihT_f.data_ptr(), w_ihT_b.data_ptr(), dx.data_ptr(),
            T, B, H3 // 3, D, stream(dev))
    _count(err, "bigru_window_bwd_dx")
    return dx


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def _check_stream(out_f, out_b, h0_f, h0_b, dev) -> Tuple[int, int, int]:
    T, B, H = out_f.shape
    for n, t, shape in (("out_f", out_f, (T, B, H)), ("out_b", out_b, (T, B, H)),
                        ("h0_f", h0_f, (B, H)), ("h0_b", h0_b, (B, H))):
        check(n, t, shape, torch.float32, dev)
    return T, B, H


def _check_weight(layer: Layer, key: str, shape, dev) -> None:
    for d in ("fwd", "bwd"):
        check(f"{d}.{key}", layer[d][key], shape, torch.float32, dev)


def bigru_window_bwd_hp(h0_f, h0_b, out_f, out_b, layer: Layer) -> torch.Tensor:
    """``h_prev @ W_hh`` per direction over the window, no bias:
    ``(2, T, B, 3H)``."""
    if out_f.device.type == "cpu":
        return bwd_hp_plain(h0_f, h0_b, out_f, out_b, layer)
    dev = cuda_device(out_f, "bigru_window_bwd_hp")
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
    dev = cuda_device(xp, "bigru_window_bwd_rec_smem")
    T, B, H = _check_stream(out_f, out_b, h0_f, h0_b, dev)
    require_fit("bigru_window_bwd_rec_smem", H, B)
    for n, t, shape in (("xp", xp, (2, T, B, 3 * H)), ("hp", hp, (2, T, B, 3 * H)),
                        ("dout_f", dout_f, (T, B, H)), ("dout_b", dout_b, (T, B, H)),
                        ("dh_f", dh_f, (B, H)), ("dh_b", dh_b, (B, H))):
        check(n, t, shape, torch.float32, dev)
    _check_weight(layer, "w_hh", (H, 3 * H), dev)
    _check_weight(layer, "b_hh", (3 * H,), dev)
    whT = [layer[d]["w_hh"].T.contiguous() for d in ("fwd", "bwd")]
    return launch_rec(xp, hp, *args, *whT, layer["fwd"]["b_hh"], layer["bwd"]["b_hh"], dev)


def bigru_window_bwd_dx(dxp: torch.Tensor, layer: Layer) -> torch.Tensor:
    """``dxp_dir @ W_ih^T`` per direction: ``(2, T, B, D)``."""
    if dxp.device.type == "cpu":
        return bwd_dx_plain(dxp, layer)
    dev = cuda_device(dxp, "bigru_window_bwd_dx")
    _, T, B, H3 = dxp.shape
    check("dxp", dxp, (2, T, B, H3), torch.float32, dev)
    D = layer["fwd"]["w_ih"].shape[0]
    _check_weight(layer, "w_ih", (D, H3), dev)
    wT = [layer[d]["w_ih"].T.contiguous() for d in ("fwd", "bwd")]
    return launch_dx(dxp, *wT, dev)
