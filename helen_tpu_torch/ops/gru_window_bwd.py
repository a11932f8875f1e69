"""The backward of one bi-GRU window layer: the hand-written CUDA kernels,
their plain version and their launch counters.

:func:`bigru_window_bwd` is the port of helen_tpu's ``_bwd_kernel_ip``
(``helen_tpu/ops/gru_pallas_train.py:321``), the backward of the training
window with the input projection in-kernel. It runs as two passes, each
counted once per layer-window in :data:`launch_counts`:

* ``bigru_window_bwd_rec`` (pass 1, :func:`bigru_window_bwd_rec`): the
  recurrence, unwound in reverse per direction; recomputes the gates from
  x and h_prev, carries dh, and streams ``dxp`` and the n block of ``dhp``
  to scratch; writes dh0 and, for later layers, dx. It has two designs,
  picked by a fixed rule of the shape (:func:`bwd_design`):

  - ``"smem"`` (ops.gru_window_bwd_smem, ``csrc/gru_window_bwd_smem.cu``),
    where ``W_hh^T`` fits one block's shared memory (the flagship's
    H=128): a gate pass over the whole window (K1/K2's projection
    ``bigru_window_proj_in1``/``_in2`` and ``bigru_window_bwd_hp``), the
    recurrence ``bigru_window_bwd_rec_smem`` with ``W_hh^T`` in shared
    memory, and for later layers the dx pass ``bigru_window_bwd_dx``;
  - ``"chain"``, elsewhere: one launch of ``bwd_rec_kernel``
    (``csrc/gru_window_bwd.cu``, counted as ``bigru_window_bwd_rec_chain``),
    the gate recompute and dx inside the serial loop.

  Both take every sum in the same order and the same cotangent lines, so
  they give the same bits;
* ``bigru_window_bwd_wgrad`` (pass 2, ops.gru_window_wgrad,
  ``csrc/gru_window_wgrad.cu``): dW_ih, db_ih, dW_hh, db_hh as a split-N
  reduction on 3xTF32 tensor cores, then the slices added in a fixed order
  (no atomics: bit-identical across launches).

Every kernel also counts its own launches under its name.

The forward needs no kernel of its own: ``_fwd_kernel_ip`` computes what
K1/K2 (``ops.gru_window``) compute, and the backward saves nothing beyond
the forward's outputs (it recomputes the gates), so K1/K2 serve as the
training forward as they stand.

The layer's input ``src`` is either the ``(B, L, F)`` uint8 image, read in
place at column ``start`` (layer 0: no dx, the image is data), or the pair
``(xa, xb)`` of the previous layer's ``(T, B, H)`` halves. On a CPU tensor
the wrapper computes the plain version; on a CUDA tensor it launches the
kernels or raises.
"""
from __future__ import annotations

from ctypes import c_int as i, c_longlong as ll, c_void_p as p
from typing import Optional, Tuple

import torch

from helen_tpu_torch.ops import gru_window_bwd_smem as gbs
from helen_tpu_torch.ops import gru_window_smem as gs
from helen_tpu_torch.ops import library
from helen_tpu_torch.ops.gru_window import MAX_H
from helen_tpu_torch.ops.gru_window_bwd_smem import (
    bwd_fits_smem,
    h_prev_of,
    launch_counts,
    unwind_gates,
)
from helen_tpu_torch.ops.gru_window_proj import Source, window_input
from helen_tpu_torch.ops.gru_window_wgrad import (
    bigru_window_bwd_wgrad_plain,
    bigru_window_wgrad,
    source_args,
)
from helen_tpu_torch.ops.library import (
    Layer,
    check,
    cuda_device,
    empty,
    get_lib,
    layer_args,
    raise_on,
    stream,
)

#: (dx (T, B, D) summed over the directions, or None; dh0_f; dh0_b;
#: {"fwd", "bwd"} of {"w_ih", "w_hh", "b_ih", "b_hh"} cotangents)
Grads = Tuple[Optional[torch.Tensor], torch.Tensor, torch.Tensor, Layer]

#: pass 1's designs (see bwd_design)
DESIGNS = ("smem", "chain")
#: the C entries of csrc/gru_window_bwd.cu: pass 1's one-launch design (the
#: layer input, h0, the forward's outputs, the cotangents, both directions'
#: weights and transposes, the outputs) and its MAX_H
ENTRIES = {"bigru_window_bwd_rec": (i, [p, ll, ll, i, p, p, i] + [p] * 8 + [p] * 12 + [p] * 6
                                    + [i, i, i, p]),
           "gru_window_bwd_max_h": (i, [])}


def check_fit(lib) -> None:
    """Raise where ``MAX_H`` disagrees with the source's."""
    if lib.gru_window_bwd_max_h() != MAX_H:
        raise RuntimeError("MAX_H disagrees with csrc/gru_window_bwd.cu")


library.register(ENTRIES, check_fit)


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


# ---------------------------------------------------------------------------
# plain version (CPU path, tests, and the on-card comparison)
# ---------------------------------------------------------------------------

def unwind_plain(xp: torch.Tensor, h_prev: torch.Tensor, dout: torch.Tensor,
                 dh_final: torch.Tensor, w_hh: torch.Tensor, b_hh: torch.Tensor,
                 rev: bool):
    """One direction's backward recurrence from its projected input ``xp``
    (T, B, 3H) and its ``h_prev`` stream: ``gru_window_bwd_smem.unwind_gates``
    with ``hp = h_prev @ w_hh + b_hh``.

    :returns: (dxp (T, B, 3H), dhp_n (T, B, H), dh0 (B, H))"""
    return unwind_gates(xp, h_prev @ w_hh + b_hh, h_prev, dout, dh_final, w_hh, rev)


def bigru_window_bwd_rec_plain(src: Source, start: int, h0_f, h0_b, out_f, out_b,
                               dout_f, dout_b, dh_f, dh_b, layer: Layer,
                               need_dx: bool = True):
    """Pass 1's plain version: the projection recomputed from the layer's
    input, then :func:`unwind_plain` per direction (``_bwd_dir_ip``,
    ``gru_pallas_train.py:300-318``).

    :returns: (dxp (2, T, B, 3H), dhp_n (2, T, B, H) — the kernel's
        scratch streams, direction-major —, dx (T, B, D) summed over the
        directions or None, dh0_f, dh0_b)"""
    T = out_f.shape[0]
    x = window_input(src, start, T, out_f.dtype)
    dxps, dhpns, dh0 = [], [], []
    dx = None
    for d, out, h0, dout, dh_final, rev in (
            ("fwd", out_f, h0_f, dout_f, dh_f, False),
            ("bwd", out_b, h0_b, dout_b, dh_b, True)):
        p = layer[d]
        dxp, dhpn, carry = unwind_plain(x @ p["w_ih"] + p["b_ih"], h_prev_of(out, h0, rev),
                                        dout, dh_final, p["w_hh"], p["b_hh"], rev)
        dxps.append(dxp)
        dhpns.append(dhpn)
        if need_dx:
            dx_d = dxp @ p["w_ih"].T
            dx = dx_d if dx is None else dx + dx_d
        dh0.append(carry)
    return torch.stack(dxps), torch.stack(dhpns), dx, dh0[0], dh0[1]


def bigru_window_bwd_plain(src: Source, start: int, h0_f, h0_b, out_f, out_b,
                           dout_f, dout_b, dh_f, dh_b, layer: Layer,
                           need_dx: bool = True) -> Grads:
    """The backward in explicit torch ops: pass 1's then pass 2's plain
    version, with the kernel's outputs."""
    dxp, dhpn, dx, dh0_f, dh0_b = bigru_window_bwd_rec_plain(
        src, start, h0_f, h0_b, out_f, out_b, dout_f, dout_b, dh_f, dh_b, layer,
        need_dx)
    grads = bigru_window_bwd_wgrad_plain(src, start, h0_f, h0_b, out_f, out_b,
                                         dxp, dhpn)
    return dx, dh0_f, dh0_b, grads


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def bwd_design(H: int, B: int, design=None) -> str:
    """Pass 1's design at hidden size ``H`` and batch ``B``: ``"smem"``
    where ``gru_window_bwd_smem.bwd_fits_smem`` holds (``W_hh^T`` and the
    dhp buffers in one block's shared memory at ``rec_block_rows(B)`` rows;
    the flagship's H=128), else ``"chain"``, ``bwd_rec_kernel``. A fixed
    rule of the shape, not a fallback. ``design`` forces one (tests,
    chip_smoke.py's comparison of the two); ``"smem"`` raises where the
    rule does not hold."""
    fits = bwd_fits_smem(H, B)
    if design is None:
        return "smem" if fits else "chain"
    if design not in DESIGNS:
        raise ValueError(f"design {design!r} is not one of {DESIGNS}")
    if design == "smem" and not fits:
        raise ValueError(f"design 'smem' does not take H={H}, B={B}: W_hh^T does not fit "
                         "one block's shared memory")
    return design


class _Window:
    """The checked arguments of one layer-window's backward launches."""

    def __init__(self, name: str, src: Source, start: int, h0_f, h0_b, out_f, out_b,
                 dout_f, dout_b, dh_f, dh_b, layer: Layer):
        self.pair = isinstance(src, tuple)
        lead = src[0] if self.pair else src
        dev = self.dev = cuda_device(lead, name)
        T, B, H = self.T, self.B, self.H = out_f.shape
        if not 0 < H <= MAX_H:
            raise ValueError(f"H={H} exceeds the backward kernel's maximum {MAX_H}")
        self.img_args = source_args(name, src, start, T, B, H, dev)
        D = self.D = self.img_args[-1]
        for n, t, shape in (("h0_f", h0_f, (B, H)), ("h0_b", h0_b, (B, H)),
                            ("out_f", out_f, (T, B, H)), ("out_b", out_b, (T, B, H)),
                            ("dout_f", dout_f, (T, B, H)), ("dout_b", dout_b, (T, B, H)),
                            ("dh_f", dh_f, (B, H)), ("dh_b", dh_b, (B, H))):
            check(n, t, shape, torch.float32, dev)
        self.w = layer_args(layer, D, H, dev)  # checks, and the forward's pointers


def _rec_chain(a: _Window, h0_f, h0_b, out_f, out_b, dout_f, dout_b, dh_f, dh_b, layer,
               want_dx):
    """Pass 1 as one launch of bwd_rec_kernel (gru_window_bwd.cu)."""
    T, B, H, D, dev = a.T, a.B, a.H, a.D, a.dev
    # the transposes the kernel reads coalesced (helen_tpu's wrapper makes
    # the same swapaxes copies, gru_pallas_train.py:655-656)
    wT = {d: (layer[d]["w_ih"].T.contiguous(), layer[d]["w_hh"].T.contiguous())
          for d in ("fwd", "bwd")}
    weights = []
    for i, d in enumerate(("fwd", "bwd")):
        wi, wh, bi, bh = a.w[4 * i:4 * i + 4]
        weights += [wi, wh, wT[d][0].data_ptr(), wT[d][1].data_ptr(), bi, bh]
    dxp, dhpn = empty(dev, 2, T, B, 3 * H), empty(dev, 2, T, B, H)
    dx_f, dx_b = (empty(dev, T, B, D), empty(dev, T, B, D)) if want_dx else (None, None)
    dh0_f, dh0_b = empty(dev, B, H), empty(dev, B, H)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    with torch.cuda.device(dev):
        err = get_lib().bigru_window_bwd_rec(
            *a.img_args, *(t.data_ptr() for t in (h0_f, h0_b, out_f, out_b, dout_f,
                                                  dout_b, dh_f, dh_b)),
            *weights, dxp.data_ptr(), dhpn.data_ptr(), ptr(dx_f), ptr(dx_b),
            dh0_f.data_ptr(), dh0_b.data_ptr(), T, B, H, stream(dev))
    raise_on(err, "bigru_window_bwd_rec")
    launch_counts["bigru_window_bwd_rec_chain"] += 1
    return dxp, dhpn, (dx_f + dx_b if want_dx else None), dh0_f, dh0_b


def _rec_smem(a: _Window, src, start, h0_f, h0_b, out_f, out_b, dout_f, dout_b, dh_f,
              dh_b, layer, want_dx):
    """Pass 1 as the gate pass (K1/K2's projection and the hp product), the
    recurrence with W_hh^T in shared memory, and the dx pass
    (ops.gru_window_bwd_smem)."""
    dev = a.dev
    if a.pair:
        xp = gs.launch_proj_in2(src[0], src[1], a.w, dev)
    else:
        xp = gs.launch_proj_in1(src, start, a.T, a.D, a.H, a.w, dev)
    hp = gbs.launch_hp(h0_f, h0_b, out_f, out_b, layer["fwd"]["w_hh"],
                       layer["bwd"]["w_hh"], dev)
    whT = [layer[d]["w_hh"].T.contiguous() for d in ("fwd", "bwd")]
    dxp, dhpn, dh0_f, dh0_b = gbs.launch_rec(
        xp, hp, h0_f, h0_b, out_f, out_b, dout_f, dout_b, dh_f, dh_b, *whT,
        layer["fwd"]["b_hh"], layer["bwd"]["b_hh"], dev)
    del xp, hp  # 2 x 78.6 MB at B=256 back to the allocator before the dx pass
    dx = None
    if want_dx:
        dx2 = gbs.launch_dx(dxp, *(layer[d]["w_ih"].T.contiguous() for d in ("fwd", "bwd")),
                            dev)
        dx = dx2[0] + dx2[1]
    return dxp, dhpn, dx, dh0_f, dh0_b


def _rec(a: _Window, design, src, start, *rest, need_dx: bool):
    """Pass 1 in the design :func:`bwd_design` picks, counted once."""
    want_dx = need_dx and a.pair
    if bwd_design(a.H, a.B, design) == "smem":
        res = _rec_smem(a, src, start, *rest, want_dx)
    else:
        res = _rec_chain(a, *rest, want_dx)
    launch_counts["bigru_window_bwd_rec"] += 1
    return res


def bigru_window_bwd_rec(src: Source, start: int, h0_f, h0_b, out_f, out_b,
                         dout_f, dout_b, dh_f, dh_b, layer: Layer,
                         need_dx: bool = True, design=None):
    """Pass 1 alone, in the design :func:`bwd_design` picks (``design``
    forces one): the outputs of :func:`bigru_window_bwd_rec_plain`, ``(dxp,
    dhp_n, dx or None, dh0_f, dh0_b)``. ``need_dx`` is ignored for the
    image (layer 0 has no dx)."""
    args = (src, start, h0_f, h0_b, out_f, out_b, dout_f, dout_b, dh_f, dh_b, layer)
    pair = isinstance(src, tuple)
    if (src[0] if pair else src).device.type == "cpu":
        return bigru_window_bwd_rec_plain(*args, need_dx and pair)
    return _rec(_Window("bigru_window_bwd_rec", *args), design, *args, need_dx=need_dx)


def bigru_window_bwd(src: Source, start: int, h0_f, h0_b, out_f, out_b,
                     dout_f, dout_b, dh_f, dh_b, layer: Layer,
                     need_dx: bool = True, design=None) -> Grads:
    """The backward of one bi-GRU window layer (see the module docstring):
    pass 1, in the design :func:`bwd_design` picks (``design`` forces one),
    then pass 2, ``gru_window_wgrad.bigru_window_wgrad``, on the current
    stream. ``need_dx`` is ignored for the image (layer 0 has no dx)."""
    args = (src, start, h0_f, h0_b, out_f, out_b, dout_f, dout_b, dh_f, dh_b, layer)
    pair = isinstance(src, tuple)
    if (src[0] if pair else src).device.type == "cpu":
        return bigru_window_bwd_plain(*args, need_dx and pair)
    a = _Window("bigru_window_bwd", *args)
    dxp, dhpn, dx, dh0_f, dh0_b = _rec(a, design, *args, need_dx=need_dx)
    grads = bigru_window_wgrad(src, start, h0_f, h0_b, out_f, out_b, dxp, dhpn)
    launch_counts["bigru_window_bwd_wgrad"] += 1
    return dx, dh0_f, dh0_b, grads
