"""The xp-stream bi-GRU window kernel (K3): binding, launch counter and
plain version.

:func:`bigru_window_xp` runs the recurrence of one bi-GRU layer over one
window whose input projection ``xp = x @ W_ih + b_ih`` was computed outside
(both directions in one launch of ops.gru_window_proj). It is the port of helen_tpu's
``_kernel`` (``helen_tpu/ops/gru_pallas.py:231``, the inference form) and
``_fwd_kernel`` (``helen_tpu/ops/gru_pallas_train.py:119``, the training
forward), which compute the same function; its source is
``ops/csrc/gru_window_xp.cu``, built into the one kernel library with the
other window kernels (``library.build_kernels``). It serves the wide
models, ``H > MAX_H``, whose weights the in-projection kernels K1/K2 do not
take, at every width whose state fits one block's shared memory at one row
(:func:`chain_rows`).

The wrapper takes ``xp_f``, ``xp_b`` ``(T, B, 3H)`` float32, ``h0_f``,
``h0_b`` ``(B, H)`` and the layer's ``{"fwd", "bwd"}`` params (``w_hh
(H, 3H)``, ``b_hh (3H,)``; ``b_hh`` goes inside the reset product, the other
keys are not read) and returns ``(out_f (T, B, H), out_b (T, B, H), h_f
(B, H), h_b (B, H))``, outputs in original time order. On a CPU tensor it
computes its plain version (the two ``gru_scan`` recurrences); on a CUDA
tensor it launches the kernel or raises.

K3 and K3f each have two designs, picked by a fixed rule of the shape, the
tier and the card (:func:`xp_fwd_design`):

* ``"grid"`` (ops.gru_window_xp_grid, ``csrc/gru_window_xp_grid.cu``), where
  ``W_hh`` spread over the card's SMs fits their shared memory (every width
  of the xp route on the H100): one cooperative launch, one block per SM
  holding its hidden units' ``W_hh`` columns for all T steps, one grid
  barrier per step; K3f's step product on bf16 tensor cores;
* ``"chain"``, elsewhere: ``xp_window_kernel`` (``csrc/gru_window_xp.cu``),
  ``ceil(B / R)`` blocks per direction, each reading ``W_hh`` from L2 at
  every step; ``R``, the batch rows per block, is the largest of 8, 4, 2
  and 1 whose state fits the card's opt-in shared memory
  (:func:`chain_rows`). A row's sums run in the same order at every ``R``.

K3's two designs sum in the same order and share the gate lines, so they
give the same bits. K3f's designs sum in two orders: the chain's FMA chains
in k order, the grid's tensor-core instructions (``models.gru.mma_product``);
K3f's plain version takes the order of the design the card runs, so that
each design has a plain version of its own bits. Each K3 or
K3f adds one to :data:`launch_counts` under its own name whichever design
ran, and one under the name of the kernel that ran (``*_grid``,
``*_chain``); a chain launch adds one more under its rows per block
(``*_chain_r8``, ``_r4``, ``_r2``, ``_r1``).

The fast tier: :func:`bigru_window_xp_fast` (K3f, the ``FAST``
instantiation of the same source) replaces ``_kernel`` run with
``fast=True``: bf16 ``xp`` streams and bf16 ``w_hh``, the operand copy of h
rounded to bf16, float32 gates, state and outputs. :func:`window_xp_fast`
is the whole fast xp layer, as helen_tpu's ``bigru_apply_fused(fast=True)``
(``gru_pallas.py:1080-1091``): the float32 projection of the bf16-rounded
layer input, rounded once to bf16 after the bias, then K3f. Inference only.
"""
from __future__ import annotations

from ctypes import c_int as i, c_longlong as ll, c_void_p as p
from typing import Dict, Optional

import torch

from helen_tpu_torch.models.gru import bf16_round, mma_product
from helen_tpu_torch.ops import gru_window_xp_grid as xg
from helen_tpu_torch.ops import library
from helen_tpu_torch.ops.gru_window_proj import Source, window_input
from helen_tpu_torch.ops.gru_window_smem import bidir
from helen_tpu_torch.ops.library import (
    Layer,
    Outputs,
    card_limits,
    check,
    cuda_device,
    get_lib,
    outputs,
    raise_on,
    stream,
)

#: the chain design's batch rows per block, largest first (csrc/gru_window_xp.cu
#: and csrc/gru_window_xp_bwd.cu instantiate each)
CHAIN_ROWS = (8, 4, 2, 1)
#: launches since the last reset_launch_counts() — counted where the kernel
#: is launched and nowhere else
launch_counts: Dict[str, int] = {"bigru_window_xp": 0, "bigru_window_xp_fast": 0,
                                 # the kernels of each design (see xp_fwd_design)
                                 "bigru_window_xp_grid": 0, "bigru_window_xp_chain": 0,
                                 "bigru_window_xp_fast_grid": 0,
                                 "bigru_window_xp_fast_chain": 0,
                                 # the chain design's launches by rows per block
                                 **{f"bigru_window_xp{t}_chain_r{r}": 0
                                    for t in ("", "_fast") for r in CHAIN_ROWS}}
#: K3's and K3f's designs (see xp_fwd_design)
DESIGNS = ("grid", "chain")


def chain_smem_bytes(h: int, rows: int, fast: bool = False) -> int:
    """Dynamic shared memory of one block of ``xp_window_kernel`` at hidden
    size ``h`` and ``rows`` batch rows per block: the float32 state's two
    buffers, and in the fast tier the operand copy's two more;
    csrc/gru_window_xp.cu ``xp_chain_smem``."""
    return 4 * 2 * rows * h * (2 if fast else 1)


def chain_rows(h: int, budget: int, fast: bool = False) -> Optional[int]:
    """The chain design's batch rows per block at hidden size ``h`` under
    ``budget`` bytes of opt-in shared memory per block: the largest of
    :data:`CHAIN_ROWS` whose :func:`chain_smem_bytes` fits, else None. On
    the H100 (232,448 bytes): 8 up to H=3,632 in parity and 1,816 in the
    fast tier (4 at H=2048 there)."""
    return next((r for r in CHAIN_ROWS if chain_smem_bytes(h, r, fast) <= budget), None)


_XP = (i, [p] * 12 + [i, i, i, i, p])
#: the C entries of csrc/gru_window_xp.cu: K3, K3f (the same arguments, bf16
#: streams and w_hh) and the chain's shared memory
ENTRIES = {"bigru_window_xp": _XP, "bigru_window_xp_fast": _XP,
           "bigru_window_xp_chain_smem_bytes": (ll, [i, i, i])}


def check_fit(lib) -> None:
    """Raise where :func:`chain_smem_bytes` disagrees with the source's."""
    if any(lib.bigru_window_xp_chain_smem_bytes(h, r, f) != chain_smem_bytes(h, r, bool(f))
           for h in (640, 1056, 2048) for r in CHAIN_ROWS for f in (0, 1)):
        raise RuntimeError("chain_smem_bytes disagrees with csrc/gru_window_xp.cu")


library.register(ENTRIES, check_fit)


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


def bigru_window_xp_plain(xp_f: torch.Tensor, xp_b: torch.Tensor,
                          h0_f: torch.Tensor, h0_b: torch.Tensor,
                          layer: Layer) -> Outputs:
    """K3's plain version: ``gru_scan`` forward over ``xp_f`` and reversed
    over ``xp_b``."""
    return bidir(xp_f, xp_b, h0_f, h0_b, layer)


def bigru_window_xp_fast_plain(xp_f: torch.Tensor, xp_b: torch.Tensor,
                               h0_f: torch.Tensor, h0_b: torch.Tensor,
                               layer: Layer, design=None) -> Outputs:
    """K3f's plain version: the bf16 streams widened to float32 (exact),
    then the fast ``gru_scan`` recurrences (bf16 ``w_hh``), their step
    product in the order of K3f's ``design``: ``"chain"`` in k order,
    ``"grid"`` that of the tensor cores (``models.gru.mma_product``). By
    default the design :func:`xp_fwd_design` picks on a CUDA device, and
    ``"chain"`` on the CPU."""
    if design is not None and design not in DESIGNS:
        raise ValueError(f"design {design!r} is not one of {DESIGNS}")
    if design is None:
        dev = xp_f.device
        design = (xp_fwd_design(xp_f.shape[-1] // 3, xp_f.shape[1], fast=True, device=dev)
                  if dev.type == "cuda" else "chain")
    return bidir(xp_f.to(h0_f.dtype), xp_b.to(h0_f.dtype), h0_f, h0_b, layer,
                 product=mma_product if design == "grid" else None)


def recurrent_args(layer: Layer, H: int, device, wdtype=torch.float32) -> list:
    """Checked pointers of ``[w_hh_f, b_hh_f, w_hh_b, b_hh_b]``, ``w_hh`` of
    ``wdtype`` (bf16 for the fast tier)."""
    args = []
    for d in ("fwd", "bwd"):
        p = layer[d]
        check(f"{d}.w_hh", p["w_hh"], (H, 3 * H), wdtype, device)
        check(f"{d}.b_hh", p["b_hh"], (3 * H,), torch.float32, device)
        args += [p["w_hh"].data_ptr(), p["b_hh"].data_ptr()]
    return args


def xp_fwd_design(H: int, B: int, design=None, fast: bool = False, device=None) -> str:
    """K3's (``fast``: K3f's) design at hidden size ``H`` and batch ``B``:
    ``"grid"`` where ``gru_window_xp_grid.grid_units`` finds a slice of
    ``W_hh`` per SM that fits in the tier (co-residency of the ``2 ceil(H /
    U)`` blocks at the card's SM count, the shared memory at its opt-in
    limit, both read once per device: ``device``, default the current
    one), else ``"chain"``, ``xp_window_kernel`` at :func:`chain_rows` rows
    per block. The grid takes any B (its blocks loop over rows). A fixed
    rule of the shape, the tier and the card, not a fallback. ``design``
    forces one (tests, chip_smoke.py's comparison of the two); a design the
    card cannot hold raises, and so does a width whose chain state does not
    fit the card at one row (only ``--backend torch`` runs it there)."""
    if design is not None and design not in DESIGNS:
        raise ValueError(f"design {design!r} is not one of {DESIGNS}")
    sms, budget = card_limits(device)
    fits = xg.grid_units(H, sms, budget, fast) is not None
    if design is None:
        design = "grid" if fits else "chain"
    if design == "grid" and not fits:
        raise ValueError(f"design 'grid' does not take H={H}, B={B}"
                         + (" in the fast tier" if fast else "")
                         + f": W_hh spread over {sms} SMs does not fit {budget} bytes of "
                         "shared memory per block")
    if design == "chain" and chain_rows(H, budget, fast) is None:
        raise ValueError(f"hidden_size {H} exceeds the xp window kernel's maximum on this "
                         f"card: one row of its state does not fit {budget} bytes of shared "
                         "memory per block; use --backend torch")
    return design


def _launch_xp(name: str, dtype, xp_f, xp_b, h0_f, h0_b, layer, design=None) -> Outputs:
    dev = cuda_device(xp_f, name)
    if xp_f.dim() != 3 or xp_f.shape[-1] % 3:
        raise ValueError(f"xp_f must be (T, B, 3H), got {tuple(xp_f.shape)}")
    T, B, H3 = xp_f.shape
    H = H3 // 3
    check("xp_f", xp_f, (T, B, H3), dtype, dev)
    check("xp_b", xp_b, (T, B, H3), dtype, dev)
    check("h0_f", h0_f, (B, H), torch.float32, dev)
    check("h0_b", h0_b, (B, H), torch.float32, dev)
    weights = recurrent_args(layer, H, dev, dtype)
    fast = dtype != torch.float32
    if xp_fwd_design(H, B, design, fast, dev) == "grid":
        outs = xg.launch_xp_grid(xp_f, xp_b, h0_f, h0_b, layer,
                                 xg.grid_units(H, *card_limits(dev), fast), launch_counts, dev,
                                 fast)
    else:
        rows = chain_rows(H, card_limits(dev)[1], fast)
        outs = outputs(T, B, H, dev)
        with torch.cuda.device(dev):
            err = getattr(get_lib(), name)(
                xp_f.data_ptr(), xp_b.data_ptr(), h0_f.data_ptr(), h0_b.data_ptr(),
                *weights, *[o.data_ptr() for o in outs], T, B, H, rows, stream(dev))
        raise_on(err, name)
        launch_counts[f"{name}_chain"] += 1
        launch_counts[f"{name}_chain_r{rows}"] += 1
    launch_counts[name] += 1
    return outs


def bigru_window_xp(xp_f: torch.Tensor, xp_b: torch.Tensor,
                    h0_f: torch.Tensor, h0_b: torch.Tensor,
                    layer: Layer, design=None) -> Outputs:
    """K3: the bi-GRU recurrence over the projected streams, in the design
    :func:`xp_fwd_design` picks (``design`` forces one). See the module
    docstring."""
    if xp_f.device.type == "cpu":
        return bigru_window_xp_plain(xp_f, xp_b, h0_f, h0_b, layer)
    return _launch_xp("bigru_window_xp", torch.float32, xp_f, xp_b, h0_f, h0_b, layer,
                      design)


def bigru_window_xp_fast(xp_f: torch.Tensor, xp_b: torch.Tensor,
                         h0_f: torch.Tensor, h0_b: torch.Tensor,
                         layer: Layer, design=None) -> Outputs:
    """K3f: K3 in the fast tier, over bf16 ``xp`` streams with the layer's
    bf16 ``w_hh``, in the design :func:`xp_fwd_design` picks (``design``
    forces one). See the module docstring."""
    if xp_f.device.type == "cpu":
        return bigru_window_xp_fast_plain(xp_f, xp_b, h0_f, h0_b, layer)
    return _launch_xp("bigru_window_xp_fast", torch.bfloat16, xp_f, xp_b, h0_f, h0_b,
                      layer, design)


def project_fast(x: torch.Tensor, p) -> torch.Tensor:
    """One direction's fast-tier stream ``bf16(x @ W_ih + b_ih)`` of a
    bf16-valued float32 ``x``: the product of bf16 values as a float32 GEMM
    (exact products, float32 sums: TF32 must be off, as on every route), the
    bias added in float32, then ONE rounding to bf16. Not a bf16 matmul:
    that rounds its result to bf16 before ``b_ih`` is added, a second
    rounding that helen_tpu (``preferred_element_type=f32``) does not do."""
    return (x @ p["w_ih_f32"] + p["b_ih"]).to(torch.bfloat16)


def _fast_streams(src: Source, start: int, T: int, dtype, layer: Layer):
    x = window_input(src, start, T, dtype)
    if isinstance(src, tuple):
        x = bf16_round(x)
    return project_fast(x, layer["fwd"]), project_fast(x, layer["bwd"])


def window_xp_fast(src: Source, start: int, T: int, h0_f: torch.Tensor,
                   h0_b: torch.Tensor, layer: Layer) -> Outputs:
    """One bi-GRU layer of the fast tier on the xp route: the layer input
    (the uint8 image window, exact in bf16, or the previous layer's float32
    halves concatenated and rounded to bf16) projected by
    :func:`project_fast` per direction, then K3f. ``layer`` is a fast layer
    (io.checkpoint.fast_weights); ``src``, ``start``, ``T`` as in
    :func:`gru_window_proj.window_input`."""
    return bigru_window_xp_fast(*_fast_streams(src, start, T, h0_f.dtype, layer),
                                h0_f, h0_b, layer)


def window_xp_fast_plain(src: Source, start: int, T: int, h0_f: torch.Tensor,
                         h0_b: torch.Tensor, layer: Layer, design=None) -> Outputs:
    """:func:`window_xp_fast` with K3f's plain version, on any device, its
    sums in the order of ``design`` (:func:`bigru_window_xp_fast_plain`)."""
    return bigru_window_xp_fast_plain(*_fast_streams(src, start, T, h0_f.dtype, layer),
                                      h0_f, h0_b, layer, design)
