"""The xp-stream window (K3, and K3f in the fast tier) as a grid-wide
recurrence with ``W_hh`` spread over the SMs' shared memory: the kernels'
binding and their fit rule.

The hand-written CUDA kernels ``bigru_window_xp_grid`` and
``bigru_window_xp_fast_grid`` (``ops/csrc/gru_window_xp_grid.cu``, in the
kernel library of ops.library) carry :func:`ops.gru_window_xp.
bigru_window_xp` and :func:`~ops.gru_window_xp.bigru_window_xp_fast` in
their ``"grid"`` design: one persistent grid of ``2 C`` blocks, ``C =
ceil(H / U)`` per direction, all co-resident (a cooperative launch), block
``c`` holding the ``W_hh`` columns of its ``U`` hidden units in shared
memory for all T steps, one grid barrier per direction and step. K3 sums
in fp32 FMA chains in k order, so it gives the bits of the one-launch
``xp_window_kernel``; its step product is register-tiled, each thread
holding :func:`grid_tile`'s 8 or 4 rows x 2 units x 3 gates of sums.
K3f's step product runs on bf16 tensor cores (``mma.sync``) with fp32
sums, so it agrees with its plain version to the fast tier's tolerance.

:func:`grid_units` is the fit rule: the smallest ``U`` whose ``2 C``
blocks fit the card's SMs, one block each, if its shared memory
(:func:`grid_smem_bytes`) fits the card's opt-in budget and ``U`` is at
most the tier's :data:`MAX_UNITS`; else none, and ``xp_window_kernel``
takes the shape. It is a rule of the shape, the tier and the card, whose
limits ``library.card_limits`` reads once from the device.
K3's thread tile (rows per thread, :func:`grid_tile`) is a rule of B
alone: its shared memory is the same at every tile.

The plain versions are ops.gru_window_xp's; the wrappers there pick the
design (``xp_fwd_design``) and call :func:`launch_xp_grid`.
"""
from __future__ import annotations

from ctypes import c_int as i, c_longlong as ll, c_void_p as p
from typing import Dict, Optional

import torch

from helen_tpu_torch.ops import library
from helen_tpu_torch.ops.library import (
    GRID_COUNTERS,
    Layer,
    Outputs,
    get_lib,
    outputs,
    raise_on,
    stream,
)

# csrc/gru_window_xp_grid.cu's constants. K3: unit groups (a warp is 8 unit
# groups x 4 row groups), units per thread, the most threads, k per chunk,
# the ring's floats, the tiles' rows per thread; K3f: rows per row block
# (8 warps of 2 m16 tiles), its ring (bf16)
XG_UG, XG_UPT, XG_MAX_THREADS, XG_KC, XG_RING = 8, 2, 256, 8, 8192
XG_TILES = (8, 4)
XF_ROWS, XF_KC, XF_KS, XF_STAGES = 256, 64, 72, 2
#: the most hidden units per block, per tier (parity: 8 unit groups of 2;
#: fast: three tiles of 8)
MAX_UNITS = {False: 16, True: 24}


def grid_smem_bytes(h: int, u: int, fast: bool = False) -> int:
    """Dynamic shared memory of one block of the grid recurrence at hidden
    size ``h`` and ``u`` units per block: its W_hh columns, then the ring of
    h_prev chunks; csrc/gru_window_xp_grid.cu ``xg_smem`` / ``xf_smem``.
    Parity, at any ``u``: 3 x 16 fp32 columns (zeros past ``u``) of ``h``
    rounded up to 16 rows, k-major, and the ring's 8192 floats of h;
    fast: ``3 x u`` rounded up to 8 bf16 columns of ``h`` rounded up to 64
    plus 8, and 2 x 256 rows x 72 bf16."""
    if fast:
        k = -(-h // XF_KC) * XF_KC
        return 2 * (3 * (-(-u // 8) * 8) * (k + 8) + XF_STAGES * XF_ROWS * XF_KS)
    k = -(-h // (2 * XG_KC)) * 2 * XG_KC
    return 4 * (3 * MAX_UNITS[False] * k + XG_RING)


def grid_threads(b: int, rpt: int) -> int:
    """K3's threads per block at batch ``b`` and ``rpt`` rows per thread: 8
    unit groups x 32 row groups, or 16 at 4 rows a thread where 64 rows
    hold the batch (csrc ``xg_row_groups``)."""
    return XG_UG * (16 if rpt == 4 and b <= 64 else 32)


def grid_tile(b: int) -> int:
    """K3's rows per thread at batch ``b``: 8 above B=128 (the consensus
    batch: a row block of 256 rows, two warps an SM quarter), else 4 (the
    wide train's 64: one row block of 64 rows)."""
    return 8 if b > 128 else 4


def grid_units(h: int, sms: int, budget: int, fast: bool = False) -> Optional[int]:
    """The grid recurrence's hidden units per block at hidden size ``h`` on a
    card of ``sms`` SMs and ``budget`` bytes of opt-in shared memory per
    block: the smallest ``U`` with ``2 ceil(h / U) <= sms`` (one block per
    SM, both directions), if its shared memory fits ``budget`` and it is at
    most the tier's :data:`MAX_UNITS`; else None. A larger ``U`` only takes
    more shared memory, so no other ``U`` fits where this one does not. On
    the H100 SXM (132 SMs, 232,448 bytes): K3f U=17 at H=1088 (its widest),
    K3 and K3f U=16 at H=1024 (K3's widest), 12 at 768, 10 at
    640, 2 at 128, in both tiers."""
    if h < 1 or sms < 2:
        return None
    u = -(-h // (sms // 2))
    if u > MAX_UNITS[fast] or grid_smem_bytes(h, u, fast) > budget:
        return None
    return u


# ---------------------------------------------------------------------------
# binding and launch (the arguments checked by the caller)
# ---------------------------------------------------------------------------

#: the kernels' names, by tier
KERNELS = {False: "bigru_window_xp_grid", True: "bigru_window_xp_fast_grid"}
#: the C entries of csrc/gru_window_xp_grid.cu
ENTRIES = {"bigru_window_xp_grid": (i, [p] * 13 + [i, i, i, i, i, p]),
           "bigru_window_xp_fast_grid": (i, [p] * 14 + [i, i, i, i, p]),
           "bigru_window_xp_grid_smem_bytes": (ll, [i, i, i])}


def check_fit(lib) -> None:
    """Raise where :func:`grid_smem_bytes` disagrees with the source's."""
    if any(lib.bigru_window_xp_grid_smem_bytes(h, u, f) != grid_smem_bytes(h, u, f)
           for h in (1, 37, 128, 160, 610, 640, 1000, 1024, 1056, 1088)
           for u in (1, 2, 3, 10, 16, 24) for f in (0, 1)):
        raise RuntimeError("the forward grid's fit disagrees with csrc/gru_window_xp_grid.cu")


library.register(ENTRIES, check_fit)


def launch_xp_grid(xp_f, xp_b, h0_f, h0_b, layer: Layer, units: int, counts: Dict[str, int],
                   dev, fast: bool = False) -> Outputs:
    """One launch of the grid recurrence in the tier ``fast`` picks, at
    ``units`` hidden units per block (K3 in the tile :func:`grid_tile`
    picks), counted in ``counts`` under its kernel's name
    (:data:`KERNELS`); raises on a refused launch (a grid the
    card cannot hold at once among them). The fast tier's bf16 exchange
    buffer ``(2 dirs, 2, B, H)`` and the barrier counters are allocated
    here."""
    T, B, H3 = xp_f.shape
    H = H3 // 3
    outs = outputs(T, B, H, dev)
    arrive = torch.zeros(GRID_COUNTERS, dtype=torch.int32, device=dev)
    scratch = [torch.empty((2, 2, B, H), dtype=torch.bfloat16, device=dev)] if fast else []
    w = [layer[d][k] for d in ("fwd", "bwd") for k in ("w_hh", "b_hh")]
    name = KERNELS[fast]
    tile = [] if fast else [grid_tile(B)]
    with torch.cuda.device(dev):
        err = getattr(get_lib(), name)(
            *(t.data_ptr() for t in (xp_f, xp_b, h0_f, h0_b, *w, *outs, *scratch, arrive)),
            T, B, H, units, *tile, stream(dev))
    raise_on(err, name)
    counts[name] += 1
    return outs
