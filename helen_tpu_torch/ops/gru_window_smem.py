"""The parity K1/K2 of the main path as a projection pass plus a recurrence
with W_hh in shared memory: the kernels' binding, their shape rules and
their plain versions.

Three hand-written CUDA kernels (``ops/csrc/gru_window_smem.cu``, in the
kernel library of ops.library) carry a parity K1 or K2 as two launches:

* :func:`bigru_window_proj_in1` / :func:`bigru_window_proj_in2`: the input
  projection ``xp = x @ W_ih + b_ih`` of both directions over the window's
  ``T * B`` rows, into a ``(2, T, B, 3H)`` float32 scratch; ``x`` is the
  ``(B, L, F)`` uint8 image read in place at column ``start`` (K1) or the
  previous layer's halves ``[xa | xb]`` (K2);
* :func:`bigru_window_rec_smem`: the recurrence of both directions over that
  scratch, each block holding its direction's ``W_hh`` in shared memory.

Each output sum is taken in the order of ``bigru_window_kernel``'s FMA
chains (``gru_window.cu``), so on the card the pair equals the one-launch
K1/K2 bit for bit. :func:`ops.gru_window.bigru_window_in1` and ``_in2`` launch them
where :func:`takes_smem_design` holds, a fixed rule of the shape: the parity
tier, and a ``W_hh`` plus state buffers that fit one block's opt-in shared
memory at :func:`rec_block_rows` rows (up to H=136 at 8 rows). Every other
parity shape (H > 136) keeps ``bigru_window_kernel``.

The fast tier's K1f/K2f take the same two-launch shape on bf16 tensor
cores (``ops/csrc/gru_window_fast.cu``): :func:`bigru_window_proj_in1_fast`
/ :func:`bigru_window_proj_in2_fast`, the projection as a bf16
``mma.sync`` product with float32 sums into the same scratch (K2f's halves
rounded to bf16 on the way), then :func:`bigru_window_rec_fast`, the
recurrence with the direction's bf16 ``W_hh`` held as ``mma.sync`` A
fragments in each block's registers. The tensor cores sum in their own
order, so the fast pair agrees with ``bigru_window_kernel<FAST>`` and with
the fast plain versions to ``FAST_TOL`` (1e-3), not bit for bit.
:func:`takes_smem_design` takes them where :func:`fast_rec_fits` holds (H
<= :data:`FAST_REC_MAX_H`, any batch).

On a CPU tensor each wrapper computes its plain version
(:func:`window_proj_plain`, the projection summed in k order, on
bf16-rounded rows in the fast tier; ``gru_scan`` for the recurrence, the
fast cell for a bf16 ``w_hh``); on a CUDA tensor it launches its kernel or
raises. Each launch adds one to :data:`launch_counts`, the dict that
``ops.gru_window`` exports as its own (K1/K2 and K5 count there too).
"""
from __future__ import annotations

from ctypes import c_int as i, c_longlong as ll, c_void_p as p
from typing import Dict

import torch

from helen_tpu_torch.models.gru import bf16_round, gru_scan, ordered_product
from helen_tpu_torch.ops import library
from helen_tpu_torch.ops.library import (
    HOPPER_SMEM_OPTIN,
    Layer,
    Outputs,
    check,
    cuda_device,
    empty,
    get_lib,
    layer_args,
    outputs,
    raise_on,
    stream,
)

#: launches of each kernel since the last ``gru_window.reset_launch_counts()``
#: — counted where the kernel is launched and nowhere else: K1/K2 and K1f/K2f
#: (ops.gru_window) whichever design ran, the kernels of their two-launch
#: design (here), and K5/K5f (ops.gru_window_encdec). ``ops.gru_window``
#: holds it as its ``launch_counts``.
launch_counts: Dict[str, int] = {"bigru_window_in1": 0, "bigru_window_in2": 0,
                                 # the two-launch design of K1/K2
                                 "bigru_window_proj_in1": 0, "bigru_window_proj_in2": 0,
                                 "bigru_window_rec_smem": 0,
                                 "bigru_window_in1_fast": 0, "bigru_window_in2_fast": 0,
                                 # the two-launch design of K1f/K2f
                                 "bigru_window_proj_in1_fast": 0,
                                 "bigru_window_proj_in2_fast": 0, "bigru_window_rec_fast": 0,
                                 # the fused encoder+decoder window (ops.gru_window_encdec):
                                 # K5/K5f per call, then the kernel of its design
                                 "transducer_window_encdec": 0,
                                 "transducer_window_encdec_fast": 0,
                                 "transducer_window_encdec_cluster": 0,
                                 "transducer_window_encdec_cluster_fast": 0,
                                 "transducer_window_encdec_onepass": 0,
                                 "transducer_window_encdec_onepass_fast": 0}

#: the streaming multiprocessors of an H100, which one wave of recurrence
#: blocks (one per SM: its shared memory) should fill
H100_SMS = 132
#: the batch rows per recurrence block the kernel is built for, fewest first
BLOCK_ROWS = (1, 2, 4, 8)
#: threads per hidden unit at 2 rows per block and more (csrc REC_SPLIT)
REC_SPLIT = 2
#: the recurrence's most threads per block (csrc REC_MAX_THREADS)
REC_MAX_THREADS = 320
#: the fast recurrence's largest hidden size: a warp's 16 units hold their
#: W_hh^T rows as 3 x ceil(H / 32) x 2 x 4 registers (csrc FR_MAX_H)
FAST_REC_MAX_H = 160
#: the fast recurrence's xp ring: steps in flight (csrc FR_STAGES)
FAST_REC_STAGES = 4


def rec_smem_bytes(h: int, rows: int) -> int:
    """Dynamic shared memory of one recurrence block: h double-buffered
    (``rows`` rows of ``h`` rounded up to 4 floats) and one direction's
    ``W_hh`` ``(h, 3h)``, float32; csrc/gru_window_smem.cu ``rec_smem``."""
    return 4 * (2 * rows * (-(-h // 4) * 4) + 3 * h * h)


def rec_block_rows(b: int) -> int:
    """Batch rows per recurrence block at batch ``b``: the fewest of 1, 2,
    4, 8 whose grid of ``2 * ceil(b / rows)`` blocks fits the H100's 132 SMs
    in one wave, else 8. 8 at B=512 (128 blocks), 4 at B=256 (128 blocks)."""
    for rows in BLOCK_ROWS:
        if 2 * -(-b // rows) <= H100_SMS:
            return rows
    return BLOCK_ROWS[-1]


def rec_fits_smem(h: int, rows: int, budget: int = 0) -> bool:
    """Whether the recurrence takes hidden size ``h`` at ``rows`` rows per
    block: its shared memory within ``budget`` bytes (default
    :data:`HOPPER_SMEM_OPTIN`) and its threads within the launch bound."""
    threads = (REC_SPLIT if rows >= 2 else 1) * h
    return (h > 0 and threads <= REC_MAX_THREADS
            and rec_smem_bytes(h, rows) <= (budget or HOPPER_SMEM_OPTIN))


def fast_rec_smem_bytes(h: int) -> int:
    """Dynamic shared memory of one fast recurrence block: the bf16 ``W_hh``
    staging area (``h`` rounded up to 32 k rows of 3 x ``h`` rounded up to
    16 units, plus 8 columns), over which the xp ring of
    :data:`FAST_REC_STAGES` x 12 floats a thread later lies, and the bf16 h
    tile, 2 x 8 rows of ``h`` rounded up to 32 plus 8; csrc/gru_window_fast.cu
    ``fr_smem``."""
    up, kp = -(-h // 16) * 16, -(-h // 32) * 32
    staging = 2 * kp * (3 * up + 8)
    ring = 4 * FAST_REC_STAGES * 12 * (up // 16 * 32)
    return max(staging, ring) + 2 * 2 * BLOCK_ROWS[-1] * (kp + 8)


def fast_rec_fits(h: int, budget: int = 0) -> bool:
    """Whether the fast recurrence takes hidden size ``h``: its A fragments
    within a thread's registers (``h`` <= :data:`FAST_REC_MAX_H`) and its
    shared memory within ``budget`` bytes (default
    :data:`HOPPER_SMEM_OPTIN`). The batch does not enter: a block holds at
    most 8 rows at every :func:`rec_block_rows`."""
    return (0 < h <= FAST_REC_MAX_H
            and fast_rec_smem_bytes(h) <= (budget or HOPPER_SMEM_OPTIN))


def takes_smem_design(h: int, b: int, fast: bool = False) -> bool:
    """Whether a K1/K2 (K1f/K2f with ``fast``) of hidden size ``h`` at batch
    ``b`` runs as the projection pass plus a recurrence: in the parity tier
    where ``W_hh`` and the state fit one block at :func:`rec_block_rows`
    rows, in the fast tier where :func:`fast_rec_fits` holds."""
    return fast_rec_fits(h) if fast else rec_fits_smem(h, rec_block_rows(b))


_PROJ_IN1 = (i, [p, ll, ll, i, i] + [p] * 5 + [i, i, i, p])
_PROJ_IN2 = (i, [p] * 7 + [i, i, i, p])
_REC = (i, [p] * 11 + [i, i, i, i, p])
#: the C entries of csrc/gru_window_smem.cu's projection and recurrence and
#: of their fast-tier counterparts in csrc/gru_window_fast.cu (bf16 weights)
ENTRIES = {
    "bigru_window_proj_in1": _PROJ_IN1, "bigru_window_proj_in2": _PROJ_IN2,
    "bigru_window_rec_smem": _REC,
    "bigru_window_rec_smem_bytes": (ll, [i, i]),
    "bigru_window_rec_max_threads": (i, []),
    "bigru_window_proj_in1_fast": _PROJ_IN1, "bigru_window_proj_in2_fast": _PROJ_IN2,
    "bigru_window_rec_fast": _REC,
    "bigru_window_rec_fast_smem_bytes": (ll, [i]),
    "bigru_window_rec_fast_max_h": (i, []),
}


def check_fit(lib) -> None:
    """Raise where the recurrences' fit rules disagree with the sources'."""
    if (lib.bigru_window_rec_max_threads() != REC_MAX_THREADS
            or any(lib.bigru_window_rec_smem_bytes(h, r) != rec_smem_bytes(h, r)
                   for h in (1, 127, 128, 136, 137) for r in BLOCK_ROWS)):
        raise RuntimeError("the recurrence's fit disagrees with csrc/gru_window_smem.cu")
    if (lib.bigru_window_rec_fast_max_h() != FAST_REC_MAX_H
            or any(lib.bigru_window_rec_fast_smem_bytes(h) != fast_rec_smem_bytes(h)
                   for h in (1, 16, 37, 128, 136, 160))):
        raise RuntimeError("the fast recurrence's fit disagrees with csrc/gru_window_fast.cu")


library.register(ENTRIES, check_fit)


# ---------------------------------------------------------------------------
# plain versions (CPU path, tests, and the on-card comparison)
# ---------------------------------------------------------------------------

def bidir(xp_f, xp_b, h0_f, h0_b, layer: Layer, product=None) -> Outputs:
    """Both directions' ``gru_scan`` over their projected streams: forward
    over ``xp_f``, reversed over ``xp_b`` (the fast cell for a bf16
    ``w_hh``; ``product`` the step product's order)."""
    f, b = layer["fwd"], layer["bwd"]
    out_f, hf = gru_scan(xp_f, h0_f, f["w_hh"], f["b_hh"], product=product)
    out_b, hb = gru_scan(xp_b, h0_b, b["w_hh"], b["b_hh"], reverse=True, product=product)
    return out_f, out_b, hf, hb


def window_proj_plain(x: torch.Tensor, layer: Layer) -> torch.Tensor:
    """The projection's plain version: ``x (T, B, D)`` times each
    direction's ``w_ih``, summed over k in order (``ordered_product``), plus
    ``b_ih``; returns ``(2, T, B, 3H)``. A bf16 ``w_ih`` (the fast tier)
    enters as its float32 values: pass bf16-rounded rows for the fast
    projection."""
    return torch.stack([ordered_product(x, layer[d]["w_ih"].to(x.dtype)) + layer[d]["b_ih"]
                        for d in ("fwd", "bwd")])


def window_rec_plain(xp: torch.Tensor, h0_f: torch.Tensor, h0_b: torch.Tensor,
                     layer: Layer) -> Outputs:
    """The recurrence's plain version: ``gru_scan`` over ``xp[0]`` forward
    and ``xp[1]`` backward (the fast cell for a bf16 ``w_hh``)."""
    return bidir(xp[0], xp[1], h0_f, h0_b, layer)


def image_window(image: torch.Tensor, start: int, T: int) -> torch.Tensor:
    """K1's input rows ``(T, B, F)`` float32: the window of the image."""
    return image[:, start:start + T].to(torch.float32).transpose(0, 1)


# ---------------------------------------------------------------------------
# launches (the arguments checked by the caller) and kernel wrappers
# ---------------------------------------------------------------------------

def launch_proj_in1(image, start, T, F, H, w, dev, fast: bool = False) -> torch.Tensor:
    """K1's (K1f's) projection into a new scratch; ``w`` the pointers of
    ``library.layer_args``."""
    name = "bigru_window_proj_in1" + ("_fast" if fast else "")
    B = image.shape[0]
    xp = empty(dev, 2, T, B, 3 * H)
    with torch.cuda.device(dev):
        err = getattr(get_lib(), name)(
            image.data_ptr(), image.stride(0), image.stride(1), start, F,
            w[0], w[2], w[4], w[6], xp.data_ptr(), T, B, H, stream(dev))
    raise_on(err, name)
    launch_counts[name] += 1
    return xp


def launch_proj_in2(xa, xb, w, dev, fast: bool = False) -> torch.Tensor:
    """K2's (K2f's) projection into a new scratch."""
    name = "bigru_window_proj_in2" + ("_fast" if fast else "")
    T, B, H = xa.shape
    xp = empty(dev, 2, T, B, 3 * H)
    with torch.cuda.device(dev):
        err = getattr(get_lib(), name)(
            xa.data_ptr(), xb.data_ptr(), w[0], w[2], w[4], w[6], xp.data_ptr(), T, B, H,
            stream(dev))
    raise_on(err, name)
    launch_counts[name] += 1
    return xp


def launch_rec(xp, h0_f, h0_b, w, dev, fast: bool = False) -> Outputs:
    """The recurrence over the scratch ``xp`` at :func:`rec_block_rows`
    rows per block: ``bigru_window_rec_smem``, or ``bigru_window_rec_fast``
    with ``fast``."""
    name = "bigru_window_rec_fast" if fast else "bigru_window_rec_smem"
    _, T, B, H3 = xp.shape
    H = H3 // 3
    outs = outputs(T, B, H, dev)
    with torch.cuda.device(dev):
        err = getattr(get_lib(), name)(
            xp.data_ptr(), h0_f.data_ptr(), h0_b.data_ptr(), w[1], w[3], w[5], w[7],
            *[o.data_ptr() for o in outs], T, B, H, rec_block_rows(B), stream(dev))
    raise_on(err, name)
    launch_counts[name] += 1
    return outs


def _fits(name: str, H: int, B: int, fast: bool) -> None:
    if takes_smem_design(H, B, fast):
        return
    if fast:
        raise ValueError(f"{name}: H={H} exceeds the fast recurrence's maximum "
                         f"{FAST_REC_MAX_H} (its W_hh^T in a warp's registers); "
                         "bigru_window_kernel<FAST> takes it")
    rows = rec_block_rows(B)
    raise ValueError(f"{name}: W_hh at H={H} and {rows} rows per block take "
                     f"{rec_smem_bytes(H, rows)} bytes of shared memory (budget "
                     f"{HOPPER_SMEM_OPTIN}) or {REC_SPLIT * H} threads (max "
                     f"{REC_MAX_THREADS}); bigru_window_kernel takes it")


def _wdtype(fast: bool) -> torch.dtype:
    return torch.bfloat16 if fast else torch.float32


def _proj_in1(image, start, T, layer, fast) -> torch.Tensor:
    if image.device.type == "cpu":
        x = image_window(image, start, T)
        return window_proj_plain(bf16_round(x) if fast else x, layer)
    name = "bigru_window_proj_in1" + ("_fast" if fast else "")
    dev = cuda_device(image, name)
    if image.dtype != torch.uint8 or image.dim() != 3 or image.stride(2) != 1:
        raise ValueError(f"{name} takes a (B, L, F) uint8 image with unit feature stride")
    B, L, F = image.shape
    H = layer["fwd"]["w_hh"].shape[0]
    if not (0 <= start and start + T <= L and T > 0):
        raise ValueError(f"window [{start}, {start + T}) of {L} columns")
    return launch_proj_in1(image, start, T, F, H,
                           layer_args(layer, F, H, dev, _wdtype(fast)), dev, fast)


def _proj_in2(xa, xb, layer, fast) -> torch.Tensor:
    if xa.device.type == "cpu":
        x = torch.cat([xa, xb], dim=-1)
        return window_proj_plain(bf16_round(x) if fast else x, layer)
    dev = cuda_device(xa, "bigru_window_proj_in2" + ("_fast" if fast else ""))
    T, B, H = xa.shape
    check("xa", xa, (T, B, H), torch.float32, dev)
    check("xb", xb, (T, B, H), torch.float32, dev)
    return launch_proj_in2(xa, xb, layer_args(layer, 2 * H, H, dev, _wdtype(fast)), dev,
                           fast)


def _rec(xp, h0_f, h0_b, layer, fast) -> Outputs:
    if xp.device.type == "cpu":
        return window_rec_plain(xp, h0_f, h0_b, layer)
    name = "bigru_window_rec_fast" if fast else "bigru_window_rec_smem"
    dev = cuda_device(xp, name)
    _, T, B, H3 = xp.shape
    H = H3 // 3
    _fits(name, H, B, fast)
    check("xp", xp, (2, T, B, 3 * H), torch.float32, dev)
    check("h0_f", h0_f, (B, H), torch.float32, dev)
    check("h0_b", h0_b, (B, H), torch.float32, dev)
    w_ih = layer["fwd"]["w_ih"]
    return launch_rec(xp, h0_f, h0_b,
                      layer_args(layer, w_ih.shape[0], H, dev, _wdtype(fast)), dev, fast)


def bigru_window_proj_in1(image: torch.Tensor, start: int, T: int,
                          layer: Layer) -> torch.Tensor:
    """K1's projection of the window ``image[:, start:start+T]`` of a
    ``(B, L, F)`` uint8 image: ``(2, T, B, 3H)``."""
    return _proj_in1(image, start, T, layer, False)


def bigru_window_proj_in2(xa: torch.Tensor, xb: torch.Tensor, layer: Layer) -> torch.Tensor:
    """K2's projection of the halves ``xa``, ``xb`` ``(T, B, H)``:
    ``(2, T, B, 3H)``."""
    return _proj_in2(xa, xb, layer, False)


def bigru_window_rec_smem(xp: torch.Tensor, h0_f: torch.Tensor, h0_b: torch.Tensor,
                          layer: Layer) -> Outputs:
    """The recurrence of both directions over ``xp (2, T, B, 3H)`` from
    ``h0_f``/``h0_b``: ``(out_f, out_b, h_f, h_b)``, as K1/K2 return them."""
    return _rec(xp, h0_f, h0_b, layer, False)


def bigru_window_proj_in1_fast(image: torch.Tensor, start: int, T: int,
                               layer: Layer) -> torch.Tensor:
    """K1f's projection (bf16 ``w_ih``, on bf16 tensor cores): the window of
    the uint8 image, exact in bf16, times ``w_ih`` plus ``b_ih``:
    ``(2, T, B, 3H)`` float32."""
    return _proj_in1(image, start, T, layer, True)


def bigru_window_proj_in2_fast(xa: torch.Tensor, xb: torch.Tensor,
                               layer: Layer) -> torch.Tensor:
    """K2f's projection: the halves ``xa``, ``xb`` ``(T, B, H)`` rounded to
    bf16, times the bf16 ``w_ih``, plus ``b_ih``: ``(2, T, B, 3H)``."""
    return _proj_in2(xa, xb, layer, True)


def bigru_window_rec_fast(xp: torch.Tensor, h0_f: torch.Tensor, h0_b: torch.Tensor,
                          layer: Layer) -> Outputs:
    """The fast recurrence of both directions over ``xp (2, T, B, 3H)``,
    the layer's bf16 ``w_hh`` on bf16 tensor cores: ``(out_f, out_b, h_f,
    h_b)``, as K1f/K2f return them."""
    return _rec(xp, h0_f, h0_b, layer, True)
