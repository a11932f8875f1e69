"""The fused encoder+decoder window: the kernel's binding, its fit
functions, its plain versions and helen_tpu's library entry.

One hand-written CUDA kernel (``ops/csrc/gru_window_encdec.cu``, in the
library that ops.gru_window builds) runs one transducer window of a model
with one encoder and one decoder bi-GRU layer in one launch:

* :func:`transducer_window_encdec` (K5, replaces helen_tpu's
  ``_kernel_fused_encdec``, ``helen_tpu/ops/gru_pallas.py:756``): the
  encoder layer on the ``(B, L, F)`` uint8 image at column ``start`` (K1's
  function), then the decoder layer on the encoder's two output halves (K2's
  function), which stay in the block's shared memory; the decoder's h0 is
  the encoder's final state;
* :func:`transducer_window_encdec_fast` (K5f): the same with ``fast=True``,
  on the layers' bf16 ``w_ih``/``w_hh`` (io.checkpoint.fast_layer), K1f ->
  K2f's function; the boundary is held rounded to bf16, where K2f rounds it.

Both return the DECODER's ``(out_f (T, B, H), out_b (T, B, H), h_f (B, H),
h_b (B, H))``. On a CPU tensor they compute their plain versions (the
chained plain layers of ops.gru_window); on a CUDA tensor they launch the
kernel or raise. A geometry whose block does not fit one block's shared
memory (:func:`encdec_fits_smem`) raises on both: nothing falls back to the
chained kernels. Each launch adds one to ``ops.gru_window.launch_counts``.

The kernel is on no dispatch path: ``models.transducer.forward`` runs it
only for ``route="encdec"`` (library only, inference only), as helen_tpu
keeps its fused kernel off its own dispatch.
"""
from __future__ import annotations

import torch

from helen_tpu_torch.io.checkpoint import fast_layer
from helen_tpu_torch.ops import gru_window as gw
from helen_tpu_torch.ops.gru_window import (
    MAX_H,
    Layer,
    Outputs,
    bigru_window_in1_fast_plain,
    bigru_window_in1_plain,
    bigru_window_in2_fast_plain,
    bigru_window_in2_plain,
)

#: the dynamic shared memory a block may opt in to on Hopper (H100 and H200:
#: 232,448 bytes), the fit functions' budget off the card; on the card the
#: wrapper reads the device's own limit
HOPPER_SMEM_OPTIN = 232_448
#: the batch rows per block the kernel is built for, most first
BLOCK_ROWS = (4, 2, 1)


def encdec_max_threads(bt: int) -> int:
    """The most threads (2H, both directions) a block of ``bt`` rows takes:
    1024 at up to 2 rows (64 registers per thread), 512 at 4 (128 registers
    for its 24 accumulators); csrc/gru_window_encdec.cu ``encdec_max_threads``."""
    return MAX_H if bt >= 4 else 2 * MAX_H


def encdec_smem_bytes(h: int, bt: int, d: int, t: int, fast: bool) -> int:
    """Dynamic shared memory of one K5 block of ``bt`` batch rows: h of both
    directions, double-buffered (and its bf16 operand copy in the fast
    tier), the encoder's double-buffered input rows of width ``d``, and the
    boundary, both directions' ``(t, bt, h)`` encoder outputs: float32, or
    bf16 in the fast tier, which stores them already rounded (exact: K2f
    rounds the same values the same way). The counterpart of helen_tpu's
    ``fused_encdec_vmem_bytes`` (``gru_pallas.py:865``) for this card;
    csrc/gru_window_encdec.cu ``encdec_smem``."""
    return 4 * 4 * bt * (h * (2 if fast else 1) + d) + 2 * t * bt * h * (2 if fast else 4)


def encdec_block_rows(h: int, d: int, t: int, fast: bool, budget: int = 0) -> int:
    """The most batch rows per block (4, 2 or 1) whose K5 block fits
    ``budget`` bytes of shared memory (default :data:`HOPPER_SMEM_OPTIN`)
    and the block's thread limit, or 0 if none does: the counterpart of
    helen_tpu's ``_pick_block_fused_target`` (``gru_pallas.py:878``)."""
    budget = budget or HOPPER_SMEM_OPTIN
    for bt in BLOCK_ROWS:
        if 2 * h <= encdec_max_threads(bt) and encdec_smem_bytes(h, bt, d, t, fast) <= budget:
            return bt
    return 0


def encdec_fits_smem(h: int, d: int, t: int, fast: bool, budget: int = 0) -> bool:
    """Whether K5 takes hidden size ``h``, input width ``d`` and window ``t``
    (helen_tpu's ``fused_encdec_fits_vmem``, ``gru_pallas.py:891``)."""
    return encdec_block_rows(h, d, t, fast, budget) > 0


def device_smem_budget() -> int:
    """The current CUDA device's opt-in shared memory per block, in bytes."""
    return gw.get_lib().gru_window_smem_optin()


# ---------------------------------------------------------------------------
# plain versions (CPU path, tests, and the on-card comparison)
# ---------------------------------------------------------------------------

def transducer_window_encdec_plain(image: torch.Tensor, start: int, T: int,
                                   h0_f: torch.Tensor, h0_b: torch.Tensor,
                                   enc: Layer, dec: Layer) -> Outputs:
    """K5's plain version: K1's plain layer on the window, then K2's on its
    halves, seeded with its final states."""
    of, ob, hf, hb = bigru_window_in1_plain(image, start, T, h0_f, h0_b, enc)
    return bigru_window_in2_plain(of, ob, hf, hb, dec)


def transducer_window_encdec_fast_plain(image: torch.Tensor, start: int, T: int,
                                        h0_f: torch.Tensor, h0_b: torch.Tensor,
                                        enc: Layer, dec: Layer) -> Outputs:
    """K5f's plain version: K1f's plain layer, then K2f's."""
    of, ob, hf, hb = bigru_window_in1_fast_plain(image, start, T, h0_f, h0_b, enc)
    return bigru_window_in2_fast_plain(of, ob, hf, hb, dec)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def _encdec(name: str, fast: bool, image, start, T, h0_f, h0_b, enc, dec) -> Outputs:
    on_cuda = image.device.type == "cuda"
    if not on_cuda and image.device.type != "cpu":
        raise ValueError(f"{name} runs on CUDA or CPU tensors, got {image.device}")
    F, H = image.shape[-1], h0_f.shape[-1]
    budget = device_smem_budget() if on_cuda else HOPPER_SMEM_OPTIN
    bt = encdec_block_rows(H, F, T, fast, budget)
    if not bt:
        raise ValueError(
            f"{name}: H={H}, T={T}, F={F} does not fit one block's {budget} bytes of "
            f"shared memory ({encdec_smem_bytes(H, 1, F, T, fast)} at 1 row) or "
            f"{encdec_max_threads(1)} threads; the chained kernels take it: "
            'route="inproj"')
    if not on_cuda:
        plain = transducer_window_encdec_fast_plain if fast else transducer_window_encdec_plain
        return plain(image, start, T, h0_f, h0_b, enc, dec)
    if image.dtype != torch.uint8 or image.dim() != 3 or image.stride(2) != 1:
        raise ValueError(f"{name} takes a (B, L, F) uint8 image with unit feature stride")
    dev = image.device
    B, L, _ = image.shape
    if not (0 <= start and start + T <= L):
        raise ValueError(f"window [{start}, {start + T}) of {L} columns")
    gw._check("h0_f", h0_f, (B, H), torch.float32, dev)
    gw._check("h0_b", h0_b, (B, H), torch.float32, dev)
    wdtype = torch.bfloat16 if fast else torch.float32
    weights = (gw._layer_args(enc, F, H, dev, wdtype)
               + gw._layer_args(dec, 2 * H, H, dev, wdtype))
    outs = gw._outputs(T, B, H, dev)
    with torch.cuda.device(dev):
        err = getattr(gw.get_lib(), name)(
            image.data_ptr(), image.stride(0), image.stride(1), start, F,
            h0_f.data_ptr(), h0_b.data_ptr(), *weights,
            *[o.data_ptr() for o in outs], T, B, H, bt,
            torch.cuda.current_stream(dev).cuda_stream)
    gw._raise_on(err, name)
    gw.launch_counts[name] += 1
    return outs


def transducer_window_encdec(image: torch.Tensor, start: int, T: int,
                             h0_f: torch.Tensor, h0_b: torch.Tensor,
                             enc: Layer, dec: Layer) -> Outputs:
    """K5: the encoder layer ``enc`` over the window ``image[:, start:start+T]``
    of a ``(B, L, F)`` uint8 image from ``h0_f``/``h0_b``, then the decoder
    layer ``dec`` on its halves from its final states, in one launch.
    Returns the decoder's outputs. See the module docstring."""
    return _encdec("transducer_window_encdec", False, image, start, T, h0_f, h0_b, enc, dec)


def transducer_window_encdec_fast(image: torch.Tensor, start: int, T: int,
                                  h0_f: torch.Tensor, h0_b: torch.Tensor,
                                  enc: Layer, dec: Layer) -> Outputs:
    """K5f: K5 in the fast tier, with both layers' bf16 ``w_ih``/``w_hh``."""
    return _encdec("transducer_window_encdec_fast", True, image, start, T, h0_f, h0_b,
                   enc, dec)


def transducer_apply_fused_encdec(enc_params: Layer, dec_params: Layer, x: torch.Tensor,
                                  h0_fwd: torch.Tensor, h0_bwd: torch.Tensor,
                                  fast: bool = False, exact_input: bool = False) -> Outputs:
    """helen_tpu's ``transducer_apply_fused_encdec`` (``gru_pallas.py:1005``),
    with its signature: one window of a 1-layer transducer, ``x`` ``(T, B, D)``
    time-major (uint8 on the card), through K5 (K5f with ``fast``; float32
    layers are cast by :func:`io.checkpoint.fast_layer`). ``x`` reaches the
    kernel as a strided ``(B, T, D)`` view, not a copy. ``exact_input`` is
    helen_tpu's promise that ``x`` is exact in bf16, which its TPU
    projection needs; the port's projection is float32 FMA, exact for such
    values either way, so it changes nothing here. Returns the decoder's
    ``(out_f, out_b, hf, hb)``."""
    del exact_input
    image = x.permute(1, 0, 2)
    if fast:
        enc_params, dec_params = (p if p["fwd"]["w_hh"].dtype == torch.bfloat16
                                  else fast_layer(p) for p in (enc_params, dec_params))
        return transducer_window_encdec_fast(image, 0, x.shape[0], h0_fwd, h0_bwd,
                                             enc_params, dec_params)
    return transducer_window_encdec(image, 0, x.shape[0], h0_fwd, h0_bwd, enc_params,
                                    dec_params)
