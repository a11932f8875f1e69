"""The fast tier's two-launch design of K1f/K2f (ops.gru_window_smem,
csrc/gru_window_fast.cu): its shape rule, its Python/C fit constants, and
the plain versions of its two kernels composed, on the CPU.

The projection pass's plain version is ``window_proj_plain`` on bf16-rounded
rows (the uint8 image is exact in bf16; K2f's halves are rounded), the
recurrence's ``window_rec_plain`` with the bf16 ``w_hh`` (the fast cell).
Composed, they are the fast plain K1f/K2f bit for bit: the same ops in the
same order. They are held against helen_tpu's ``bigru_apply_inproj(...,
fast=True, interpret=True)`` as tests/test_torch_fast.py holds the fast
plain versions, to 1e-3 (a bf16 rounding of h one ulp apart where two sums
run in another order, 2^-8 relative, times a weight of at most 1/sqrt(H)).
The kernels themselves sum on the tensor cores in their own order and run
only on a CUDA device (tests/test_torch_cuda.py, chip_smoke.py phase 10a),
within the same 1e-3 of these plain versions.
"""
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_fast import F, close, fast_layer, make_layer, to_jax

torch.set_num_threads(2)

# the flagship H at a ragged batch, an off-grid H, the widest H the fast
# recurrence takes, and a small one its 16-unit warps pad
SHAPES = [(8, 13, 128), (5, 8, 160), (6, 3, 40)]


def k1f_case(T, B, H, seed):
    rng = np.random.default_rng(seed)
    L, start = T + 7, 4
    image = rng.integers(0, 256, size=(B, L, F), dtype=np.uint8)
    h0f, h0b = (rng.uniform(-1, 1, (B, H)).astype(np.float32) for _ in range(2))
    return image, start, h0f, h0b, make_layer(rng, F, H, w_ih_scale=1 / 64)


def k2f_case(T, B, H, seed):
    rng = np.random.default_rng(seed)
    xa, xb = (rng.standard_normal((T, B, H)).astype(np.float32) for _ in range(2))
    h0f, h0b = (rng.uniform(-1, 1, (B, H)).astype(np.float32) for _ in range(2))
    return xa, xb, h0f, h0b, make_layer(rng, 2 * H, H)


def composed_in1(image, start, T, h0f, h0b, layer):
    from helen_tpu_torch.ops import gru_window_smem as gs

    xp = gs.bigru_window_proj_in1_fast(image, start, T, layer)
    assert xp.shape == (2, T, image.shape[0], 3 * h0f.shape[1]) and xp.dtype == torch.float32
    return gs.bigru_window_rec_fast(xp, h0f, h0b, layer)


def composed_in2(xa, xb, h0f, h0b, layer):
    from helen_tpu_torch.ops import gru_window_smem as gs

    return gs.bigru_window_rec_fast(gs.bigru_window_proj_in2_fast(xa, xb, layer), h0f, h0b,
                                    layer)


# ---------------------------------------------------------------------------
# the rule and its constants
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("H,B,want", [
    (128, 512, True), (128, 256, True), (128, 300, True), (128, 1, True),
    (160, 512, True), (136, 13, True), (37, 7, True), (16, 4, True),
    (161, 512, False), (256, 256, False), (512, 512, False),
])
def test_fast_design_rule(H, B, want):
    """K1f/K2f take the two-launch design up to H=160 (the flagship's 128
    at the polish and the training batch, the golden l2_h128 and h160
    geometries), at any batch; the one-launch kernel beyond."""
    from helen_tpu_torch.ops import gru_window as gw
    from helen_tpu_torch.ops import gru_window_smem as gs

    assert gs.fast_rec_fits(H) is want
    assert gs.takes_smem_design(H, B, fast=True) is want
    assert gw.window_design(H, B, fast=True) == ("smem" if want else "chain")


@pytest.mark.parametrize("H,want", [
    (1, 7_424), (16, 7_424), (37, 21_760), (128, 104_704), (136, 146_176),
    (160, 161_536),
])
def test_fast_recurrence_shared_memory(H, want):
    """The bf16 W_hh staging area (H rounded up to 32 k rows of 3 x H
    rounded up to 16 columns, + 8), or the xp ring over it where that is
    larger (4 stages x 12 floats x 32 threads per 16 units), then the bf16
    h tile (2 x 8 rows of H rounded up to 32, + 8); all within the card's
    opt-in 232,448 bytes up to FAST_REC_MAX_H."""
    from helen_tpu_torch.ops import gru_window_smem as gs

    up, kp = -(-H // 16) * 16, -(-H // 32) * 32
    assert gs.fast_rec_smem_bytes(H) == want
    assert want == max(2 * kp * (3 * up + 8), 4 * 4 * 12 * 2 * up) + 2 * 2 * 8 * (kp + 8)
    assert gs.fast_rec_fits(H) and not gs.fast_rec_fits(H, budget=want - 1)


def test_fast_constants_match_the_source():
    """The Python rule's constants are the ones csrc/gru_window_fast.cu is
    built with (get_lib() checks the sizes against the built library on the
    card as well)."""
    from helen_tpu_torch.ops import gru_window_smem as gs
    from helen_tpu_torch.ops import library

    with open(os.path.join(library.CSRC, "gru_window_fast.cu")) as f:
        text = f.read()
    const = {m[0]: int(m[1]) for m in re.findall(r"constexpr int (FR_\w+) = (\d+);", text)}
    assert const["FR_MAX_H"] == gs.FAST_REC_MAX_H
    assert const["FR_STAGES"] == gs.FAST_REC_STAGES
    assert const["FR_ROWS"] == gs.BLOCK_ROWS[-1]
    for fn in ("bigru_window_proj_in1_fast", "bigru_window_proj_in2_fast",
               "bigru_window_rec_fast", "bigru_window_rec_fast_smem_bytes",
               "bigru_window_rec_fast_max_h"):
        assert f" {fn}(" in text, fn
    with open(os.path.join(library.CSRC, "gru_window_xp_grid.cu")) as f:
        grid = f.read()
    # K3f and the fast pair share one copy of the mma helpers
    assert '#include "gru_window_mma.cuh"' in grid and '#include "gru_window_mma.cuh"' in text
    assert "void mma_bf16(" not in grid and "void mma_bf16(" not in text


# ---------------------------------------------------------------------------
# the plain versions composed
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("T,B,H", SHAPES)
def test_composed_plain_equals_fast_plain_k1f(T, B, H):
    from helen_tpu_torch.ops.gru_window import bigru_window_in1_fast_plain

    image, start, h0f, h0b, layer = k1f_case(T, B, H, seed=T + H)
    args = (torch.from_numpy(image), start, T, torch.from_numpy(h0f), torch.from_numpy(h0b),
            fast_layer(layer))
    for g, w in zip(composed_in1(*args), bigru_window_in1_fast_plain(*args)):
        assert torch.equal(g, w)


@pytest.mark.parametrize("T,B,H", SHAPES)
def test_composed_plain_equals_fast_plain_k2f(T, B, H):
    from helen_tpu_torch.ops.gru_window import bigru_window_in2_fast_plain

    xa, xb, h0f, h0b, layer = k2f_case(T, B, H, seed=2 * T + H)
    args = (*(torch.from_numpy(a) for a in (xa, xb, h0f, h0b)), fast_layer(layer))
    for g, w in zip(composed_in2(*args), bigru_window_in2_fast_plain(*args)):
        assert torch.equal(g, w)


@pytest.mark.parametrize("T,B,H", SHAPES)
def test_composed_plain_matches_pallas_inproj1_fast(T, B, H):
    """Projection then recurrence against ``_kernel_inproj1`` with
    ``fast=True`` in interpret mode, on a uint8 window over the full byte
    range."""
    from helen_tpu.ops.gru_pallas import bigru_apply_inproj

    image, start, h0f, h0b, layer = k1f_case(T, B, H, seed=3 * T + H)
    x = jnp.asarray(image[:, start:start + T].transpose(1, 0, 2).astype(np.float32))
    want = bigru_apply_inproj(to_jax(layer), x, jnp.asarray(h0f), jnp.asarray(h0b),
                              fast=True, exact_input=True, interpret=True)
    got = composed_in1(torch.from_numpy(image), start, T, torch.from_numpy(h0f),
                       torch.from_numpy(h0b), fast_layer(layer))
    for g, w, what in zip(got, want, ("out_f", "out_b", "h_f", "h_b")):
        close(g, w, what)


@pytest.mark.parametrize("T,B,H", SHAPES)
def test_composed_plain_matches_pallas_inproj2_fast(T, B, H):
    """Projection then recurrence against the pair form of
    ``bigru_apply_inproj`` with ``fast=True`` (``_kernel_inproj2``)."""
    from helen_tpu.ops.gru_pallas import bigru_apply_inproj

    xa, xb, h0f, h0b, layer = k2f_case(T, B, H, seed=4 * T + H)
    want = bigru_apply_inproj(to_jax(layer), (jnp.asarray(xa), jnp.asarray(xb)),
                              jnp.asarray(h0f), jnp.asarray(h0b), fast=True, interpret=True)
    got = composed_in2(*(torch.from_numpy(a) for a in (xa, xb, h0f, h0b)), fast_layer(layer))
    for g, w, what in zip(got, want, ("out_f", "out_b", "h_f", "h_b")):
        close(g, w, what)


def test_fast_projection_plain_rounds_the_halves_to_bf16():
    """K2f's projection reads its float32 halves rounded to bf16: values a
    bf16 cannot hold project as their rounding, not as themselves."""
    from helen_tpu_torch.models.gru import bf16_round
    from helen_tpu_torch.ops import gru_window_smem as gs

    T, B, H = 3, 2, 8
    xa, xb, _, _, layer = k2f_case(T, B, H, seed=9)
    xa_t, xb_t, fl = torch.from_numpy(xa), torch.from_numpy(xb), fast_layer(layer)
    got = gs.bigru_window_proj_in2_fast(xa_t, xb_t, fl)
    rounded = torch.cat([bf16_round(xa_t), bf16_round(xb_t)], -1)
    assert torch.equal(got, gs.window_proj_plain(rounded, fl))
    assert not torch.equal(got, gs.window_proj_plain(torch.cat([xa_t, xb_t], -1), fl))


# ---------------------------------------------------------------------------
# the wrappers on the CPU
# ---------------------------------------------------------------------------

def test_fast_wrappers_take_the_plain_version_on_cpu_and_count_no_launch():
    from helen_tpu_torch.ops import gru_window as gw

    T, B, H = 5, 8, 128
    image, start, h0f, h0b, layer = k1f_case(T, B, H, seed=11)
    img, hf, hb, fl = (torch.from_numpy(image), torch.from_numpy(h0f),
                       torch.from_numpy(h0b), fast_layer(layer))
    xa, xb, _, _, layer2 = k2f_case(T, B, H, seed=12)
    xa_t, xb_t, fl2 = torch.from_numpy(xa), torch.from_numpy(xb), fast_layer(layer2)
    gw.reset_launch_counts()
    composed_in1(img, start, T, hf, hb, fl)
    composed_in2(xa_t, xb_t, hf, hb, fl2)
    # a forced design changes nothing on the CPU: the plain version runs
    for design in gw.DESIGNS:
        for g, p in zip(gw.bigru_window_in1_fast(img, start, T, hf, hb, fl, design=design),
                        gw.bigru_window_in1_fast_plain(img, start, T, hf, hb, fl)):
            assert torch.equal(g, p)
        for g, p in zip(gw.bigru_window_in2_fast(xa_t, xb_t, hf, hb, fl2, design=design),
                        gw.bigru_window_in2_fast_plain(xa_t, xb_t, hf, hb, fl2)):
            assert torch.equal(g, p)
    assert set(gw.launch_counts.values()) == {0}
    assert {"bigru_window_proj_in1_fast", "bigru_window_proj_in2_fast",
            "bigru_window_rec_fast"} <= set(gw.launch_counts)


def test_fast_wrappers_raise_off_cpu_and_cuda():
    from helen_tpu_torch.ops import gru_window_smem as gs

    T, B, H = 3, 2, 128
    meta = lambda *s, dt=torch.float32: torch.empty(s, dtype=dt, device="meta")  # noqa: E731
    layer = {d: {"w_ih": meta(F, 3 * H, dt=torch.bfloat16),
                 "w_hh": meta(H, 3 * H, dt=torch.bfloat16), "b_ih": meta(3 * H),
                 "b_hh": meta(3 * H)} for d in ("fwd", "bwd")}
    with pytest.raises(ValueError, match="CUDA or CPU"):
        gs.bigru_window_proj_in1_fast(meta(B, 10, F, dt=torch.uint8), 0, T, layer)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        gs.bigru_window_proj_in2_fast(meta(T, B, H), meta(T, B, H), layer)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        gs.bigru_window_rec_fast(meta(2, T, B, 3 * H), meta(B, H), meta(B, H), layer)


def test_fast_variants_edit_the_shipped_source():
    """helen_tpu_torch.obs.fast_variants (the measurement of where the fast
    recurrence's time goes) edits the shipped source: every constant and
    every text it replaces is there, and off the card it refuses."""
    from helen_tpu_torch.obs import fast_variants as fv
    from helen_tpu_torch.obs.grid_variants import variant_source
    from helen_tpu_torch.ops import library

    with open(os.path.join(library.CSRC, fv.SOURCE)) as f:
        src = f.read()
    for name, (consts, edits) in fv.VARIANTS.items():
        out = variant_source(src, consts, edits, fv.SOURCE)
        assert (out == src) == (name == "shipped"), name
    assert fv.main(["--iters", "1"]) == 1
