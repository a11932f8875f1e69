"""The two-launch design of the parity K1/K2 (ops.gru_window_smem): its plain
versions against helen_tpu's Pallas kernels (interpret mode) and against
K1/K2's plain versions, and the shape rules that pick it.

The plain version of the design is :func:`window_proj_plain` (the
projection of both directions, summed over k in order) followed by
``gru_scan`` per direction. It is held against ``bigru_apply_inproj(...,
interpret=True)`` with the inputs, seeds and tolerance (2e-5) of
tests/test_torch_gru_window.py's K1/K2 cases, and against
``bigru_window_in1_plain``/``_in2_plain`` to 1e-6: the same function, with
the projection's sums taken in k order instead of by a blocked product. The
kernels themselves run only on a CUDA device (tests/test_torch_cuda.py,
where they equal the one-launch K1/K2 bit for bit, and chip_smoke.py).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_gru_window import SHAPES, close, k1_inputs, k2_inputs, to_jax, to_torch

torch.set_num_threads(2)

ORDER_TOL = 1e-6


def design_outputs(x, h0f, h0b, layer):
    """window_proj_plain, then gru_scan forward and backward."""
    from helen_tpu_torch.models.gru import gru_scan
    from helen_tpu_torch.ops.gru_window_smem import window_proj_plain

    xp = window_proj_plain(x, layer)
    assert tuple(xp.shape) == (2,) + tuple(x.shape[:2]) + (layer["fwd"]["w_ih"].shape[1],)
    f, b = layer["fwd"], layer["bwd"]
    out_f, hf = gru_scan(xp[0], h0f, f["w_hh"], f["b_hh"])
    out_b, hb = gru_scan(xp[1], h0b, b["w_hh"], b["b_hh"], reverse=True)
    return out_f, out_b, hf, hb


def assert_order_close(got, want):
    for g, w, what in zip(got, want, ("out_f", "out_b", "h_f", "h_b")):
        torch.testing.assert_close(g, w, rtol=0, atol=ORDER_TOL, msg=what)


@pytest.mark.parametrize("T,B,H", SHAPES)
def test_design_plain_matches_pallas_inproj1(T, B, H):
    from helen_tpu.ops.gru_pallas import bigru_apply_inproj

    from helen_tpu_torch.ops.gru_window import bigru_window_in1_plain
    from helen_tpu_torch.ops.gru_window_smem import image_window

    image, start, h0f, h0b, layer = k1_inputs(T, B, H)
    x = jnp.asarray(image[:, start:start + T].transpose(1, 0, 2).astype(np.float32))
    want = bigru_apply_inproj(to_jax(layer), x, jnp.asarray(h0f), jnp.asarray(h0b),
                              exact_input=True, interpret=True)
    img, hf, hb, lt = (torch.from_numpy(image), torch.from_numpy(h0f),
                       torch.from_numpy(h0b), to_torch(layer))
    got = design_outputs(image_window(img, start, T), hf, hb, lt)
    for g, w, what in zip(got, want, ("out_f", "out_b", "h_f", "h_b")):
        assert tuple(g.shape) == tuple(w.shape), what
        close(g, w, what)
    assert_order_close(got, bigru_window_in1_plain(img, start, T, hf, hb, lt))


@pytest.mark.parametrize("T,B,H", SHAPES)
def test_design_plain_matches_pallas_inproj2(T, B, H):
    from helen_tpu.ops.gru_pallas import bigru_apply_inproj

    from helen_tpu_torch.ops.gru_window import bigru_window_in2_plain

    xa, xb, h0f, h0b, layer = k2_inputs(T, B, H)
    want = bigru_apply_inproj(to_jax(layer), (jnp.asarray(xa), jnp.asarray(xb)),
                              jnp.asarray(h0f), jnp.asarray(h0b), interpret=True)
    xa_t, xb_t, hf, hb = (torch.from_numpy(a) for a in (xa, xb, h0f, h0b))
    lt = to_torch(layer)
    got = design_outputs(torch.cat([xa_t, xb_t], -1), hf, hb, lt)
    for g, w, what in zip(got, want, ("out_f", "out_b", "h_f", "h_b")):
        assert tuple(g.shape) == tuple(w.shape), what
        close(g, w, what)
    assert_order_close(got, bigru_window_in2_plain(xa_t, xb_t, hf, hb, lt))


def test_projection_plain_sums_in_k_order():
    """Each output of window_proj_plain is one float32 sum from 0 over
    k = 0, 1, ... in order, then + b_ih: the kernel's fmaf chain. The
    inputs make every product exact (so a fused and an unfused step round
    alike) and every sum order-dependent (values 2^24 apart)."""
    from helen_tpu_torch.ops.gru_window_smem import window_proj_plain

    rng = np.random.default_rng(5)
    T, B, D, H = 3, 2, 9, 4
    f32 = np.float32
    x = rng.integers(-3, 4, (T, B, D)).astype(f32)
    vals = np.array([2.0 ** 24, -(2.0 ** 24), 1.0, -1.0, 3.0, 0.25], dtype=f32)
    layer = {d: {"w_ih": torch.from_numpy(rng.choice(vals, (D, 3 * H))),
                 "b_ih": torch.from_numpy(rng.choice(vals, 3 * H))}
             for d in ("fwd", "bwd")}
    got = window_proj_plain(torch.from_numpy(x), layer)
    for i, d in enumerate(("fwd", "bwd")):
        w, b = layer[d]["w_ih"].numpy(), layer[d]["b_ih"].numpy()
        acc, rev = np.zeros((T, B, 3 * H), f32), np.zeros((T, B, 3 * H), f32)
        for k in range(D):
            acc = acc + x[..., k:k + 1] * w[k]
            rev = rev + x[..., D - 1 - k:D - k] * w[D - 1 - k]
        np.testing.assert_array_equal(got[i].numpy(), acc + b)
        assert (acc != rev).any()  # the order shows in these sums


@pytest.mark.parametrize("H,B,fast,want", [
    (128, 512, False, True), (136, 512, False, True), (137, 512, False, False),
    (160, 512, False, False), (512, 512, False, False), (128, 256, False, True),
    (137, 256, False, True), (16, 4, False, True),
    # the fast tier: the projection pass plus the bf16 tensor-core
    # recurrence up to H=160 at any batch (gru_window_smem.fast_rec_fits)
    (128, 512, True, True), (136, 256, True, True), (16, 4, True, True),
    (160, 512, True, True), (161, 512, True, False), (512, 512, True, False),
])
def test_smem_design_rule(H, B, fast, want):
    from helen_tpu_torch.ops import gru_window as gw
    from helen_tpu_torch.ops.gru_window_smem import takes_smem_design

    assert takes_smem_design(H, B, fast) is want
    assert gw.window_design(H, B, fast) == ("smem" if want else "chain")


@pytest.mark.parametrize("H,rows,want", [
    (128, 8, 204_800), (136, 8, 230_656), (137, 8, 234_188), (137, 4, 229_708),
    (138, 1, 229_648), (1, 1, 44),
])
def test_recurrence_shared_memory(H, rows, want):
    """W_hh (H x 3H floats) and h double-buffered at rows x H rounded up to
    4 floats; the budget is the card's opt-in 232,448 bytes per block."""
    from helen_tpu_torch.ops.gru_window_smem import (HOPPER_SMEM_OPTIN, rec_fits_smem,
                                                      rec_smem_bytes)

    assert rec_smem_bytes(H, rows) == want
    assert rec_fits_smem(H, rows) is (want <= HOPPER_SMEM_OPTIN)
    assert not rec_fits_smem(H, rows, budget=want - 1)


@pytest.mark.parametrize("B,rows", [(512, 8), (256, 4), (300, 8), (1024, 8), (67, 2),
                                    (66, 1), (13, 1)])
def test_recurrence_block_rows(B, rows):
    """The fewest rows whose 2 * ceil(B / rows) blocks fit 132 SMs in one
    wave, else 8."""
    from helen_tpu_torch.ops.gru_window_smem import rec_block_rows

    assert rec_block_rows(B) == rows
    blocks = 2 * -(-B // rows)
    assert blocks <= 132 or rows == 8
    assert rows == 1 or 2 * -(-B // (rows // 2)) > 132


@pytest.mark.parametrize("fast", [False, True])
def test_forced_design_is_checked(fast):
    from helen_tpu_torch.ops import gru_window as gw

    assert gw.window_design(128, 512, fast=fast, design="chain") == "chain"
    assert gw.window_design(128, 512, fast=fast, design="smem") == "smem"
    too_wide = 161 if fast else 160
    with pytest.raises(ValueError, match=f"does not take H={too_wide}"):
        gw.window_design(too_wide, 512, fast=fast, design="smem")
    if fast:
        with pytest.raises(ValueError, match="fast tier"):
            gw.window_design(512, 512, fast=True, design="smem")
    with pytest.raises(ValueError, match="not one of"):
        gw.window_design(128, 512, fast=fast, design="fused")


def test_wrappers_take_the_plain_version_on_cpu_and_count_no_launch():
    from helen_tpu_torch.ops import gru_window as gw
    from helen_tpu_torch.ops import gru_window_smem as gs

    T, B, H = 5, 8, 128
    image, start, h0f, h0b, layer = k1_inputs(T, B, H)
    img, hf, hb, lt = (torch.from_numpy(image), torch.from_numpy(h0f),
                       torch.from_numpy(h0b), to_torch(layer))
    gw.reset_launch_counts()
    xp = gs.bigru_window_proj_in1(img, start, T, lt)
    torch.testing.assert_close(xp, gs.window_proj_plain(gs.image_window(img, start, T), lt),
                               rtol=0, atol=0)
    for g, p in zip(gs.bigru_window_rec_smem(xp, hf, hb, lt),
                    gs.window_rec_plain(xp, hf, hb, lt)):
        torch.testing.assert_close(g, p, rtol=0, atol=0)
    xa, xb, h0f2, h0b2, layer2 = k2_inputs(T, B, H)
    xa_t, xb_t, lt2 = torch.from_numpy(xa), torch.from_numpy(xb), to_torch(layer2)
    torch.testing.assert_close(gs.bigru_window_proj_in2(xa_t, xb_t, lt2),
                               gs.window_proj_plain(torch.cat([xa_t, xb_t], -1), lt2),
                               rtol=0, atol=0)
    # a forced design changes nothing on the CPU: the plain version runs
    for design in gw.DESIGNS:
        for g, p in zip(gw.bigru_window_in1(img, start, T, hf, hb, lt, design=design),
                        gw.bigru_window_in1_plain(img, start, T, hf, hb, lt)):
            torch.testing.assert_close(g, p, rtol=0, atol=0)
    assert set(gw.launch_counts.values()) == {0}
    assert {"bigru_window_proj_in1", "bigru_window_proj_in2",
            "bigru_window_rec_smem"} <= set(gw.launch_counts)


def test_new_wrappers_raise_off_cpu_and_cuda():
    from helen_tpu_torch.ops import gru_window_smem as gs

    T, B, H, F = 3, 2, 128, 90
    meta = lambda *s, dt=torch.float32: torch.empty(s, dtype=dt, device="meta")  # noqa: E731
    layer = {d: {"w_ih": meta(F, 3 * H), "w_hh": meta(H, 3 * H), "b_ih": meta(3 * H),
                 "b_hh": meta(3 * H)} for d in ("fwd", "bwd")}
    with pytest.raises(ValueError, match="CUDA or CPU"):
        gs.bigru_window_proj_in1(meta(B, 10, F, dt=torch.uint8), 0, T, layer)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        gs.bigru_window_proj_in2(meta(T, B, H), meta(T, B, H), layer)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        gs.bigru_window_rec_smem(meta(2, T, B, 3 * H), meta(B, H), meta(B, H), layer)


def test_source_is_built_with_the_others():
    """build_kernels compiles every ops/csrc/*.cu: gru_window_smem.cu is one."""
    import os

    from helen_tpu_torch.ops import library

    src = os.path.join(library.CSRC, "gru_window_smem.cu")
    with open(src) as f:
        text = f.read()
    for fn in ("bigru_window_proj_in1", "bigru_window_proj_in2", "bigru_window_rec_smem",
               "bigru_window_rec_smem_bytes", "bigru_window_rec_max_threads"):
        assert f" {fn}(" in text, fn
