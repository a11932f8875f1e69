"""Pass 1 of the in-projection backward in its "smem" design
(ops.gru_window_bwd_smem): its plain versions against helen_tpu's
``_bwd_kernel_ip`` (interpret mode) and against the one-launch design's
plain version, and the shape rule that picks the design.

The design's plain version is ``x @ W_ih + b_ih`` per direction (the gate
pass's xp), :func:`bwd_hp_plain` (``h_prev @ W_hh``), :func:`bwd_rec_smem_plain`
(the recurrence given both) and, for later layers, :func:`bwd_dx_plain`
summed over the directions. Chained with pass 2's plain version they are
held against ``fused_bigru_window_train_bwd_ip(..., interpret=True)`` at
rtol 1e-4, atol 1e-5, as tests/test_torch_train.py holds the one-launch
plain version (sums over T*B rows in another order); chained alone they
equal ``bigru_window_bwd_rec_plain`` exactly (the same torch ops in the
same order). The kernels run only on a CUDA device
(tests/test_torch_cuda.py, where the two designs are equal bit for bit,
and chip_smoke.py phase 7a).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(2)


def make_layer(rng, d, h):
    k = 1.0 / np.sqrt(h)
    u = lambda *s: rng.uniform(-k, k, s).astype(np.float32)  # noqa: E731
    return {dr: {"w_ih": u(d, 3 * h), "w_hh": u(h, 3 * h), "b_ih": u(3 * h),
                 "b_hh": u(3 * h)} for dr in ("fwd", "bwd")}


def case(kind, T, B, H, seed):
    """The inputs of one layer-window's backward, torch on the CPU: the
    layer input, the plain forward's outputs, nonzero h0, dout and
    final-state cotangents (a zero cotangent would hide an off-by-one in
    the h_prev shift); and the numpy layer."""
    from helen_tpu_torch.ops.gru_window import bigru_window_in1_plain, bigru_window_in2_plain

    rng = np.random.default_rng(seed)
    r = lambda *s: torch.from_numpy(rng.uniform(-1, 1, s).astype(np.float32))  # noqa: E731
    h0f, h0b, dhf, dhb = (r(B, H) for _ in range(4))
    dof, dob = r(T, B, H), r(T, B, H)
    if kind == "image":
        start = 3
        # small counts keep the weight sums at the scale of unit-range inputs
        src = torch.from_numpy(rng.integers(0, 3, (B, T + 6, 90), dtype=np.uint8))
        layer = make_layer(rng, 90, H)
    else:
        start = 0
        src = (r(T, B, H), r(T, B, H))
        layer = make_layer(rng, 2 * H, H)
    lt = {d: {k: torch.from_numpy(v) for k, v in p.items()} for d, p in layer.items()}
    fwd = bigru_window_in1_plain if kind == "image" else bigru_window_in2_plain
    fwd_args = (src, start, T) if kind == "image" else src
    of, ob, _, _ = fwd(*fwd_args, h0f, h0b, lt)
    return (src, start, h0f, h0b, of, ob, dof, dob, dhf, dhb, lt), layer


def chained(src, start, h0f, h0b, of, ob, dof, dob, dhf, dhb, lt, need_dx):
    """The design's plain pieces in the order the wrapper launches them:
    (dxp, dhp_n, dx or None, dh0_f, dh0_b)."""
    from helen_tpu_torch.ops import gru_window_bwd_smem as gbs
    from helen_tpu_torch.ops.gru_window_bwd import window_input

    x = window_input(src, start, of.shape[0], torch.float32)
    xp = torch.stack([x @ lt[d]["w_ih"] + lt[d]["b_ih"] for d in ("fwd", "bwd")])
    hp = gbs.bigru_window_bwd_hp(h0f, h0b, of, ob, lt)
    dxp, dhpn, dh0f, dh0b = gbs.bigru_window_bwd_rec_smem(xp, hp, h0f, h0b, of, ob, dof,
                                                          dob, dhf, dhb, lt)
    dx = None
    if need_dx:
        dx2 = gbs.bigru_window_bwd_dx(dxp, lt)
        dx = dx2[0] + dx2[1]
    return dxp, dhpn, dx, dh0f, dh0b


@pytest.mark.parametrize("kind", ["image", "pair"])
def test_chained_plain_matches_pallas_bwd_ip_interpret(kind):
    """The design's plain pieces, then pass 2's plain version, against
    helen_tpu's ``_bwd_kernel_ip`` in interpret mode: dx, dh0 and every
    dW/db. helen_tpu pads D to a multiple of 128; its pad rows and columns
    are sliced away."""
    from helen_tpu.ops.gru_pallas_train import fused_bigru_window_train_bwd_ip

    from helen_tpu_torch.ops.gru_window_bwd import bigru_window_bwd_wgrad_plain, window_input

    T, B, H = 6, 5, 128
    args, layer = case(kind, T, B, H, seed=31)
    src, start, h0f, h0b, of, ob, dof, dob, dhf, dhb, lt = args
    dxp, dhpn, dx, dh0f, dh0b = chained(*args, need_dx=True)
    g = bigru_window_bwd_wgrad_plain(src, start, h0f, h0b, of, ob, dxp, dhpn)

    D = 90 if kind == "image" else 2 * H
    Dp = -(-D // 128) * 128
    x = np.pad(window_input(src, start, T, torch.float32).numpy(),
               ((0, 0), (0, 0), (0, Dp - D)))
    pad = lambda w: jnp.asarray(np.pad(w, ((0, Dp - D), (0, 0))))  # noqa: E731
    row = lambda v: jnp.asarray(v.reshape(1, -1))  # noqa: E731
    J = lambda t: jnp.asarray(t.numpy())  # noqa: E731
    f, b = layer["fwd"], layer["bwd"]
    want = fused_bigru_window_train_bwd_ip(
        jnp.asarray(x), J(of), J(ob), J(h0f), J(h0b), J(dof), J(dob), J(dhf), J(dhb),
        pad(f["w_ih"]), pad(b["w_ih"]), jnp.asarray(f["w_hh"]), jnp.asarray(b["w_hh"]),
        row(f["b_ih"]), row(b["b_ih"]), row(f["b_hh"]), row(b["b_hh"]), interpret=True)
    (wdx, wdh0f, wdh0b, dwi_f, dwi_b, dbi_f, dbi_b, dw_f, dw_b, db_f, db_b) = (
        np.asarray(a) for a in want)
    close = lambda a, w, what: np.testing.assert_allclose(  # noqa: E731
        a.numpy(), w, rtol=1e-4, atol=1e-5, err_msg=what)
    close(dx, wdx[..., :D], "dx")
    close(dh0f, wdh0f, "dh0_f")
    close(dh0b, wdh0b, "dh0_b")
    for d, (dwi, dbi, dw, db) in (("fwd", (dwi_f, dbi_f, dw_f, db_f)),
                                  ("bwd", (dwi_b, dbi_b, dw_b, db_b))):
        close(g[d]["w_ih"], dwi[:D], f"{d}.w_ih")
        close(g[d]["b_ih"], dbi[0], f"{d}.b_ih")
        close(g[d]["w_hh"], dw, f"{d}.w_hh")
        close(g[d]["b_hh"], db[0], f"{d}.b_hh")


# both layer kinds, an even batch and a ragged one, a narrow H
@pytest.mark.parametrize("kind,T,B,H", [("image", 7, 4, 32), ("image", 5, 3, 128),
                                        ("pair", 6, 6, 32), ("pair", 12, 5, 128)])
def test_chained_plain_equals_one_launch_plain(kind, T, B, H):
    """The design's plain pieces chained against bigru_window_bwd_rec_plain:
    dxp, dhp_n, dx, dh0 equal to the bit."""
    from helen_tpu_torch.ops.gru_window_bwd import bigru_window_bwd_rec_plain

    args, _ = case(kind, T, B, H, seed=T * B + H)
    need_dx = kind == "pair"
    got = chained(*args, need_dx=need_dx)
    want = bigru_window_bwd_rec_plain(*args, need_dx=need_dx)
    for g, w, what in zip(got, want, ("dxp", "dhp_n", "dx", "dh0_f", "dh0_b")):
        if w is None:
            assert g is None, what
            continue
        assert g.shape == w.shape, what
        assert torch.equal(g, w), f"{what}: max diff {float((g - w).abs().max())}"


@pytest.mark.parametrize("H,B,want", [
    (128, 256, "smem"), (128, 512, "smem"), (128, 300, "smem"), (131, 512, "smem"),
    (132, 512, "chain"), (135, 256, "smem"), (136, 256, "chain"), (160, 8, "chain"),
    (512, 256, "chain"), (16, 4, "smem"), (37, 67, "smem"),
])
def test_bwd_design_rule(H, B, want):
    """"smem" exactly where W_hh^T and the dhp buffers fit the card's opt-in
    232,448 bytes at rec_block_rows(B) rows (and 2H threads fit the launch
    bound): up to H=131 at 8 rows, 135 at 4."""
    from helen_tpu_torch.ops import gru_window_bwd as gb
    from helen_tpu_torch.ops.gru_window_bwd_smem import bwd_fits_smem

    assert gb.bwd_design(H, B) == want
    assert bwd_fits_smem(H, B) is (want == "smem")


@pytest.mark.parametrize("H,rows,want", [
    (128, 8, 221_184), (128, 4, 208_896), (131, 8, 231_276), (132, 8, 234_432),
    (135, 4, 231_756), (136, 4, 235_008), (37, 2, 18_220), (1, 1, 44),
])
def test_bwd_recurrence_shared_memory(H, rows, want):
    """W_hh^T (3H x H floats) and dhp double-buffered at rows x 3H rounded
    up to 4 floats."""
    from helen_tpu_torch.ops.gru_window_bwd_smem import bwd_rec_smem_bytes
    from helen_tpu_torch.ops.library import HOPPER_SMEM_OPTIN

    assert bwd_rec_smem_bytes(H, rows) == want
    assert (want <= HOPPER_SMEM_OPTIN) is (H not in (132, 136))


@pytest.mark.parametrize("B,rows", [(256, 4), (512, 8), (300, 8), (64, 1)])
def test_bwd_recurrence_takes_the_forward_rows_rule(B, rows):
    """The rows per block are rec_block_rows's: one rule for both
    recurrences; the budget shrinks the fit at those rows."""
    from helen_tpu_torch.ops.gru_window_bwd_smem import bwd_fits_smem, bwd_rec_smem_bytes
    from helen_tpu_torch.ops.gru_window_smem import rec_block_rows

    assert rec_block_rows(B) == rows
    need = bwd_rec_smem_bytes(128, rows)
    assert bwd_fits_smem(128, B, budget=need)
    assert not bwd_fits_smem(128, B, budget=need - 1)


def test_forced_bwd_design_is_checked():
    from helen_tpu_torch.ops import gru_window_bwd as gb

    assert gb.bwd_design(128, 256, design="chain") == "chain"
    assert gb.bwd_design(128, 256, design="smem") == "smem"
    assert gb.bwd_design(160, 256, design="chain") == "chain"
    with pytest.raises(ValueError, match="does not take H=160"):
        gb.bwd_design(160, 256, design="smem")
    with pytest.raises(ValueError, match="does not take H=132"):
        gb.bwd_design(132, 512, design="smem")
    with pytest.raises(ValueError, match="not one of"):
        gb.bwd_design(128, 256, design="fused")


def test_wrappers_take_the_plain_version_on_cpu_and_count_no_launch():
    """On CPU tensors every wrapper, in either forced design, runs its plain
    version: bigru_window_bwd_rec is bigru_window_bwd_rec_plain, and no
    counter moves."""
    from helen_tpu_torch.ops import gru_window as gw
    from helen_tpu_torch.ops import gru_window_bwd as gb
    from helen_tpu_torch.ops import gru_window_bwd_smem as gbs

    args, _ = case("pair", 4, 3, 32, seed=5)
    gw.reset_launch_counts()
    gb.reset_launch_counts()
    want = gb.bigru_window_bwd_rec_plain(*args)
    for design in gb.DESIGNS:
        for g, w in zip(gb.bigru_window_bwd_rec(*args, design=design), want):
            assert torch.equal(g, w)
        grads = gb.bigru_window_bwd(*args, design=design)
        assert torch.equal(grads[0], want[2])
    src, start, h0f, h0b, of, ob, dof, dob, dhf, dhb, lt = args
    assert torch.equal(gbs.bigru_window_bwd_hp(h0f, h0b, of, ob, lt),
                       gbs.bwd_hp_plain(h0f, h0b, of, ob, lt))
    assert set(gw.launch_counts.values()) == {0}
    assert set(gb.launch_counts.values()) == {0}
    assert {"bigru_window_bwd_rec", "bigru_window_bwd_wgrad", "bigru_window_bwd_rec_chain",
            "bigru_window_bwd_hp", "bigru_window_bwd_rec_smem",
            "bigru_window_bwd_dx"} == set(gb.launch_counts)


def test_new_wrappers_raise_off_cpu_and_cuda():
    from helen_tpu_torch.ops import gru_window_bwd as gb
    from helen_tpu_torch.ops import gru_window_bwd_smem as gbs

    T, B, H = 3, 2, 32
    meta = lambda *s: torch.empty(s, dtype=torch.float32, device="meta")  # noqa: E731
    layer = {d: {"w_ih": meta(2 * H, 3 * H), "w_hh": meta(H, 3 * H), "b_ih": meta(3 * H),
                 "b_hh": meta(3 * H)} for d in ("fwd", "bwd")}
    s, v = meta(T, B, H), meta(B, H)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        gbs.bigru_window_bwd_hp(v, v, s, s, layer)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        gbs.bigru_window_bwd_rec_smem(meta(2, T, B, 3 * H), meta(2, T, B, 3 * H), v, v, s, s,
                                      s, s, v, v, layer)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        gbs.bigru_window_bwd_dx(meta(2, T, B, 3 * H), layer)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        gb.bigru_window_bwd_rec((s, s), 0, v, v, s, s, s, s, v, v, layer)


def test_source_is_built_with_the_others():
    """build_kernels compiles every ops/csrc/*.cu and hashes every .cuh:
    gru_window_bwd_smem.cu and the header it shares with the forward."""
    import glob
    import os

    from helen_tpu_torch.ops import library

    names = {os.path.basename(p) for p in glob.glob(os.path.join(library.CSRC, "*.cu*"))}
    assert {"gru_window_bwd_smem.cu", "gru_window_smem.cuh"} <= names
    with open(os.path.join(library.CSRC, "gru_window_bwd_smem.cu")) as f:
        text = f.read()
    for fn in ("bigru_window_bwd_hp", "bigru_window_bwd_rec_smem", "bigru_window_bwd_dx",
               "bigru_window_bwd_rec_smem_bytes"):
        assert f" {fn}(" in text, fn
    assert "gru_cell_bwd(" in text
    with open(os.path.join(library.CSRC, "gru_window_bwd.cu")) as f:
        assert "gru_cell_bwd(" in f.read()
