"""Pass 1 of the xp-stream backward (K4) in its "grid" design
(ops.gru_window_xp_bwd_grid): its plain pieces against helen_tpu's
``_bwd_kernel`` (interpret mode) and against the one-launch design's plain
version, the rule that picks the design, and the wrappers off the card.

The design's plain version is ``bwd_hp_plain`` (the gate pass, ``h_prev @
W_hh`` without ``b_hh``), then :func:`xp_bwd_rec_grid_plain` (the recurrence
given xp and hp: ``unwind_gates`` per direction). Chained with pass 2's
plain version they are held against ``fused_bigru_window_train_bwd(...,
interpret=True)`` at 1e-5 (scaled by the magnitude, at least 1, for the
weight cotangents, which are sums over the window's T*B rows), as
tests/test_torch_gru_window_xp.py holds the one-launch plain version;
chained alone they equal ``bigru_window_xp_bwd_rec_plain`` exactly (the
same torch ops in the same order). The kernel runs only on a CUDA device
(tests/test_torch_cuda.py, where the two designs are equal bit for bit,
and chip_smoke.py phase 9b).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

TOL = 1e-5


def make_layer(rng, d, h):
    k = 1.0 / np.sqrt(h)
    u = lambda *s: rng.uniform(-k, k, s).astype(np.float32)  # noqa: E731
    return {dr: {"w_ih": u(d, 3 * h), "w_hh": u(h, 3 * h), "b_ih": u(3 * h),
                 "b_hh": u(3 * h)} for dr in ("fwd", "bwd")}


def case(T, B, H, seed):
    """The inputs of one K4 launch, torch on the CPU: projected streams of a
    unit-range input, the plain forward's outputs, nonzero h0, dout and
    final-state cotangents (a zero cotangent would hide an off-by-one in the
    h_prev shift); and the numpy layer."""
    from helen_tpu_torch.ops.gru_window_xp import bigru_window_xp_plain

    rng = np.random.default_rng(seed)
    layer = make_layer(rng, 2 * H, H)
    lt = {d: {k: torch.from_numpy(v) for k, v in p.items()} for d, p in layer.items()}
    r = lambda *s: torch.from_numpy(rng.uniform(-1, 1, s).astype(np.float32))  # noqa: E731
    x = r(T, B, 2 * H)
    xp_f, xp_b = (x @ lt[d]["w_ih"] + lt[d]["b_ih"] for d in ("fwd", "bwd"))
    h0f, h0b, dhf, dhb = (r(B, H) for _ in range(4))
    dof, dob = r(T, B, H), r(T, B, H)
    of, ob, _, _ = bigru_window_xp_plain(xp_f, xp_b, h0f, h0b, lt)
    return (xp_f, xp_b, h0f, h0b, of, ob, dof, dob, dhf, dhb, lt), layer


def chained(xp_f, xp_b, h0f, h0b, of, ob, dof, dob, dhf, dhb, lt):
    """The grid design's plain pieces in the order the wrapper launches them:
    (dxp, dhp_n, dh0_f, dh0_b)."""
    from helen_tpu_torch.ops import gru_window_bwd_smem as gbs
    from helen_tpu_torch.ops import gru_window_xp_bwd_grid as gg

    hp = gbs.bigru_window_bwd_hp(h0f, h0b, of, ob, lt)
    return gg.bigru_window_xp_bwd_rec_grid(xp_f, xp_b, hp, h0f, h0b, of, ob, dof, dob, dhf,
                                           dhb, lt)


def close(got, want, what, scaled=False):
    want = np.asarray(want)
    tol = TOL * max(1.0, float(np.abs(want).max())) if scaled else TOL
    np.testing.assert_allclose(got.numpy(), want, atol=tol, rtol=0, err_msg=what)


@pytest.mark.parametrize("T,B,H", [(5, 8, 128), (4, 8, 256)])
def test_chained_plain_matches_pallas_train_backward(T, B, H):
    """The grid design's plain pieces, then pass 2's plain version, against
    helen_tpu's ``_bwd_kernel`` in interpret mode: dxp, dh0, dW_hh and
    db_hh of both directions."""
    from helen_tpu.ops.gru_pallas_train import fused_bigru_window_train_bwd

    from helen_tpu_torch.ops.gru_window_xp_bwd import bigru_window_xp_bwd_wgrad_plain

    args, layer = case(T, B, H, seed=7 * T + H)
    xp_f, xp_b, h0f, h0b, of, ob, dof, dob, dhf, dhb, lt = args
    dxp, dhpn, dh0f, dh0b = chained(*args)
    g = bigru_window_xp_bwd_wgrad_plain(h0f, h0b, of, ob, dxp, dhpn)
    J = lambda t: jnp.asarray(t.numpy())  # noqa: E731
    f, b = layer["fwd"], layer["bwd"]
    want = fused_bigru_window_train_bwd(
        J(xp_f), J(xp_b), J(of), J(ob), J(h0f), J(h0b), J(dof), J(dob), J(dhf), J(dhb),
        jnp.asarray(f["w_hh"]), jnp.asarray(b["w_hh"]), jnp.asarray(f["b_hh"][None]),
        jnp.asarray(b["b_hh"][None]), interpret=True)
    wdxp_f, wdxp_b, wdh0_f, wdh0_b, dw_f, dw_b, db_f, db_b = want
    close(dxp[0], wdxp_f, "dxp_f")
    close(dxp[1], wdxp_b, "dxp_b")
    close(dh0f, wdh0_f, "dh0_f")
    close(dh0b, wdh0_b, "dh0_b")
    close(g["fwd"]["w_hh"], dw_f, "fwd.w_hh", scaled=True)
    close(g["bwd"]["w_hh"], dw_b, "bwd.w_hh", scaled=True)
    close(g["fwd"]["b_hh"], np.asarray(db_f)[0], "fwd.b_hh", scaled=True)
    close(g["bwd"]["b_hh"], np.asarray(db_b)[0], "bwd.b_hh", scaled=True)


# an even batch, ragged ones, one step, a width that is no multiple of 4
@pytest.mark.parametrize("T,B,H", [(6, 8, 32), (5, 13, 64), (1, 7, 48), (1, 1, 40),
                                   (4, 3, 37)])
def test_chained_plain_equals_one_launch_plain(T, B, H):
    """The grid design's plain pieces chained against
    bigru_window_xp_bwd_rec_plain: dxp, dhp_n, dh0 equal to the bit."""
    from helen_tpu_torch.ops.gru_window_xp_bwd import bigru_window_xp_bwd_rec_plain

    args, _ = case(T, B, H, seed=T * B + H)
    got = chained(*args)
    want = bigru_window_xp_bwd_rec_plain(*args)
    for g, w, what in zip(got, want, ("dxp", "dhp_n", "dh0_f", "dh0_b")):
        assert g.shape == w.shape, what
        assert torch.equal(g, w), f"{what}: max diff {float((g - w).abs().max())}"


# the H100 SXM: 132 SMs, 232,448 bytes of opt-in shared memory per block
@pytest.mark.parametrize("H,units,blocks,smem", [
    (1024, 16, 64, 231_680), (1000, 16, 63, 227_584), (768, 12, 64, 145_600),
    (640, 10, 64, 111_776), (160, 3, 54, 40_624), (128, 2, 64, 37_920),
])
def test_grid_units_on_the_h100(H, units, blocks, smem):
    """The smallest U whose 2 ceil(H / U) blocks fit the 132 SMs, and its
    shared memory: W_hh's U rows (3H rounded up to 32 floats plus 4) and
    two stages of 64 x 68 floats of dhp."""
    from helen_tpu_torch.ops import gru_window_xp_bwd_grid as gg

    assert gg.grid_units(H, 132, 232_448) == units
    assert -(-H // units) == blocks and 2 * blocks <= 132
    assert -(-H // (units - 1)) * 2 > 132  # one unit fewer needs more SMs
    assert gg.grid_smem_bytes(H, units) == smem <= 232_448


@pytest.fixture
def card(monkeypatch):
    """Set the card the rule reads (SMs, opt-in shared memory per block)."""
    from helen_tpu_torch.ops import gru_window_xp_bwd_grid as gg

    return lambda sms, budget: monkeypatch.setattr(gg, "_card", {0: (sms, budget)})


@pytest.mark.parametrize("H", [128, 160, 640, 768, 1024])
@pytest.mark.parametrize("B", [64, 300, 1])
def test_xp_bwd_design_takes_every_xp_width_on_the_h100(card, H, B):
    """"grid" at every width of the xp route (640-1024) and at the forced
    route's H=128 and 160, for any batch, on the H100 SXM."""
    from helen_tpu_torch.ops import gru_window_xp_bwd as gxb

    card(132, 232_448)
    assert gxb.xp_bwd_design(H, B) == "grid"
    assert gxb.xp_bwd_design(H, B, design="chain") == "chain"


@pytest.mark.parametrize("H,sms,budget,want", [
    # fewer SMs: a larger U, until its W_hh rows no longer fit
    (640, 114, 232_448, 12), (768, 114, 232_448, 14), (128, 114, 232_448, 3),
    (1024, 114, 232_448, None),
    # a smaller budget: H=1024's 16 rows no longer fit, H=640's 10 do
    (1024, 132, 200_000, None), (640, 132, 120_000, 10), (640, 132, 110_000, None),
    # a card too small for 16 units per block
    (1024, 60, 10**9, None),
])
def test_grid_units_follow_the_card(card, H, sms, budget, want):
    from helen_tpu_torch.ops import gru_window_xp_bwd as gxb
    from helen_tpu_torch.ops import gru_window_xp_bwd_grid as gg

    assert gg.grid_units(H, sms, budget) == want
    card(sms, budget)
    assert gxb.xp_bwd_design(H, 64) == ("chain" if want is None else "grid")


def test_forced_grid_design_is_checked(card):
    from helen_tpu_torch.ops import gru_window_xp_bwd as gxb

    card(132, 232_448)
    assert gxb.xp_bwd_design(1024, 64, design="grid") == "grid"
    with pytest.raises(ValueError, match="not one of"):
        gxb.xp_bwd_design(1024, 64, design="smem")
    card(114, 232_448)
    with pytest.raises(ValueError, match="does not take H=1024"):
        gxb.xp_bwd_design(1024, 64, design="grid")
    card(132, 110_000)
    with pytest.raises(ValueError, match="does not take H=640"):
        gxb.xp_bwd_design(640, 64, design="grid")


def test_wrappers_take_the_plain_version_on_cpu_and_count_no_launch():
    """On CPU tensors every wrapper, in either forced design, runs its plain
    version, and no counter moves; the counters name every kernel."""
    from helen_tpu_torch.ops import gru_window_bwd as gb
    from helen_tpu_torch.ops import gru_window_xp_bwd as gxb

    args, _ = case(4, 3, 32, seed=5)
    gxb.reset_launch_counts()
    gb.reset_launch_counts()
    want = gxb.bigru_window_xp_bwd_plain(*args)
    want_rec = gxb.bigru_window_xp_bwd_rec_plain(*args)
    for design in gxb.DESIGNS:
        for g, w in zip(gxb.bigru_window_xp_bwd_rec(*args, design=design), want_rec):
            assert torch.equal(g, w)
        got = gxb.bigru_window_xp_bwd(*args, design=design)
        for g, w in zip(got[:4], want[:4]):
            assert torch.equal(g, w)
        for d in ("fwd", "bwd"):
            for k in ("w_hh", "b_hh"):
                assert torch.equal(got[4][d][k], want[4][d][k])
    for g, w in zip(chained(*args), want_rec):
        assert torch.equal(g, w)
    assert set(gxb.launch_counts.values()) == {0}
    assert set(gb.launch_counts.values()) == {0}
    assert set(gxb.launch_counts) == {
        "bigru_window_xp_bwd_rec", "bigru_window_xp_bwd_wgrad", "bigru_window_xp_bwd_hp",
        "bigru_window_xp_bwd_rec_grid", "bigru_window_xp_bwd_rec_chain",
        *(f"bigru_window_xp_bwd_rec_chain_r{r}" for r in (8, 4, 2, 1))}


def test_wrappers_raise_off_cpu_and_cuda():
    from helen_tpu_torch.ops import gru_window_xp_bwd as gxb
    from helen_tpu_torch.ops import gru_window_xp_bwd_grid as gg

    T, B, H = 3, 2, 32
    meta = lambda *s: torch.empty(s, dtype=torch.float32, device="meta")  # noqa: E731
    layer = {d: {"w_hh": meta(H, 3 * H), "b_hh": meta(3 * H)} for d in ("fwd", "bwd")}
    x, s, v = meta(T, B, 3 * H), meta(T, B, H), meta(B, H)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        gg.bigru_window_xp_bwd_rec_grid(x, x, meta(2, T, B, 3 * H), v, v, s, s, s, s, v, v,
                                        layer)
    for design in (None, "grid", "chain"):
        with pytest.raises(ValueError, match="CUDA or CPU"):
            gxb.bigru_window_xp_bwd_rec(x, x, v, v, s, s, s, s, v, v, layer, design=design)
        with pytest.raises(ValueError, match="CUDA or CPU"):
            gxb.bigru_window_xp_bwd(x, x, v, v, s, s, s, s, v, v, layer, design=design)


def test_source_is_built_with_the_others():
    """build_kernels compiles every ops/csrc/*.cu: gru_window_xp_bwd_grid.cu
    with its entry points and a cooperative launch, and both designs share
    gru_cell_bwd."""
    import glob
    import os

    from helen_tpu_torch.ops import gru_window as gw

    names = {os.path.basename(p) for p in glob.glob(os.path.join(gw._CSRC, "*.cu"))}
    assert "gru_window_xp_bwd_grid.cu" in names
    with open(os.path.join(gw._CSRC, "gru_window_xp_bwd_grid.cu")) as f:
        text = f.read()
    for fn in ("bigru_window_xp_bwd_rec_grid", "bigru_window_xp_bwd_grid_smem_bytes",
               "gru_window_sm_count"):
        assert f" {fn}(" in text, fn
    # the cooperative launch and the barrier are the shared grid header's
    assert "gru_cell_bwd(" in text and "launch_cooperative(" in text
    assert '#include "gru_window_grid.cuh"' in text and "grid_barrier(" in text
    with open(os.path.join(gw._CSRC, "gru_window_grid.cuh")) as f:
        assert "cudaLaunchCooperativeKernel(" in f.read()
    with open(os.path.join(gw._CSRC, "gru_window_xp_bwd.cu")) as f:
        assert "gru_cell_bwd(" in f.read()


def test_grid_variants_edit_the_shipped_source():
    """helen_tpu_torch.obs.grid_variants (the measurement of where the grid
    recurrence's time goes) edits the shipped source: every constant and
    every cut text it replaces is there, and off the card it refuses."""
    import os

    from helen_tpu_torch.obs import grid_variants as gv
    from helen_tpu_torch.ops import gru_window as gw

    with open(os.path.join(gw._CSRC, gv.SOURCE)) as f:
        src = f.read()
    for name, (consts, edits) in gv.VARIANTS.items():
        out = gv.variant_source(src, consts, edits)
        assert (out == src) == (name == "shipped"), name
    assert gv.main(["--hidden", "64"]) == 1
