"""Pass 2 of both training backwards in its split design
(ops.gru_window_wgrad): the shape rule, the plain emulation of the slice
partition against the unsplit plain versions and against helen_tpu's
``_bwd_kernel_ip`` / ``_bwd_kernel`` (interpret mode), and the wrappers on
the CPU.

:func:`wgrad_split_plain` multiplies each slice of rows on its own and adds
the slices in order, as the kernel does; against the unsplit plain versions
(one product over all rows) it is held to 1e-6 of the output's largest
magnitude (at least 1), the rounding of a float32 sum of these lengths;
against helen_tpu at rtol 1e-4 / atol 1e-5, as tests/test_torch_bwd_smem.py
holds pass 1. The kernels run only on a CUDA device
(tests/test_torch_cuda.py ``-k wgrad`` and chip_smoke.py phases 7a and 9b).
"""
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

SPLIT_TOL = 1e-6


def make_layer(rng, d, h):
    k = 1.0 / np.sqrt(h)
    u = lambda *s: rng.uniform(-k, k, s).astype(np.float32)  # noqa: E731
    return {dr: {"w_ih": u(d, 3 * h), "w_hh": u(h, 3 * h), "b_ih": u(3 * h),
                 "b_hh": u(3 * h)} for dr in ("fwd", "bwd")}


def case(kind, T, B, H, seed, img_max=256):
    """Pass 2's inputs on the CPU: the layer input (a uint8 image of values
    below ``img_max``, full-range by default; the pair of halves; or for
    "xp" projected streams), the plain
    forward's outputs, nonzero h0, pass 1's dxp and dhp_n from its plain
    version; and the numpy layer and pass 1's other inputs."""
    from helen_tpu_torch.ops.gru_window import bigru_window_in1_plain, bigru_window_in2_plain
    from helen_tpu_torch.ops.gru_window_bwd import bigru_window_bwd_rec_plain
    from helen_tpu_torch.ops.gru_window_xp import bigru_window_xp_plain
    from helen_tpu_torch.ops.gru_window_xp_bwd import bigru_window_xp_bwd_rec_plain

    rng = np.random.default_rng(seed)
    r = lambda *s: torch.from_numpy(rng.uniform(-1, 1, s).astype(np.float32))  # noqa: E731
    layer = make_layer(rng, 90 if kind == "image" else 2 * H, H)
    lt = {d: {k: torch.from_numpy(v) for k, v in p.items()} for d, p in layer.items()}
    h0f, h0b, dhf, dhb = (r(B, H) for _ in range(4))
    dof, dob = r(T, B, H), r(T, B, H)
    if kind == "xp":
        x = r(T, B, 2 * H)
        xp = [x @ lt[d]["w_ih"] + lt[d]["b_ih"] for d in ("fwd", "bwd")]
        of, ob, _, _ = bigru_window_xp_plain(*xp, h0f, h0b, lt)
        dxp, dhpn, _, _ = bigru_window_xp_bwd_rec_plain(*xp, h0f, h0b, of, ob, dof, dob, dhf,
                                                        dhb, lt)
        return (None, 0, h0f, h0b, of, ob, dxp, dhpn), (layer, xp, dof, dob, dhf, dhb)
    if kind == "image":
        start = 3
        src = torch.from_numpy(rng.integers(0, img_max, (B, T + 6, 90), dtype=np.uint8))
        of, ob, _, _ = bigru_window_in1_plain(src, start, T, h0f, h0b, lt)
    else:
        start = 0
        src = (r(T, B, H), r(T, B, H))
        of, ob, _, _ = bigru_window_in2_plain(*src, h0f, h0b, lt)
    dxp, dhpn, _, _, _ = bigru_window_bwd_rec_plain(src, start, h0f, h0b, of, ob, dof, dob,
                                                    dhf, dhb, lt, need_dx=False)
    return (src, start, h0f, h0b, of, ob, dxp, dhpn), (layer, None, dof, dob, dhf, dhb)


def unsplit(args):
    from helen_tpu_torch.ops.gru_window_bwd import bigru_window_bwd_wgrad_plain
    from helen_tpu_torch.ops.gru_window_xp_bwd import bigru_window_xp_bwd_wgrad_plain

    if args[0] is None:
        return bigru_window_xp_bwd_wgrad_plain(*args[2:])
    return bigru_window_bwd_wgrad_plain(*args)


# (D, H, T, B, with_ih) -> (slices, rows per direction, blocks, scratch bytes)
@pytest.mark.parametrize("shape,want", [
    ((90, 128, 100, 256, True), (16, 220, 480, 10_813_440)),      # flagship layer 0
    ((256, 128, 100, 256, True), (16, 386, 768, 18_972_672)),     # flagship decoder
    ((256, 128, 100, 512, True), (32, 386, 1536, 37_945_344)),    # B=512
    ((90, 128, 100, 512, True), (32, 220, 960, 21_626_880)),
    ((0, 1024, 100, 64, False), (4, 1025, 3264, 100_761_600)),    # wide K4 pass 2
    ((320, 160, 7, 13, True), (1, 482, 72, 0)),                   # ragged, one slice
    ((320, 160, 5, 257, True), (1, 482, 72, 0)),
    ((256, 128, 33, 97, True), (3, 386, 144, 3_557_376)),         # a ragged last slice
])
def test_wgrad_design_rule(shape, want):
    """S = ceil(T*B / 1600); 64 x 128 tiles over (D + 1) and (H + 1) rows and
    3H columns; the (S, 2, rows, 3H) float32 scratch only past one slice."""
    from helen_tpu_torch.ops.gru_window_wgrad import SLICE_ROWS, TILE, wgrad_design

    plan = wgrad_design(*shape)
    assert (plan.slices, plan.rows, plan.blocks, plan.scratch_bytes) == want
    assert plan.tile == TILE == (64, 128) and plan.slice_rows == SLICE_ROWS == 1600


@pytest.mark.parametrize("sms,budget", [(132, 232_448), (114, 232_448), (8, 49_152)])
def test_wgrad_design_ignores_the_card(monkeypatch, sms, budget):
    """The partition, and so the order of every sum, is the same on any
    card: the rule reads no card property."""
    from helen_tpu_torch.ops import library
    from helen_tpu_torch.ops.gru_window_wgrad import wgrad_design

    shapes = [(90, 128, 100, 256, True), (0, 1024, 100, 64, False), (320, 160, 7, 13, True)]
    want = [wgrad_design(*s) for s in shapes]
    monkeypatch.setattr(library, "card_limits", lambda: (sms, budget))
    assert [wgrad_design(*s) for s in shapes] == want


@pytest.mark.parametrize("kind", ["image", "pair", "xp"])
@pytest.mark.parametrize("T,B,rows", [(7, 13, 16), (5, 257, 100), (5, 257, 1600)])
def test_split_plain_matches_unsplit_plain(kind, T, B, rows):
    """Slices of ``rows`` rows (ragged last slices; one slice at 1,600)
    against one product over all rows, both directions, every output."""
    from helen_tpu_torch.ops.gru_window_wgrad import wgrad_split_plain

    args, _ = case(kind, T, B, 24, seed=T * B + rows)
    got = wgrad_split_plain(*args, slice_rows=rows)
    want = unsplit(args)
    assert set(got) == set(want)
    for d in ("fwd", "bwd"):
        assert set(got[d]) == set(want[d]) == ({"w_hh", "b_hh"} if kind == "xp" else
                                               {"w_ih", "w_hh", "b_ih", "b_hh"})
        for k, w in want[d].items():
            assert got[d][k].shape == w.shape, (d, k)
            scale = max(1.0, float(w.abs().max()))
            err = float((got[d][k] - w).abs().max())
            assert err <= SPLIT_TOL * scale, f"{d}.{k}: {err} (scale {scale})"


@pytest.mark.parametrize("kind", ["image", "pair"])
def test_split_plain_matches_pallas_bwd_ip_interpret(kind):
    """Slices of 8 rows of a 30-row window against helen_tpu's
    ``_bwd_kernel_ip`` in interpret mode: every dW/db of both directions.
    helen_tpu pads D to a multiple of 128; its pad rows are sliced away."""
    from helen_tpu.ops.gru_pallas_train import fused_bigru_window_train_bwd_ip

    from helen_tpu_torch.ops.gru_window_bwd import window_input
    from helen_tpu_torch.ops.gru_window_wgrad import wgrad_split_plain

    T, B, H = 6, 5, 128
    # small counts keep the weight sums at the scale of unit-range inputs,
    # as tests/test_torch_bwd_smem.py does against the same kernel
    args, (layer, _, dof, dob, dhf, dhb) = case(kind, T, B, H, seed=41, img_max=3)
    src, start, h0f, h0b, of, ob, dxp, dhpn = args
    g = wgrad_split_plain(*args, slice_rows=8)
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
    _, _, _, dwi_f, dwi_b, dbi_f, dbi_b, dw_f, dw_b, db_f, db_b = (np.asarray(a) for a in want)
    for d, (dwi, dbi, dw, db) in (("fwd", (dwi_f, dbi_f, dw_f, db_f)),
                                  ("bwd", (dwi_b, dbi_b, dw_b, db_b))):
        for k, w in (("w_ih", dwi[:D]), ("b_ih", dbi[0]), ("w_hh", dw), ("b_hh", db[0])):
            np.testing.assert_allclose(g[d][k].numpy(), w, rtol=1e-4, atol=1e-5,
                                       err_msg=f"{d}.{k}")


def test_split_plain_matches_pallas_train_backward_interpret():
    """The xp form, slices of 8 rows of a 40-row window, against helen_tpu's
    ``_bwd_kernel`` in interpret mode: dW_hh and db_hh of both directions."""
    from helen_tpu.ops.gru_pallas_train import fused_bigru_window_train_bwd

    from helen_tpu_torch.ops.gru_window_wgrad import wgrad_split_plain

    T, B, H = 5, 8, 128
    args, (layer, (xp_f, xp_b), dof, dob, dhf, dhb) = case("xp", T, B, H, seed=43)
    _, _, h0f, h0b, of, ob, dxp, dhpn = args
    g = wgrad_split_plain(*args, slice_rows=8)
    J = lambda t: jnp.asarray(t.numpy())  # noqa: E731
    f, b = layer["fwd"], layer["bwd"]
    want = fused_bigru_window_train_bwd(
        J(xp_f), J(xp_b), J(of), J(ob), J(h0f), J(h0b), J(dof), J(dob), J(dhf), J(dhb),
        jnp.asarray(f["w_hh"]), jnp.asarray(b["w_hh"]), jnp.asarray(f["b_hh"][None]),
        jnp.asarray(b["b_hh"][None]), interpret=True)
    _, _, _, _, dw_f, dw_b, db_f, db_b = (np.asarray(a) for a in want)
    for d, dw, db in (("fwd", dw_f, db_f), ("bwd", dw_b, db_b)):
        np.testing.assert_allclose(g[d]["w_hh"].numpy(), dw, rtol=1e-4, atol=1e-5,
                                   err_msg=f"{d}.w_hh")
        np.testing.assert_allclose(g[d]["b_hh"].numpy(), db[0], rtol=1e-4, atol=1e-5,
                                   err_msg=f"{d}.b_hh")


@pytest.mark.parametrize("kind", ["image", "pair", "xp"])
def test_wrappers_take_the_plain_version_on_cpu_and_count_no_launch(kind):
    """On CPU tensors the wrappers and the backward that calls them compute
    the unsplit plain version, and no counter moves."""
    from helen_tpu_torch.ops import gru_window_bwd as gb
    from helen_tpu_torch.ops import gru_window_wgrad as gwg
    from helen_tpu_torch.ops import gru_window_xp_bwd as gxb

    args, (layer, xp, dof, dob, dhf, dhb) = case(kind, 4, 3, 16, seed=5)
    lt = {d: {k: torch.from_numpy(v) for k, v in p.items()} for d, p in layer.items()}
    gwg.reset_launch_counts()
    gb.reset_launch_counts()
    gxb.reset_launch_counts()
    want = unsplit(args)
    if kind == "xp":
        full = gxb.bigru_window_xp_bwd(*xp, *args[2:6], dof, dob, dhf, dhb, lt)[4]
    else:
        full = gb.bigru_window_bwd(*args[:6], dof, dob, dhf, dhb, lt)[3]
    got = (gwg.bigru_window_xp_wgrad(*args[2:]) if kind == "xp"
           else gwg.bigru_window_wgrad(*args))
    for d in ("fwd", "bwd"):
        for k, w in want[d].items():
            assert torch.equal(got[d][k], w), (d, k)
            assert torch.equal(full[d][k], w), (d, k)
    for counts in (gwg.launch_counts, gb.launch_counts, gxb.launch_counts):
        assert set(counts.values()) == {0}
    assert set(gwg.launch_counts) == {"bigru_window_wgrad_split", "bigru_window_wgrad_sum"}


def test_wrappers_raise_off_cpu_and_cuda():
    from helen_tpu_torch.ops import gru_window_wgrad as gwg

    T, B, H = 3, 2, 32
    meta = lambda *s: torch.empty(s, dtype=torch.float32, device="meta")  # noqa: E731
    s, v = meta(T, B, H), meta(B, H)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        gwg.bigru_window_wgrad((s, s), 0, v, v, s, s, meta(2, T, B, 3 * H), meta(2, T, B, H))
    with pytest.raises(ValueError, match="CUDA or CPU"):
        gwg.bigru_window_xp_wgrad(v, v, s, s, meta(2, T, B, 3 * H), meta(2, T, B, H))


def test_source_is_built_with_the_others():
    """build_kernels compiles every ops/csrc/*.cu: gru_window_wgrad.cu, with
    its entries and the slice length the Python rule uses."""
    import glob
    import os

    from helen_tpu_torch.ops import library
    from helen_tpu_torch.ops.gru_window_wgrad import SLICE_ROWS, TILE

    assert "gru_window_wgrad.cu" in {os.path.basename(p)
                                     for p in glob.glob(os.path.join(library.CSRC, "*.cu"))}
    with open(os.path.join(library.CSRC, "gru_window_wgrad.cu")) as f:
        text = f.read()
    for fn in ("bigru_window_wgrad_split_in", "bigru_window_wgrad_split_xp",
               "bigru_window_wgrad_sum", "bigru_window_wgrad_slice_rows",
               "bigru_window_wgrad_scratch_bytes"):
        assert f" {fn}(" in text, fn

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))

    assert const("WS_SLICE_ROWS") == SLICE_ROWS
    assert (32 * const("WS_WARPS_M"), 32 * const("WS_WARPS_N")) == TILE
    assert "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32" in text
    # the split into TF32 parts, shared with the xp projection
    assert "split_tf32(" in text and '#include "gru_window_common.cuh"' in text
    with open(os.path.join(library.CSRC, "gru_window_common.cuh")) as f:
        assert "(__float_as_uint(x) + 0x1000u) & 0xffffe000u" in f.read()  # rna to TF32


def test_wgrad_variants_edit_the_shipped_source():
    """helen_tpu_torch.obs.wgrad_variants (the measurement of where pass 2's
    time goes) edits the shipped source: every constant and every text it
    replaces is there, and off the card it refuses."""
    import os

    from helen_tpu_torch.obs import wgrad_variants as wv
    from helen_tpu_torch.obs.grid_variants import variant_source
    from helen_tpu_torch.ops import library

    with open(os.path.join(library.CSRC, wv.SOURCE)) as f:
        src = f.read()
    for name, (consts, edits) in wv.VARIANTS.items():
        out = variant_source(src, consts, edits, wv.SOURCE)
        assert (out == src) == (name == "shipped"), name
    assert wv.main(["--iters", "1"]) == 1
