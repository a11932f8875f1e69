"""The xp route of the port (the wide models) against helen_tpu, on the CPU.

K3 (``bigru_window_xp``, the port of ``_kernel`` and ``_fwd_kernel``) and K4
(``bigru_window_xp_bwd``, the port of ``_bwd_kernel``) run only on a CUDA
device (tests/test_torch_cuda.py, chip_smoke.py phase 9); here their plain
versions, which the wrappers take on CPU tensors, are held against
helen_tpu's Pallas functions in interpret mode and its lax.scan path, on
inputs made with numpy from a seed. Tolerance 2e-5, as
tests/test_torch_gru_window.py holds K1/K2: the Pallas side computes its
products as bf16x3 passes (``_kernel``) or on the CPU's fp32 dot, the port
in fp32, and sums are taken in other orders. Weight cotangents are sums
over the window's T*B rows, so their bound scales with their magnitude (at
least 1).

Then the route as a whole: the dispatch rule, the wide-model consensus
against helen_tpu's, the golden fixtures and one TBPTT batch through the
forced xp route, and a wide checkpoint carried across.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_fixtures import FIXTURES, golden, stage_golden_images

torch.set_num_threads(2)

TOL = 2e-5
F = 90


def make_layer(rng, d, h, w_ih_scale=1.0):
    k = 1.0 / np.sqrt(h)
    u = lambda *s: rng.uniform(-k, k, s).astype(np.float32)  # noqa: E731
    return {dr: {"w_ih": u(d, 3 * h) * np.float32(w_ih_scale), "w_hh": u(h, 3 * h),
                 "b_ih": u(3 * h), "b_hh": u(3 * h)} for dr in ("fwd", "bwd")}


def to_torch(tree):
    from helen_tpu_torch.io.checkpoint import params_to_torch

    return params_to_torch(tree, "cpu")


def close(got, want, what, scaled=False):
    got = got.detach().numpy() if hasattr(got, "detach") else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    tol = TOL * max(1.0, float(np.abs(want).max())) if scaled else TOL
    np.testing.assert_allclose(got, want, atol=tol, rtol=0, err_msg=what)


def xp_inputs(T, B, H, seed):
    """Projected streams of a unit-range input, h0 pair, and the layer."""
    rng = np.random.default_rng(seed)
    layer = make_layer(rng, 2 * H, H)
    x = rng.uniform(-1, 1, (T, B, 2 * H)).astype(np.float32)
    xp = [x @ layer[d]["w_ih"] + layer[d]["b_ih"] for d in ("fwd", "bwd")]
    h0f, h0b = (rng.uniform(-1, 1, (B, H)).astype(np.float32) for _ in range(2))
    return xp[0], xp[1], h0f, h0b, layer


# helen_tpu's xp-stream kernels take H % 128 == 0 (gru_pallas.py:362)
SHAPES = [(8, 16, 128), (5, 8, 256)]


@pytest.mark.parametrize("T,B,H", SHAPES)
def test_k3_plain_matches_pallas_kernel(T, B, H):
    """K3's plain version against ``fused_bigru_window(interpret=True)``,
    helen_tpu's ``_kernel`` at parity (bf16x3) precision."""
    from helen_tpu.ops.gru_pallas import fused_bigru_window

    from helen_tpu_torch.ops.gru_window_xp import bigru_window_xp_plain

    xp_f, xp_b, h0f, h0b, layer = xp_inputs(T, B, H, seed=T + H)
    f, b = layer["fwd"], layer["bwd"]
    want = fused_bigru_window(*(jnp.asarray(a) for a in (xp_f, xp_b, h0f, h0b)),
                              jnp.asarray(f["w_hh"]), jnp.asarray(b["w_hh"]),
                              jnp.asarray(f["b_hh"][None]), jnp.asarray(b["b_hh"][None]),
                              interpret=True)
    got = bigru_window_xp_plain(*(torch.from_numpy(a) for a in (xp_f, xp_b, h0f, h0b)),
                                to_torch(layer))
    for g, w, what in zip(got, want, ("out_f", "out_b", "h_f", "h_b")):
        close(g, w, what)


@pytest.mark.parametrize("T,B,H", SHAPES)
def test_k3_plain_matches_pallas_train_forward(T, B, H):
    """K3's plain version against ``fused_bigru_window_train_fwd(
    interpret=True)``, helen_tpu's ``_fwd_kernel``: the same function."""
    from helen_tpu.ops.gru_pallas_train import fused_bigru_window_train_fwd

    from helen_tpu_torch.ops.gru_window_xp import bigru_window_xp_plain

    xp_f, xp_b, h0f, h0b, layer = xp_inputs(T, B, H, seed=2 * T + H)
    f, b = layer["fwd"], layer["bwd"]
    want = fused_bigru_window_train_fwd(
        *(jnp.asarray(a) for a in (xp_f, xp_b, h0f, h0b)), jnp.asarray(f["w_hh"]),
        jnp.asarray(b["w_hh"]), jnp.asarray(f["b_hh"][None]), jnp.asarray(b["b_hh"][None]),
        interpret=True)
    got = bigru_window_xp_plain(*(torch.from_numpy(a) for a in (xp_f, xp_b, h0f, h0b)),
                                to_torch(layer))
    for g, w, what in zip(got, want, ("out_f", "out_b", "h_f", "h_b")):
        close(g, w, what)


@pytest.mark.parametrize("kind", ["image_d90", "pair_d2h"])
def test_xp_layer_matches_bigru_apply_fused(kind):
    """The port's xp layer (the projection in torch, then K3's plain
    version) against ``bigru_apply_fused(interpret=True)``: a uint8-valued
    D=90 window read from the image, and a D=2H pair input."""
    from helen_tpu.ops.gru_pallas import bigru_apply_fused

    from helen_tpu_torch.ops.gru_window_autograd import window_xp
    from helen_tpu_torch.ops.gru_window_bwd import window_input

    rng = np.random.default_rng(31)
    T, B, H = 6, 8, 128
    h0f, h0b = (rng.uniform(-1, 1, (B, H)).astype(np.float32) for _ in range(2))
    if kind == "image_d90":
        start = 5
        src = torch.from_numpy(rng.integers(0, 256, (B, T + 9, F), dtype=np.uint8))
        layer = make_layer(rng, F, H, w_ih_scale=1 / 64)
    else:
        start = 0
        src = tuple(torch.from_numpy(rng.standard_normal((T, B, H)).astype(np.float32))
                    for _ in range(2))
        layer = make_layer(rng, 2 * H, H)
    x = window_input(src, start, T, torch.float32).numpy()
    out, hf, hb = bigru_apply_fused(jax.tree_util.tree_map(jnp.asarray, layer),
                                    jnp.asarray(x), jnp.asarray(h0f), jnp.asarray(h0b),
                                    interpret=True)
    with torch.no_grad():
        of, ob, gf, gb = window_xp(src, start, T, torch.from_numpy(h0f),
                                   torch.from_numpy(h0b), to_torch(layer))
    close(torch.cat([of, ob], -1), out, "out")
    close(gf, hf, "h_f")
    close(gb, hb, "h_b")


@pytest.mark.parametrize("T,B,H", [(5, 8, 128), (4, 8, 256)])
def test_k4_plain_matches_pallas_train_backward(T, B, H):
    """K4's plain version against ``fused_bigru_window_train_bwd(
    interpret=True)``, helen_tpu's ``_bwd_kernel``, on all 8 outputs, with
    nonzero h0, dout and final-state cotangents (a zero one would hide an
    off-by-one in the h_prev shift)."""
    from helen_tpu.ops.gru_pallas_train import fused_bigru_window_train_bwd

    from helen_tpu_torch.ops.gru_window_xp import bigru_window_xp_plain
    from helen_tpu_torch.ops.gru_window_xp_bwd import bigru_window_xp_bwd_plain

    xp_f, xp_b, h0f, h0b, layer = xp_inputs(T, B, H, seed=3 * T + H)
    rng = np.random.default_rng(T * H)
    r = lambda *s: rng.uniform(-1, 1, s).astype(np.float32)  # noqa: E731
    dof, dob, dhf, dhb = r(T, B, H), r(T, B, H), r(B, H), r(B, H)
    lt = to_torch(layer)
    tt = torch.from_numpy
    of, ob, _, _ = bigru_window_xp_plain(tt(xp_f), tt(xp_b), tt(h0f), tt(h0b), lt)
    got = bigru_window_xp_bwd_plain(tt(xp_f), tt(xp_b), tt(h0f), tt(h0b), of, ob,
                                    tt(dof), tt(dob), tt(dhf), tt(dhb), lt)
    f, b = layer["fwd"], layer["bwd"]
    J = jnp.asarray
    want = fused_bigru_window_train_bwd(
        J(xp_f), J(xp_b), J(of.numpy()), J(ob.numpy()), J(h0f), J(h0b), J(dof), J(dob),
        J(dhf), J(dhb), J(f["w_hh"]), J(b["w_hh"]), J(f["b_hh"][None]),
        J(b["b_hh"][None]), interpret=True)
    dxp_f, dxp_b, dh0_f, dh0_b, g = got
    wdxp_f, wdxp_b, wdh0_f, wdh0_b, dw_f, dw_b, db_f, db_b = want
    close(dxp_f, wdxp_f, "dxp_f")
    close(dxp_b, wdxp_b, "dxp_b")
    close(dh0_f, wdh0_f, "dh0_f")
    close(dh0_b, wdh0_b, "dh0_b")
    close(g["fwd"]["w_hh"], dw_f, "fwd.w_hh", scaled=True)
    close(g["bwd"]["w_hh"], dw_b, "bwd.w_hh", scaled=True)
    close(g["fwd"]["b_hh"], np.asarray(db_f)[0], "fwd.b_hh", scaled=True)
    close(g["bwd"]["b_hh"], np.asarray(db_b)[0], "bwd.b_hh", scaled=True)


@pytest.mark.parametrize("kind", ["image", "pair"])
def test_xp_window_gradients_match_jax_grad(kind):
    """The xp layer's gradients through ``_XpWindow`` (plain forward and
    backward on CPU tensors, the projection in torch autograd) against
    ``jax.value_and_grad`` of helen_tpu's ``bigru_apply`` at HIGHEST, for
    every weight, h0 and (pair input) the layer input."""
    from helen_tpu.models.gru import bigru_apply

    from helen_tpu_torch.ops.gru_window_autograd import window_xp
    from helen_tpu_torch.ops.gru_window_bwd import window_input

    rng = np.random.default_rng(41)
    T, B, H = 5, 3, 24
    h0 = [rng.uniform(-1, 1, (B, H)).astype(np.float32) for _ in range(2)]
    if kind == "image":
        start = 2
        image = rng.integers(0, 6, (B, T + 4, F), dtype=np.uint8)
        layer = make_layer(rng, F, H)
        x = window_input(torch.from_numpy(image), start, T, torch.float32).numpy()
    else:
        start = 0
        x = rng.uniform(-1, 1, (T, B, 2 * H)).astype(np.float32)
        layer = make_layer(rng, 2 * H, H)
    w_out = rng.standard_normal((T, B, 2 * H)).astype(np.float32)
    w_hf, w_hb = (rng.standard_normal((B, H)).astype(np.float32) for _ in range(2))

    def jloss(p, xx, hf0, hb0):
        out, hf, hb = bigru_apply(p, xx, hf0, hb0, precision=jax.lax.Precision.HIGHEST)
        return jnp.sum(out * w_out) + jnp.sum(hf * w_hf) + jnp.sum(hb * w_hb)

    jp = jax.tree_util.tree_map(jnp.asarray, layer)
    _, (gp, gx, gh0f, gh0b) = jax.value_and_grad(jloss, argnums=(0, 1, 2, 3))(
        jp, jnp.asarray(x), jnp.asarray(h0[0]), jnp.asarray(h0[1]))

    lt = to_torch(layer)
    for d in lt.values():
        for t in d.values():
            t.requires_grad_(True)
    h0t = [torch.from_numpy(a).requires_grad_(True) for a in h0]
    if kind == "image":
        src = torch.from_numpy(image)
    else:
        xt = torch.from_numpy(x).requires_grad_(True)
        src = (xt[..., :H], xt[..., H:])
    of, ob, hf, hb = window_xp(src, start, T, h0t[0], h0t[1], lt)
    loss = ((torch.cat([of, ob], -1) * torch.from_numpy(w_out)).sum()
            + (hf * torch.from_numpy(w_hf)).sum() + (hb * torch.from_numpy(w_hb)).sum())
    loss.backward()
    for d in ("fwd", "bwd"):
        for k in ("w_ih", "w_hh", "b_ih", "b_hh"):
            close(lt[d][k].grad, gp[d][k], f"{d}.{k}", scaled=True)
    close(h0t[0].grad, gh0f, "h0_f")
    close(h0t[1].grad, gh0b, "h0_b")
    if kind == "pair":
        close(xt.grad, gx, "x")


def test_xp_window_passes_gradcheck():
    """``torch.autograd.gradcheck`` of the xp layer (projection and
    ``_XpWindow``) in float64 at a tiny size: the plain backward is the
    exact derivative of the plain forward."""
    from helen_tpu_torch.ops.gru_window_autograd import tree_layer, window_xp

    rng = np.random.default_rng(5)
    T, B, H = 3, 2, 3
    t = lambda *s: torch.tensor(rng.uniform(-1, 1, s), dtype=torch.float64,  # noqa: E731
                                requires_grad=True)
    ws = [t(*s) for _ in ("fwd", "bwd")
          for s in ((2 * H, 3 * H), (H, 3 * H), (3 * H,), (3 * H,))]

    def fn(xa, xb, h0f, h0b, *w):
        return window_xp((xa, xb), 0, T, h0f, h0b, tree_layer(w))

    assert torch.autograd.gradcheck(fn, (t(T, B, H), t(T, B, H), t(B, H), t(B, H), *ws))


def test_xp_wrappers_take_the_plain_version_on_cpu_and_count_no_launch():
    from helen_tpu_torch.ops import gru_window_xp as gx
    from helen_tpu_torch.ops import gru_window_xp_bwd as gxb

    xp_f, xp_b, h0f, h0b, layer = xp_inputs(4, 5, 16, seed=1)
    args = (*(torch.from_numpy(a) for a in (xp_f, xp_b, h0f, h0b)), to_torch(layer))
    gx.reset_launch_counts()
    gxb.reset_launch_counts()
    outs = gx.bigru_window_xp(*args)
    for g, p in zip(outs, gx.bigru_window_xp_plain(*args)):
        torch.testing.assert_close(g, p, rtol=0, atol=0)
    cts = [torch.ones_like(outs[0]), -torch.ones_like(outs[1]), args[2], args[3]]
    got = gxb.bigru_window_xp_bwd(*args[:4], outs[0], outs[1], *cts, args[4])
    want = gxb.bigru_window_xp_bwd_plain(*args[:4], outs[0], outs[1], *cts, args[4])
    for g, p in zip(got[:4], want[:4]):
        torch.testing.assert_close(g, p, rtol=0, atol=0)
    assert gx.launch_counts == {"bigru_window_xp": 0, "bigru_window_xp_fast": 0,
                                "bigru_window_xp_grid": 0, "bigru_window_xp_chain": 0,
                                "bigru_window_xp_fast_grid": 0,
                                "bigru_window_xp_fast_chain": 0,
                                **{f"bigru_window_xp{t}_chain_r{r}": 0
                                   for t in ("", "_fast") for r in (8, 4, 2, 1)}}
    assert gxb.launch_counts == {"bigru_window_xp_bwd_rec": 0,
                                 "bigru_window_xp_bwd_wgrad": 0,
                                 "bigru_window_xp_bwd_hp": 0,
                                 "bigru_window_xp_bwd_rec_grid": 0,
                                 "bigru_window_xp_bwd_rec_grid_r4": 0,
                                 "bigru_window_xp_bwd_rec_grid_r2": 0,
                                 "bigru_window_xp_bwd_rec_chain": 0,
                                 **{f"bigru_window_xp_bwd_rec_chain_r{r}": 0
                                    for r in (8, 4, 2, 1)}}


def test_xp_wrappers_raise_off_cpu_and_cuda():
    from helen_tpu_torch.ops import gru_window_xp as gx
    from helen_tpu_torch.ops import gru_window_xp_bwd as gxb

    T, B, H = 3, 2, 16
    meta = lambda *s: torch.empty(s, device="meta")  # noqa: E731
    layer = {d: {"w_hh": meta(H, 3 * H), "b_hh": meta(3 * H)} for d in ("fwd", "bwd")}
    xp, h0, out = meta(T, B, 3 * H), meta(B, H), meta(T, B, H)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        gx.bigru_window_xp(xp, xp, h0, h0, layer)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        gxb.bigru_window_xp_bwd(xp, xp, h0, h0, out, out, out, out, h0, h0, layer)


# ---------------------------------------------------------------------------
# the projection (ops.gru_window_proj): its plain version and its backward
# are the expression the route had, bit for bit, on the CPU
# ---------------------------------------------------------------------------

def proj_source(kind, rng, T, B, H, start, grad=False):
    """(src, D) of one layer input kind: the uint8 image (D=90), a float32
    image (D=90) or the pair of halves (D=2H)."""
    if kind == "pair":
        src = tuple(torch.from_numpy(rng.uniform(-1, 1, (T, B, H)).astype(np.float32))
                    .requires_grad_(grad) for _ in range(2))
        return src, 2 * H
    if kind == "image":
        return torch.from_numpy(rng.integers(0, 256, (B, T + start + 3, F), dtype=np.uint8)), F
    image = rng.uniform(0, 8, (B, T + start + 3, F)).astype(np.float32)
    return torch.from_numpy(image).requires_grad_(grad), F


@pytest.mark.parametrize("kind", ["image", "dense", "pair"])
@pytest.mark.parametrize("T,B,H", [(3, 5, 41), (2, 7, 520)])
def test_xp_projection_plain_is_the_routes_expression(kind, T, B, H):
    """On CPU tensors ``bigru_window_xp_proj`` is ``window_input(...) @ w_ih
    + b_ih`` per direction, bit for bit, at ragged M = T B, N = 6H (H odd,
    and 520, no multiple of the kernel's 128 columns) and K (D = 90, 2H)."""
    from helen_tpu_torch.ops.gru_window_bwd import window_input
    from helen_tpu_torch.ops.gru_window_proj import bigru_window_xp_proj

    rng = np.random.default_rng(T * B + H)
    start = 2
    src, D = proj_source(kind, rng, T, B, H, start)
    layer = to_torch(make_layer(rng, D, H, w_ih_scale=1 / 8))
    x = window_input(src, start if kind != "pair" else 0, T, torch.float32)
    got = bigru_window_xp_proj(src, start if kind != "pair" else 0, T, layer)
    for g, d in zip(got, ("fwd", "bwd")):
        assert g.shape == (T, B, 3 * H)
        assert torch.equal(g, x @ layer[d]["w_ih"] + layer[d]["b_ih"]), d


@pytest.mark.parametrize("kind", ["image", "dense", "pair"])
def test_xp_projection_gradients_equal_the_routes_autograd(kind):
    """``_XpProjection``'s backward (dx, dW_ih, db_ih) equals torch's
    autograd of the expression the route had, bit for bit on the CPU, for
    the uint8 image (no dx), a float image and the pair."""
    from helen_tpu_torch.ops.gru_window_autograd import _XpProjection
    from helen_tpu_torch.ops.gru_window_bwd import window_input

    rng = np.random.default_rng(53)
    T, B, H, start = 4, 6, 41, 3 if kind != "pair" else 0
    src, D = proj_source(kind, rng, T, B, H, start, grad=True)
    layer = to_torch(make_layer(rng, D, H))
    leaves = [layer[d][k].requires_grad_(True) for d in ("fwd", "bwd") for k in ("w_ih", "b_ih")]
    cts = [torch.from_numpy(rng.standard_normal((T, B, 3 * H)).astype(np.float32))
           for _ in range(2)]
    inputs = list(src) if kind == "pair" else ([src] if kind == "dense" else [])
    xa, xb = src if kind == "pair" else (src, None)

    def grads(outs):
        return torch.autograd.grad(outs, inputs + leaves, cts)

    x = window_input(src, start, T, torch.float32)
    want = grads([x @ layer[d]["w_ih"] + layer[d]["b_ih"] for d in ("fwd", "bwd")])
    got = grads(_XpProjection.apply(start, T, torch.float32, xa, xb, *leaves))
    assert len(got) == len(want) == len(inputs) + 4
    for g, w in zip(got, want):
        assert g.shape == w.shape and torch.equal(g, w)


def test_xp_route_counts_no_projection_launch_on_cpu():
    """The xp layer on CPU tensors takes the plain versions: no launch of the
    projection or its split is counted, and ops.launch_counts() is empty."""
    from helen_tpu_torch import ops
    from helen_tpu_torch.ops import gru_window_proj as gp
    from helen_tpu_torch.ops.gru_window_autograd import window_xp

    assert "gru_window_proj" in ops.COUNTED
    rng = np.random.default_rng(7)
    T, B, H = 3, 4, 16
    ops.reset_launch_counts()
    src, D = proj_source("pair", rng, T, B, H, 0)
    h0 = [torch.zeros(B, H) for _ in range(2)]
    with torch.no_grad():
        window_xp(src, 0, T, *h0, to_torch(make_layer(rng, D, H)))
    assert gp.launch_counts == {"bigru_window_xp_proj": 0, "bigru_window_xp_proj_split": 0}
    assert ops.launch_counts() == {}


@pytest.mark.parametrize("pair,D,H", [(False, 90, 41), (True, 80, 40), (True, 1040, 520)])
def test_split_weights_plain_layout(pair, D, H):
    """The kernel's weights: (2, 6H, KP), KP whole chunks of 32 with zero rows
    at each pad; hi and lo TF32 values (13 low bits clear), hi the value
    rounded to nearest, hi + lo the weight within lo's own rounding."""
    from helen_tpu_torch.ops.gru_window_proj import CHUNK, proj_rows, split_weights_plain

    rng = np.random.default_rng(D + H)
    layer = to_torch(make_layer(rng, D, H))
    w = torch.cat([layer["fwd"]["w_ih"], layer["bwd"]["w_ih"]], 1)  # (D, 6H)
    rows = proj_rows(D, H, pair)
    half = -(-H // CHUNK) * CHUNK
    assert len(rows) % CHUNK == 0
    assert rows == (list(range(H)) + [-1] * (half - H) + list(range(H, 2 * H))
                    + [-1] * (half - H) if pair else list(range(D)) + [-1] * (len(rows) - D))
    s = split_weights_plain(layer, pair)
    assert s.shape == (2, 6 * H, len(rows)) and s.dtype == torch.float32
    assert not (s.view(torch.int32) & 0x1FFF).any()
    live = torch.tensor([r >= 0 for r in rows])
    assert not s[:, :, ~live].any()
    wt = w.t()[:, [r for r in rows if r >= 0]].double()
    hi, lo = s[0][:, live].double(), s[1][:, live].double()
    assert float((wt - hi).abs().max() / wt.abs().max()) <= 2.0 ** -11
    assert float(((wt - hi - lo).abs() / wt.abs().clamp_min(1e-30)).max()) <= 2.0 ** -21


def test_xp_projection_wrapper_raises_off_cpu_and_cuda():
    from helen_tpu_torch.ops.gru_window_proj import bigru_window_xp_proj

    T, B, H = 3, 2, 16
    meta = lambda *s: torch.empty(s, device="meta")  # noqa: E731
    layer = {d: {"w_ih": meta(2 * H, 3 * H), "b_ih": meta(3 * H)} for d in ("fwd", "bwd")}
    with pytest.raises(ValueError, match="CUDA or CPU"):
        bigru_window_xp_proj((meta(T, B, H), meta(T, B, H)), 0, T, layer)


# ---------------------------------------------------------------------------
# the route: dispatch, precision, and the slice as a whole
# ---------------------------------------------------------------------------

def tiny_params(h):
    """A numpy param tree of hidden size ``h``, all zeros: the dispatch
    reads only the shapes."""
    w = lambda *s: np.zeros(s, np.float32)  # noqa: E731
    gru = lambda d: {dr: {"w_ih": w(d, 3 * h), "w_hh": w(h, 3 * h), "b_ih": w(3 * h),  # noqa: E731
                          "b_hh": w(3 * h)} for dr in ("fwd", "bwd")}
    return {"encoder": gru(F), "decoder": gru(2 * h),
            "base_head": {"w": w(2 * h, 5), "b": w(5)},
            "rle_head": {"w": w(2 * h, 11), "b": w(11)}}


@pytest.mark.parametrize("h,want", [(128, "inproj"), (512, "inproj"), (640, "xp"),
                                    (1024, "xp"), (1025, "xp"), (2048, "xp")])
def test_dispatch_rule_by_hidden_size(monkeypatch, h, want):
    """The cuda backend's route at H = 128, 512, 640, 1024 and past 1024,
    on both surfaces, with a CUDA device passed as a value (no card
    needed): ``kernel_route``, ``engaged_kernel`` and ``resolve_backend``
    agree. The xp route has no fixed cap (``ROUTES["xp"]`` is None): its
    design rules refuse only a width the card's shared memory cannot hold
    at one row."""
    from helen_tpu_torch.models.transducer import (
        ROUTES,
        engaged_kernel,
        kernel_route,
        resolve_backend,
    )

    from helen_tpu_torch.ops import library

    # the H100's SMs and opt-in shared memory per block, set by hand
    monkeypatch.setattr(library, "_card", {0: (132, 232_448)})
    assert ROUTES["xp"] is None
    p = tiny_params(h)
    cuda = torch.device("cuda")
    assert kernel_route(h) == want
    assert engaged_kernel(p, "cuda") == f"cuda_{want}"
    assert engaged_kernel(p, "torch") == "torch"
    assert resolve_backend(None, cuda, p) == "cuda"
    assert resolve_backend("auto", cuda, p, kind="train") == "cuda"
    # the xp route takes every hidden size; the in-projection kernels none
    # past MAX_H
    assert engaged_kernel(p, "cuda", route="xp") == "cuda_xp"
    if h > 512:
        with pytest.raises(ValueError, match="inproj window kernels' maximum 512"):
            engaged_kernel(p, "cuda", route="inproj")
    with pytest.raises(ValueError, match="not one of"):
        kernel_route(h, route="fast")
    with pytest.raises(ValueError, match="backend 'cuda'"):
        engaged_kernel(p, "torch", route="xp")


def test_entries_run_the_xp_route_in_fp32(tmp_path):
    """TF32 would flip labels: the guard on the xp route refuses a CUDA
    product under TF32, and every entry that reaches the route (consensus,
    the Trainer, ``test``) turns TF32 off before it runs."""
    from helen_tpu_torch.infer.consensus import ConsensusStep
    from helen_tpu_torch.io.checkpoint import save_checkpoint
    from helen_tpu_torch.io.synthetic import random_sequence, write_image_file
    from helen_tpu_torch.models.transducer import require_fp32_precision
    from helen_tpu_torch.train.evaluate import test_interface
    from helen_tpu_torch.train.train_loop import Trainer

    flag = torch.backends.cuda.matmul
    before = flag.allow_tf32
    try:
        flag.allow_tf32 = True
        with pytest.raises(RuntimeError, match="TF32"):
            require_fp32_precision(torch.device("cuda"))
        require_fp32_precision(torch.device("cpu"))  # the CPU has no TF32
        p = tiny_params(640)
        ConsensusStep(p, "cpu")
        assert not flag.allow_tf32
        require_fp32_precision(torch.device("cuda"))

        d = tmp_path / "img"
        d.mkdir()
        write_image_file(str(d / "i.h5"), {"c": random_sequence(900, seed=3)},
                         region_cols=1000, overlap_cols=0)
        ckpt = str(tmp_path / "m.npz")
        save_checkpoint(ckpt, tiny_params(16), meta={"epochs": 0})
        flag.allow_tf32 = True
        test_interface(str(d), ckpt, batch_size=2, num_workers=1,
                       output_dir=str(tmp_path / "t"), device="cpu")
        assert not flag.allow_tf32
        flag.allow_tf32 = True
        Trainer([str(d / "i.h5")], [str(d / "i.h5")], model_dir=str(tmp_path / "m"),
                stats_dir=str(tmp_path / "s"), retrain_model_path=ckpt, device="cpu")
        assert not flag.allow_tf32
    finally:
        flag.allow_tf32 = before


def random_params(h, layers, seed):
    from helen_tpu.config import ModelConfig
    from helen_tpu.models.transducer import init_params

    p = init_params(jax.random.PRNGKey(seed), ModelConfig(hidden_size=h, gru_layers=layers))
    return jax.tree_util.tree_map(np.asarray, p)


def test_wide_model_consensus_matches_helen_tpu():
    """The slice as a whole: an H=640 model, carried across from helen_tpu's
    params, through the port's ``consensus_probs`` on the cuda backend (the
    xp route; on CPU tensors the plain K3) against helen_tpu's
    ``consensus_probs(backend="xla")``: votes within 1e-5, labels equal."""
    from helen_tpu.config import WindowConfig as JaxWindow
    from helen_tpu.models.transducer import consensus_probs as jax_probs

    from helen_tpu_torch.config import WindowConfig
    from helen_tpu_torch.models.transducer import consensus_probs, engaged_kernel

    params = random_params(640, 1, seed=640)
    rng = np.random.default_rng(640)
    images = rng.integers(0, 40, size=(2, 60, F), dtype=np.uint8)
    jb, jr = jax_probs(jax.tree_util.tree_map(jnp.asarray, params),
                       jnp.asarray(images, jnp.float32), JaxWindow(window=20, jump=10),
                       backend="xla")
    tp = to_torch(params)
    assert engaged_kernel(tp, "cuda") == "cuda_xp"
    with torch.no_grad():
        tb, tr = consensus_probs(tp, torch.from_numpy(images),
                                 WindowConfig(window=20, jump=10), backend="cuda")
    for got, want in ((tb, jb), (tr, jr)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)
        np.testing.assert_array_equal(got.argmax(-1).numpy(), np.asarray(want).argmax(-1))


@pytest.mark.parametrize("fixture", sorted(FIXTURES))
def test_golden_labels_through_the_forced_xp_route(fixture, tmp_path):
    """The three golden geometries (H=128, 2 layers, H=160) through the xp
    route forced on the cuda backend (plain K3 on CPU tensors): 0 label
    flips against the recorded reference labels."""
    from helen_tpu_torch.io.checkpoint import load_model_any, params_to_torch
    from helen_tpu_torch.io.images import MarginPolishDataset
    from helen_tpu_torch.models.transducer import consensus_labels

    ckpt, labels, _ = FIXTURES[fixture]
    d = stage_golden_images(tmp_path)
    ds = MarginPolishDataset([f"{d}/golden_images.h5"])
    recs = [ds.load(i) for i in range(len(ds))]
    params, _ = load_model_any(golden(ckpt))
    with torch.no_grad():
        base, rle = consensus_labels(params_to_torch(params, "cpu"),
                                     torch.from_numpy(np.stack([r.image for r in recs])),
                                     backend="cuda", route="xp")
    want = np.load(golden(labels))
    for j, r in enumerate(recs):
        k = f"{r.contig}-{r.contig_start}-{r.contig_end}-{r.chunk_id}"
        np.testing.assert_array_equal(base[j].numpy(), want[f"base/{k}"], err_msg=k)
        np.testing.assert_array_equal(rle[j].numpy(), want[f"rle/{k}"], err_msg=k)


def test_tbptt_batch_xp_route_matches_inproj_route():
    """One TBPTT batch (3 windows, a padded row) at H=128 through the xp
    route and through the in-projection route of the cuda backend (their
    plain versions, forward and backward, on CPU tensors) from the same
    params: loss sums 1e-5 relative, params within 2e-5."""
    from helen_tpu_torch.config import MODEL
    from helen_tpu_torch.models.transducer import init_params, param_leaves
    from helen_tpu_torch.train.train_loop import Adam, tbptt_step

    rng = np.random.default_rng(12)
    B, L, valid = 3, 200, 2
    images = torch.from_numpy(rng.integers(0, 20, (B, L, F), dtype=np.uint8))
    yb = torch.from_numpy(rng.integers(0, 5, (B, L)))
    yr = torch.from_numpy(rng.integers(0, 11, (B, L)))
    runs = {}
    for route in ("xp", "inproj"):
        p = init_params(torch.Generator().manual_seed(3), MODEL)
        for t in param_leaves(p):
            t.requires_grad_(True)
        adam = Adam(0.0)
        state = adam.init(p)
        tot = tbptt_step(p, adam, state, 1e-4, images, yb, yr, valid, "cuda", route=route)
        runs[route] = ([float(v) for v in tot], [t.detach() for t in param_leaves(p)])
    (xs, xp_), (ks, kp) = runs["xp"], runs["inproj"]
    np.testing.assert_allclose(xs, ks, rtol=1e-5)
    for a, b in zip(xp_, kp):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=2e-5, rtol=0)


def test_wide_checkpoint_carries_across(tmp_path):
    """helen_tpu's ``save_checkpoint`` writes an H=640 model; the port's
    ``load_checkpoint`` reads it with every leaf equal, and its geometry
    takes the xp route."""
    from helen_tpu.io.checkpoint import save_checkpoint as jsave

    from helen_tpu_torch.io.checkpoint import flatten_tree, load_checkpoint, params_to_torch
    from helen_tpu_torch.models.transducer import engaged_kernel, model_geometry

    params = random_params(640, 1, seed=6)
    path = str(tmp_path / "wide.npz")
    jsave(path, jax.tree_util.tree_map(jnp.asarray, params),
          meta={"epochs": 3, "hidden_size": 640})
    got, meta = load_checkpoint(path)
    assert meta["epochs"] == 3 and meta["hidden_size"] == 640
    g, w = flatten_tree(got), flatten_tree(params)
    assert sorted(g) == sorted(w)
    for k in g:
        assert g[k].dtype == w[k].dtype == np.float32
        np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    tp = params_to_torch(got, "cpu")
    assert model_geometry(tp).hidden_size == 640
    assert engaged_kernel(tp, "cuda") == "cuda_xp"


@pytest.mark.parametrize("fails", ["compile", "link"])
def test_a_failed_build_raises_and_leaves_no_objects(fails, tmp_path, monkeypatch):
    """The kernel library builds one nvcc per source, then links: a source
    that does not compile, or a link that fails, raises with nvcc's message
    and leaves neither objects nor a library behind (a stand-in nvcc on
    PATH refuses the xp backward's source or the link)."""
    from helen_tpu_torch.ops import library
    from helen_tpu_torch.utils import build

    bindir, out = tmp_path / "bin", tmp_path / "build"
    bindir.mkdir()
    out.mkdir()
    nvcc = bindir / "nvcc"
    nvcc.write_text(
        "#!/bin/sh\n"
        'out=""; prev=""\n'
        'for a in "$@"; do [ "$prev" = "-o" ] && out="$a"; prev="$a"; done\n'
        'case "$*" in\n'
        f"  *-shared*) [ {fails} = link ] && {{ echo 'link refused' >&2; exit 2; }} ;;\n"
        f"  *gru_window_xp_bwd.cu*) [ {fails} = compile ] && "
        "{ echo 'ptxas refused' >&2; exit 1; } ;;\n"
        "esac\n"
        ': > "$out"\n')
    nvcc.chmod(0o755)
    monkeypatch.setenv("PATH", str(bindir))
    monkeypatch.setattr(build, "build_dir", lambda name: str(out))
    with pytest.raises(RuntimeError, match=f"{'link' if fails == 'link' else 'ptxas'} refused"):
        library.build_kernels()
    assert list(out.iterdir()) == []
