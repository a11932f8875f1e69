"""The CUDA window kernels (forward K1/K2 and their backward; the xp-stream
K3 and K4 of the wide models; the fast tier's K1f, K2f and K3f; the fused
encoder+decoder K5 and K5f, also against K1 -> K2 chained, bit for bit)
against their plain versions, on the GPU.

These tests need an NVIDIA GPU with ``nvcc`` (the kernels build for sm_90a
from helen_tpu_torch/ops/csrc at first use); elsewhere they skip. They
import neither JAX nor helen_tpu, so they run on a GPU host without JAX:

    python -m pytest tests/test_torch_cuda.py --noconftest -q

Tolerance 1e-5: kernel and plain version compute the same fp32 arithmetic
with sums taken in another order (the kernel's FMA chain against the CPU's
or cuBLAS's blocked products). For the backward the bound is 1e-5 times
the output's largest magnitude (at least 1): its weight cotangents are sums
over all T*B rows of the window, whose rounding grows with their size.
The fast kernels are held to 1e-3 (FAST_TOL): where kernel and plain version
sum in another order, the bf16 rounding of h can land one bf16 ulp (2^-8
relative) apart, times a weight of at most 1/sqrt(H).
"""
import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda

TOL = 1e-5
FAST_TOL = 1e-3


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA window kernels have no CPU mode")
    from helen_tpu_torch.models.transducer import set_fp32_precision

    set_fp32_precision()
    return torch.device("cuda")


def make_layer(rng, d, h, dev, w_ih_scale=1.0):
    k = 1.0 / np.sqrt(h)
    u = lambda *s: rng.uniform(-k, k, s).astype(np.float32)  # noqa: E731
    return {dr: {n: torch.from_numpy(a).to(dev) for n, a in
                 (("w_ih", u(d, 3 * h) * np.float32(w_ih_scale)), ("w_hh", u(h, 3 * h)),
                  ("b_ih", u(3 * h)), ("b_hh", u(3 * h)))} for dr in ("fwd", "bwd")}


def assert_outputs_close(got, want, tol=TOL):
    for g, w, what in zip(got, want, ("out_f", "out_b", "h_f", "h_b")):
        assert g.shape == w.shape and g.dtype == torch.float32, what
        err = float((g - w).abs().max())
        assert err <= tol, f"{what}: max |kernel - plain| {err}"


# ragged batch edges (not a multiple of the kernel's 8-row block), the
# flagship H and an off-grid one, the flagship window and a short one
@pytest.mark.parametrize("T,B,H", [(100, 512, 128), (7, 13, 160), (5, 3, 128)])
def test_k1_kernel_matches_plain(dev, T, B, H):
    from helen_tpu_torch.ops import gru_window as gw

    rng = np.random.default_rng(T * B + H)
    L, start = T + 30, 17
    image = torch.from_numpy(rng.integers(0, 256, size=(B, L, 90), dtype=np.uint8)).to(dev)
    h0f, h0b = (torch.from_numpy(rng.uniform(-1, 1, (B, H)).astype(np.float32)).to(dev)
                for _ in range(2))
    layer = make_layer(rng, 90, H, dev, w_ih_scale=1 / 64)
    before = gw.launch_counts["bigru_window_in1"]
    got = gw.bigru_window_in1(image, start, T, h0f, h0b, layer)
    torch.cuda.synchronize()
    assert gw.launch_counts["bigru_window_in1"] == before + 1
    assert_outputs_close(got, gw.bigru_window_in1_plain(image, start, T, h0f, h0b, layer))


@pytest.mark.parametrize("T,B,H", [(100, 512, 128), (7, 13, 160), (5, 3, 128)])
def test_k2_kernel_matches_plain(dev, T, B, H):
    from helen_tpu_torch.ops import gru_window as gw

    rng = np.random.default_rng(T * B + H + 1)
    xa, xb = (torch.from_numpy(rng.standard_normal((T, B, H)).astype(np.float32)).to(dev)
              for _ in range(2))
    h0f, h0b = (torch.from_numpy(rng.uniform(-1, 1, (B, H)).astype(np.float32)).to(dev)
                for _ in range(2))
    layer = make_layer(rng, 2 * H, H, dev)
    before = gw.launch_counts["bigru_window_in2"]
    got = gw.bigru_window_in2(xa, xb, h0f, h0b, layer)
    torch.cuda.synchronize()
    assert gw.launch_counts["bigru_window_in2"] == before + 1
    assert_outputs_close(got, gw.bigru_window_in2_plain(xa, xb, h0f, h0b, layer))


def test_wrappers_refuse_what_the_kernels_do_not_take(dev):
    from helen_tpu_torch.ops import gru_window as gw

    rng = np.random.default_rng(5)
    T, B, H = 4, 8, 128
    layer = make_layer(rng, 90, H, dev)
    h0 = torch.zeros(B, H, device=dev)
    image = torch.zeros(B, 10, 90, dtype=torch.uint8, device=dev)
    with pytest.raises(ValueError):  # float image
        gw.bigru_window_in1(image.float(), 0, T, h0, h0, layer)
    with pytest.raises(ValueError):  # window past the image's end
        gw.bigru_window_in1(image, 8, T, h0, h0, layer)
    with pytest.raises(ValueError):  # h0 on the CPU
        gw.bigru_window_in1(image, 0, T, h0.cpu(), h0, layer)
    x = torch.zeros(T, B, H, device=dev)
    layer2 = make_layer(rng, 2 * H, H, dev)
    with pytest.raises(ValueError):  # non-contiguous half
        gw.bigru_window_in2(x.transpose(0, 1).contiguous().transpose(0, 1), x, h0, h0,
                            layer2)
    with pytest.raises(ValueError):  # K1's weights given to K2
        gw.bigru_window_in2(x, x, h0, h0, layer)


def test_consensus_kernels_match_plain_labels(dev):
    """The whole 19-window vote through the kernels against the plain route
    on the card, with random flagship weights."""
    from helen_tpu_torch.io.checkpoint import params_to_torch
    from helen_tpu_torch.models.transducer import consensus_probs

    rng = np.random.default_rng(9)
    H = 128
    k = 1.0 / np.sqrt(H)

    def stack(d):
        return {dr: {"w_ih": rng.uniform(-k, k, (d, 3 * H)), "w_hh": rng.uniform(-k, k, (H, 3 * H)),
                     "b_ih": rng.uniform(-k, k, 3 * H), "b_hh": rng.uniform(-k, k, 3 * H)}
                for dr in ("fwd", "bwd")}

    params = params_to_torch({
        "encoder": stack(90), "decoder": stack(2 * H),
        "base_head": {"w": rng.uniform(-k, k, (2 * H, 5)), "b": rng.uniform(-k, k, 5)},
        "rle_head": {"w": rng.uniform(-k, k, (2 * H, 11)), "b": rng.uniform(-k, k, 11)},
    }, dev)
    images = torch.from_numpy(rng.integers(0, 40, size=(64, 1000, 90), dtype=np.uint8)).to(dev)
    kb, kr = consensus_probs(params, images, backend="cuda")
    pb, pr = consensus_probs(params, images, backend="torch")
    assert float((kb - pb).abs().max()) <= 1e-4
    assert float((kr - pr).abs().max()) <= 1e-4


def _scaled_close(got, want, what):
    scale = max(1.0, float(want.abs().max()))
    err = float((got - want).abs().max())
    assert err <= TOL * scale, f"{what}: max |kernel - plain| {err} (scale {scale})"


def bwd_case(rng, kind, T, B, H, dev):
    """Inputs of one backward launch: the layer input, forward outputs (from
    the plain forward), nonzero h0, dout and final-state cotangents."""
    from helen_tpu_torch.ops import gru_window as gw

    r = lambda *s: torch.from_numpy(rng.uniform(-1, 1, s).astype(np.float32)).to(dev)  # noqa: E731
    h0f, h0b, dhf, dhb = (r(B, H) for _ in range(4))
    if kind == "image":
        start = 11
        src = torch.from_numpy(rng.integers(0, 256, (B, T + 20, 90), dtype=np.uint8)).to(dev)
        layer = make_layer(rng, 90, H, dev, w_ih_scale=1 / 64)
        of, ob, _, _ = gw.bigru_window_in1_plain(src, start, T, h0f, h0b, layer)
    else:
        start = 0
        src = (r(T, B, H), r(T, B, H))
        layer = make_layer(rng, 2 * H, H, dev)
        of, ob, _, _ = gw.bigru_window_in2_plain(*src, h0f, h0b, layer)
    return (src, start, h0f, h0b, of.contiguous(), ob.contiguous(), r(T, B, H),
            r(T, B, H), dhf, dhb, layer)


def assert_grads_close(got, want):
    dx, dh0f, dh0b, g = got
    wdx, wdh0f, wdh0b, wg = want
    assert (dx is None) == (wdx is None)
    if dx is not None:
        _scaled_close(dx, wdx, "dx")
    _scaled_close(dh0f, wdh0f, "dh0_f")
    _scaled_close(dh0b, wdh0b, "dh0_b")
    for d in ("fwd", "bwd"):
        for k in ("w_ih", "w_hh", "b_ih", "b_hh"):
            assert g[d][k].shape == wg[d][k].shape, (d, k)
            _scaled_close(g[d][k], wg[d][k], f"{d}.{k}")


def bwd_counts(before, design, dx):
    """The backward's launch counts after one bigru_window_bwd from
    ``before``: each pass once, and pass 1's kernels in ``design``."""
    ran = ["bigru_window_bwd_rec", "bigru_window_bwd_wgrad"]
    if design == "smem":
        ran += ["bigru_window_bwd_hp", "bigru_window_bwd_rec_smem"]
        ran += ["bigru_window_bwd_dx"] if dx else []
    else:
        ran += ["bigru_window_bwd_rec_chain"]
    return {k: v + (k in ran) for k, v in before.items()}


# ragged batches (1, 13, 257 rows against the 8-row block), H=160, both
# layer kinds; layer 0 (the image) has no dx
@pytest.mark.parametrize("kind,T,B,H", [("image", 7, 1, 128), ("image", 9, 13, 128),
                                        ("pair", 6, 257, 128), ("image", 5, 13, 160),
                                        ("pair", 5, 13, 160), ("pair", 100, 64, 128)])
def test_backward_kernel_matches_plain(dev, kind, T, B, H):
    from helen_tpu_torch.ops import gru_window_bwd as gb

    args = bwd_case(np.random.default_rng(T * B + H), kind, T, B, H, dev)
    before = dict(gb.launch_counts)
    got = gb.bigru_window_bwd(*args)
    torch.cuda.synchronize()
    assert gb.launch_counts == bwd_counts(before, gb.bwd_design(H, B), kind == "pair")
    assert (got[0] is None) == (kind == "image")
    assert_grads_close(got, gb.bigru_window_bwd_plain(*args, need_dx=kind == "pair"))


def test_backward_kernel_dx_off_for_pairs(dev):
    from helen_tpu_torch.ops import gru_window_bwd as gb

    args = bwd_case(np.random.default_rng(3), "pair", 5, 9, 128, dev)
    got = gb.bigru_window_bwd(*args, need_dx=False)
    assert got[0] is None
    assert_grads_close(got, gb.bigru_window_bwd_plain(*args, need_dx=False))


def test_backward_kernel_is_bit_identical_across_launches(dev):
    from helen_tpu_torch.ops import gru_window_bwd as gb

    args = bwd_case(np.random.default_rng(4), "pair", 50, 100, 128, dev)
    a, b = gb.bigru_window_bwd(*args), gb.bigru_window_bwd(*args)
    flat = lambda r: [r[0], r[1], r[2]] + [r[3][d][k] for d in ("fwd", "bwd")  # noqa: E731
                                            for k in ("w_ih", "w_hh", "b_ih", "b_hh")]
    for x, y in zip(flat(a), flat(b)):
        assert torch.equal(x, y)


@pytest.mark.parametrize("layers", [1, 2])
def test_window_gradients_kernel_route_match_plain_route(dev, layers):
    """One transducer window, loss on both heads and the new hidden:
    gradients through the kernels (forward K1/K2, backward kernel) against
    torch's autograd of the plain route, with 1 and 2 layers."""
    from helen_tpu_torch.config import MODEL
    from helen_tpu_torch.io.checkpoint import params_to_torch
    from helen_tpu_torch.models.transducer import forward, init_params, param_leaves

    cfg = __import__("dataclasses").replace(MODEL, gru_layers=layers)
    params_cpu = init_params(torch.Generator().manual_seed(layers), cfg)
    rng = np.random.default_rng(layers)
    image = torch.from_numpy(rng.integers(0, 30, (40, 300, 90), dtype=np.uint8)).to(dev)
    hidden = torch.from_numpy(rng.uniform(-1, 1, (40, 2 * layers, 128)).astype(np.float32)).to(dev)
    w = [torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(dev)
         for s in ((40, 100, 5), (40, 100, 11), (40, 2 * layers, 128))]
    grads = {}
    for backend in ("cuda", "torch"):
        p = params_to_torch(params_cpu, dev)
        for t in param_leaves(p):
            t.requires_grad_(True)
        h = hidden.clone().requires_grad_(True)
        base, rle, hn = forward(p, image, h, backend, start=150, window=100)
        ((base * w[0]).sum() + (rle * w[1]).sum() + (hn * w[2]).sum()).backward()
        grads[backend] = [t.grad for t in param_leaves(p)] + [h.grad]
    for i, (k, q) in enumerate(zip(grads["cuda"], grads["torch"])):
        _scaled_close(k, q, f"leaf {i}")


def test_backward_wrapper_refuses_what_the_kernel_does_not_take(dev):
    from helen_tpu_torch.ops import gru_window_bwd as gb

    src, start, h0f, h0b, of, ob, dof, dob, dhf, dhb, layer = bwd_case(
        np.random.default_rng(6), "image", 4, 8, 128, dev)
    rest = (h0f, h0b, of, ob, dof, dob, dhf, dhb, layer)
    with pytest.raises(ValueError):  # float image
        gb.bigru_window_bwd(src.float(), start, *rest)
    with pytest.raises(ValueError):  # window past the image's end
        gb.bigru_window_bwd(src, src.shape[1] - 2, *rest)
    with pytest.raises(ValueError):  # a cotangent on the CPU
        gb.bigru_window_bwd(src, start, h0f, h0b, of, ob, dof.cpu(), dob, dhf, dhb, layer)
    with pytest.raises(TypeError):  # a float64 cotangent
        gb.bigru_window_bwd(src, start, h0f, h0b, of, ob, dof.double(), dob, dhf, dhb, layer)
    with pytest.raises(ValueError):  # a cotangent of the wrong shape
        gb.bigru_window_bwd(src, start, h0f, h0b, of, ob, dof[:-1], dob, dhf, dhb, layer)
    with pytest.raises(ValueError):  # non-contiguous forward output
        gb.bigru_window_bwd(src, start, h0f, h0b, of.transpose(0, 1).contiguous()
                            .transpose(0, 1), ob, dof, dob, dhf, dhb, layer)


# ---------------------------------------------------------------------------
# the xp-stream kernels (K3, K4) of the wide models
# ---------------------------------------------------------------------------

def xp_case(rng, T, B, H, dev):
    """Projected streams, h0 pair and a layer (its w_ih is not read)."""
    r = lambda *s: torch.from_numpy(rng.uniform(-1, 1, s).astype(np.float32)).to(dev)  # noqa: E731
    return r(T, B, 3 * H), r(T, B, 3 * H), r(B, H), r(B, H), make_layer(rng, 2 * H, H, dev)


def smem_budget():
    """The card's opt-in shared memory per block, as the design rules read it."""
    from helen_tpu_torch.ops.library import card_limits

    return card_limits()[1]


def xp_ran(name, H, design, fast=False):
    """The launch counters that one K3 (``fast``: K3f) launch in ``design``
    moves: its own, its design's kernel's and, for the chain, the one of
    its rows per block."""
    from helen_tpu_torch.ops import gru_window_xp as gx

    ran = (name, f"{name}_{design}")
    if design == "chain":
        ran += (f"{name}_chain_r{gx.chain_rows(H, smem_budget(), fast)}",)
    return ran


# the wide training and inference widths, an off-grid one and one that is
# not a multiple of the block's threads, ragged batches (1, 13, 17 rows
# against the 8-row block)
@pytest.mark.parametrize("T,B,H", [(100, 64, 1024), (7, 13, 640), (5, 3, 160),
                                   (9, 17, 1000), (4, 1, 1024), (5, 13, 1056),
                                   (3, 9, 2048)])
def test_k3_kernel_matches_plain(dev, T, B, H):
    from helen_tpu_torch.ops import gru_window_xp as gx

    args = xp_case(np.random.default_rng(T * B + H), T, B, H, dev)
    before = gx.launch_counts["bigru_window_xp"]
    got = gx.bigru_window_xp(*args)
    torch.cuda.synchronize()
    assert gx.launch_counts["bigru_window_xp"] == before + 1
    assert_outputs_close(got, gx.bigru_window_xp_plain(*args))


def xp_bwd_case(rng, T, B, H, dev):
    """Inputs of one K4 launch: streams, forward outputs (from the plain
    forward), nonzero h0, dout and final-state cotangents."""
    from helen_tpu_torch.ops import gru_window_xp as gx

    xp_f, xp_b, h0f, h0b, layer = xp_case(rng, T, B, H, dev)
    of, ob, _, _ = gx.bigru_window_xp_plain(xp_f, xp_b, h0f, h0b, layer)
    r = lambda *s: torch.from_numpy(rng.uniform(-1, 1, s).astype(np.float32)).to(dev)  # noqa: E731
    return (xp_f, xp_b, h0f, h0b, of.contiguous(), ob.contiguous(), r(T, B, H),
            r(T, B, H), r(B, H), r(B, H), layer)


def assert_xp_grads_close(got, want):
    for what, g, w in zip(("dxp_f", "dxp_b", "dh0_f", "dh0_b"), got[:4], want[:4]):
        _scaled_close(g, w, what)
    for d in ("fwd", "bwd"):
        for k in ("w_hh", "b_hh"):
            assert got[4][d][k].shape == want[4][d][k].shape, (d, k)
            _scaled_close(got[4][d][k], want[4][d][k], f"{d}.{k}")


@pytest.mark.parametrize("T,B,H", [(7, 1, 1024), (6, 13, 640), (5, 9, 160),
                                   (50, 64, 1024)])
def test_xp_backward_kernel_matches_plain(dev, T, B, H):
    from helen_tpu_torch.ops import gru_window_xp_bwd as gxb
    from helen_tpu_torch.ops import gru_window_xp_bwd_grid as gg

    args = xp_bwd_case(np.random.default_rng(T * B + H), T, B, H, dev)
    assert gxb.xp_bwd_design(H, B) == "grid"
    before = dict(gxb.launch_counts)
    got = gxb.bigru_window_xp_bwd(*args)
    torch.cuda.synchronize()
    ran = ("bigru_window_xp_bwd_rec", "bigru_window_xp_bwd_wgrad", "bigru_window_xp_bwd_hp",
           "bigru_window_xp_bwd_rec_grid", f"bigru_window_xp_bwd_rec_grid_r{gg.grid_tile(B)}")
    assert gxb.launch_counts == {k: v + (k in ran) for k, v in before.items()}
    assert_xp_grads_close(got, gxb.bigru_window_xp_bwd_plain(*args))


def test_xp_backward_kernel_is_bit_identical_across_launches(dev):
    from helen_tpu_torch.ops import gru_window_xp_bwd as gxb

    args = xp_bwd_case(np.random.default_rng(8), 40, 24, 1024, dev)
    a, b = gxb.bigru_window_xp_bwd(*args), gxb.bigru_window_xp_bwd(*args)
    flat = lambda r: list(r[:4]) + [r[4][d][k] for d in ("fwd", "bwd")  # noqa: E731
                                    for k in ("w_hh", "b_hh")]
    for x, y in zip(flat(a), flat(b)):
        assert torch.equal(x, y)


@pytest.mark.parametrize("H,route", [(128, "xp"), (640, None)])
def test_window_gradients_xp_route_match_plain_route(dev, H, route):
    """One transducer window through the xp route (projection GEMMs, K3,
    K4; forced at H=128, the dispatch rule's own at H=640) against torch's
    autograd of the plain route: every param and the carried hidden."""
    import dataclasses

    from helen_tpu_torch.config import MODEL
    from helen_tpu_torch.io.checkpoint import params_to_torch
    from helen_tpu_torch.models.transducer import (
        engaged_kernel,
        forward,
        init_params,
        param_leaves,
    )

    params_cpu = init_params(torch.Generator().manual_seed(H),
                             dataclasses.replace(MODEL, hidden_size=H))
    rng = np.random.default_rng(H)
    image = torch.from_numpy(rng.integers(0, 30, (24, 300, 90), dtype=np.uint8)).to(dev)
    hidden = torch.from_numpy(rng.uniform(-1, 1, (24, 2, H)).astype(np.float32)).to(dev)
    w = [torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(dev)
         for s in ((24, 100, 5), (24, 100, 11), (24, 2, H))]
    grads = {}
    for backend in ("cuda", "torch"):
        p = params_to_torch(params_cpu, dev)
        for t in param_leaves(p):
            t.requires_grad_(True)
        h = hidden.clone().requires_grad_(True)
        r = route if backend == "cuda" else None
        if backend == "cuda":
            assert engaged_kernel(p, backend, r) == "cuda_xp"
        base, rle, hn = forward(p, image, h, backend, start=150, window=100, route=r)
        ((base * w[0]).sum() + (rle * w[1]).sum() + (hn * w[2]).sum()).backward()
        grads[backend] = [t.grad for t in param_leaves(p)] + [h.grad]
    for i, (k, q) in enumerate(zip(grads["cuda"], grads["torch"])):
        _scaled_close(k, q, f"leaf {i}")


def test_xp_wrappers_refuse_what_the_kernels_do_not_take(dev):
    from helen_tpu_torch.ops import gru_window_xp as gx
    from helen_tpu_torch.ops import gru_window_xp_bwd as gxb

    xp_f, xp_b, h0f, h0b, layer = xp_case(np.random.default_rng(2), 4, 8, 640, dev)
    with pytest.raises(TypeError):  # a float64 stream
        gx.bigru_window_xp(xp_f.double(), xp_b, h0f, h0b, layer)
    with pytest.raises(ValueError):  # the streams' shapes differ
        gx.bigru_window_xp(xp_f, xp_b[:-1], h0f, h0b, layer)
    with pytest.raises(ValueError):  # h0 on the CPU
        gx.bigru_window_xp(xp_f, xp_b, h0f.cpu(), h0b, layer)
    with pytest.raises(ValueError):  # a weight on the CPU
        gx.bigru_window_xp(xp_f, xp_b, h0f, h0b,
                           {"fwd": {k: v.cpu() for k, v in layer["fwd"].items()},
                            "bwd": layer["bwd"]})
    with pytest.raises(ValueError):  # non-contiguous stream
        gx.bigru_window_xp(xp_f.transpose(0, 1).contiguous().transpose(0, 1), xp_b,
                           h0f, h0b, layer)
    # past 1024 the chain takes the width (8 rows per block at H=1056) ...
    wide = xp_case(np.random.default_rng(3), 2, 8, 1056, dev)
    for g, w in zip(gx.bigru_window_xp(*wide), gx.bigru_window_xp_plain(*wide)):
        assert (g - w).abs().max().item() <= 1e-5
    # ... and only a width whose state does not fit one row is refused
    with pytest.raises(ValueError, match="use --backend torch"):
        gx.xp_fwd_design(29_100, 8)

    args = xp_bwd_case(np.random.default_rng(4), 4, 8, 640, dev)
    xp_f, xp_b, h0f, h0b, of, ob, dof, dob, dhf, dhb, layer = args
    with pytest.raises(TypeError):  # a float64 cotangent
        gxb.bigru_window_xp_bwd(xp_f, xp_b, h0f, h0b, of, ob, dof.double(), dob, dhf,
                                dhb, layer)
    with pytest.raises(ValueError):  # a cotangent on the CPU
        gxb.bigru_window_xp_bwd(xp_f, xp_b, h0f, h0b, of, ob, dof, dob, dhf.cpu(), dhb,
                                layer)
    with pytest.raises(ValueError):  # a stream of the wrong shape
        gxb.bigru_window_xp_bwd(xp_f[:, :-1], xp_b, h0f, h0b, of, ob, dof, dob, dhf, dhb,
                                layer)
    wide = xp_bwd_case(np.random.default_rng(5), 2, 8, 1056, dev)
    assert gxb.xp_bwd_design(1056, 8) == "chain"
    gxb.bigru_window_xp_bwd(*wide)  # pass 1 at 8 rows per block
    with pytest.raises(ValueError, match="use --backend torch"):
        gxb.xp_bwd_design(11_700, 8)


# ---------------------------------------------------------------------------
# the xp route's projection (ops.gru_window_proj): 3xTF32 on the tensor cores
# ---------------------------------------------------------------------------

def proj_case(rng, kind, T, B, H, dev):
    """(src, start, layer) of one projection: the uint8 image at D=90 (W_ih
    at the scale of the published model's), or the pair of halves in (-1, 1)."""
    if kind == "pair":
        src = tuple(torch.from_numpy(rng.uniform(-1, 1, (T, B, H)).astype(np.float32)).to(dev)
                    for _ in range(2))
        return src, 0, make_layer(rng, 2 * H, H, dev)
    image = rng.integers(0, 256, size=(B, 1000, 90), dtype=np.uint8)
    return torch.from_numpy(image).to(dev), 450, make_layer(rng, 90, H, dev, w_ih_scale=1 / 64)


def proj_error(got, x, layer):
    """Largest |got - x @ w_ih + b_ih| over both directions, the reference in
    float64."""
    return max(float((g.double() - (x.double() @ layer[d]["w_ih"].double()
                                    + layer[d]["b_ih"].double())).abs().max())
               for g, d in zip(got, ("fwd", "bwd")))


# D = 90 (the image), 2048 and 4096 (the halves of H = 1024 and 2048), at the
# wide train's and the consensus batch
@pytest.mark.parametrize("kind,H", [("image", 1024), ("pair", 1024), ("pair", 2048)])
@pytest.mark.parametrize("B", [64, 512])
def test_xp_projection_error_is_fp32s_not_tf32s(dev, kind, H, B):
    """Against a float64 product, the kernel's largest error is at most 4x
    that of torch.matmul in float32 (TF32 off) and at least 50x below
    single-pass TF32's: 3xTF32, never single-pass TF32. Two launches give
    the same bits, and each adds one launch."""
    from helen_tpu_torch.ops import gru_window_proj as gp
    from helen_tpu_torch.ops.gru_window_bwd import window_input

    T = 100
    src, start, layer = proj_case(np.random.default_rng(B + H), kind, T, B, H, dev)
    before = gp.launch_counts["bigru_window_xp_proj"]
    got = gp.bigru_window_xp_proj(src, start, T, layer)
    again = gp.bigru_window_xp_proj(src, start, T, layer)
    torch.cuda.synchronize()
    assert gp.launch_counts["bigru_window_xp_proj"] == before + 2
    assert all(g.shape == (T, B, 3 * H) for g in got)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    x = window_input(src, start, T, torch.float32)
    err = proj_error(got, x, layer)
    fp32 = proj_error([x @ layer[d]["w_ih"] + layer[d]["b_ih"] for d in ("fwd", "bwd")], x,
                      layer)
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        tf32 = proj_error([x @ layer[d]["w_ih"] + layer[d]["b_ih"] for d in ("fwd", "bwd")],
                          x, layer)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    assert err <= 4 * fp32, (err, fp32)
    assert 50 * err <= tf32, (err, tf32)


# ragged rows (M = 91, 153 against 128-row tiles), columns (6H = 3120, 3366
# against 128) and reduction (H = 520, 561 against 32-column chunks); the
# uint8 image at B = 3 (no TMA for its rows) and a float image (cp.async)
@pytest.mark.parametrize("kind,T,B,H", [("pair", 7, 13, 520), ("pair", 9, 17, 561),
                                        ("image", 5, 3, 40), ("dense", 6, 5, 40)])
def test_xp_projection_takes_ragged_shapes(dev, kind, T, B, H):
    from helen_tpu_torch.ops import gru_window_proj as gp
    from helen_tpu_torch.ops.gru_window_bwd import window_input

    rng = np.random.default_rng(T * B + H)
    if kind == "pair":
        src, start, layer = proj_case(rng, kind, T, B, H, dev)
    else:
        image = rng.integers(0, 256, size=(B, T + 9, 90), dtype=np.uint8)
        src = torch.from_numpy(image).to(dev)
        if kind == "dense":
            src = src.float()
        start, layer = 4, make_layer(rng, 90, H, dev, w_ih_scale=1 / 64)
    got = gp.bigru_window_xp_proj(src, start, T, layer)
    x = window_input(src, start, T, torch.float32)
    err = proj_error(got, x, layer)
    fp32 = proj_error([x @ layer[d]["w_ih"] + layer[d]["b_ih"] for d in ("fwd", "bwd")], x,
                      layer)
    assert err <= 4 * fp32, (err, fp32)


@pytest.mark.parametrize("pair,D,H", [(False, 90, 1024), (True, 2048, 1024), (True, 1040, 520),
                                      (False, 37, 40)])
def test_xp_projection_split_kernel_equals_plain(dev, pair, D, H):
    from helen_tpu_torch.ops import gru_window_proj as gp

    layer = make_layer(np.random.default_rng(D + H), D, H, dev)
    before = gp.launch_counts["bigru_window_xp_proj_split"]
    got = gp.split_weights(layer, pair, dev)
    assert torch.equal(got, gp.split_weights_plain(layer, pair))
    assert gp.split_weights(layer, pair, dev) is got  # cached
    layer["bwd"]["w_ih"].add_(1.0)  # an in-place update splits again, into the same buffer
    again = gp.split_weights(layer, pair, dev)
    assert again.data_ptr() == got.data_ptr()
    assert torch.equal(again, gp.split_weights_plain(layer, pair))
    assert gp.launch_counts["bigru_window_xp_proj_split"] == before + 2


def test_xp_route_projects_once_per_layer_window(dev):
    """One h1024 consensus batch launches the projection 19 windows x 2
    layers = 38 times (and splits each layer's weights once); the
    in-projection route launches it never."""
    import dataclasses

    from helen_tpu_torch.config import MODEL, WINDOW
    from helen_tpu_torch.io.checkpoint import params_to_torch
    from helen_tpu_torch.models.transducer import consensus_labels, init_params
    from helen_tpu_torch.ops import gru_window_proj as gp

    rng = np.random.default_rng(38)
    images = torch.from_numpy(rng.integers(0, 40, size=(8, 1000, 90), dtype=np.uint8)).to(dev)
    n_win = WINDOW.num_windows(1000)
    for H, want in ((1024, {"bigru_window_xp_proj": 2 * n_win,
                            "bigru_window_xp_proj_split": 2}),
                    (128, {"bigru_window_xp_proj": 0, "bigru_window_xp_proj_split": 0})):
        params = params_to_torch(init_params(torch.Generator().manual_seed(H),
                                             dataclasses.replace(MODEL, hidden_size=H)), dev)
        gp.reset_launch_counts()
        with torch.no_grad():
            consensus_labels(params, images, backend="cuda")
        torch.cuda.synchronize()
        assert gp.launch_counts == want, H
    assert 2 * n_win == 38


def test_xp_projection_wrapper_refuses_what_the_kernel_does_not_take(dev):
    from helen_tpu_torch.ops import gru_window_proj as gp

    src, start, layer = proj_case(np.random.default_rng(9), "pair", 4, 8, 640, dev)
    with pytest.raises(TypeError):  # float64 on the card
        gp.bigru_window_xp_proj(src, start, 4, layer, torch.float64)
    with pytest.raises(ValueError):  # the halves' shapes differ
        gp.bigru_window_xp_proj((src[0], src[1][:-1]), start, 4, layer)
    with pytest.raises(ValueError):  # a half on the CPU
        gp.bigru_window_xp_proj((src[0], src[1].cpu()), start, 4, layer)
    with pytest.raises(ValueError):  # a non-contiguous half
        gp.bigru_window_xp_proj((src[0], src[1].transpose(0, 1).contiguous().transpose(0, 1)),
                                start, 4, layer)
    image, _, il = proj_case(np.random.default_rng(10), "image", 4, 8, 640, dev)
    with pytest.raises(ValueError):  # a window past the image's end
        gp.bigru_window_xp_proj(image, 998, 4, il)
    with pytest.raises(ValueError):  # an int32 image
        gp.bigru_window_xp_proj(image.int(), 0, 4, il)


# ---------------------------------------------------------------------------
# the fast tier: K1f, K2f (H <= 512) and K3f (the wide models)
# ---------------------------------------------------------------------------

def fast(layer):
    from helen_tpu_torch.io.checkpoint import fast_layer

    return fast_layer(layer)


def ran_fast(kind, H, B):
    """The launches one K1f (``kind`` "in1") or K2f ("in2") adds: its own
    count, and in the two-launch design its projection and recurrence."""
    from helen_tpu_torch.ops import gru_window as gw

    ran = {f"bigru_window_{kind}_fast": 1}
    if gw.window_design(H, B, fast=True) == "smem":
        ran.update({f"bigru_window_proj_{kind}_fast": 1, "bigru_window_rec_fast": 1})
    return ran


# the flagship (the two-launch design), an off-grid H the two-launch design
# pads (H=160), and the one-launch kernel (H=512)
@pytest.mark.parametrize("T,B,H", [(100, 512, 128), (7, 13, 160), (5, 3, 512)])
def test_k1f_kernel_matches_plain(dev, T, B, H):
    from helen_tpu_torch.ops import gru_window as gw

    rng = np.random.default_rng(T * B + H + 2)
    L, start = T + 30, 17
    image = torch.from_numpy(rng.integers(0, 256, size=(B, L, 90), dtype=np.uint8)).to(dev)
    h0f, h0b = (torch.from_numpy(rng.uniform(-1, 1, (B, H)).astype(np.float32)).to(dev)
                for _ in range(2))
    layer = fast(make_layer(rng, 90, H, dev, w_ih_scale=1 / 64))
    before = dict(gw.launch_counts)
    got = gw.bigru_window_in1_fast(image, start, T, h0f, h0b, layer)
    torch.cuda.synchronize()
    assert gw.launch_counts == {k: v + ran_fast("in1", H, B).get(k, 0)
                                for k, v in before.items()}
    assert_outputs_close(got, gw.bigru_window_in1_fast_plain(image, start, T, h0f, h0b,
                                                             layer), FAST_TOL)


@pytest.mark.parametrize("T,B,H", [(100, 512, 128), (7, 13, 160), (5, 3, 512)])
def test_k2f_kernel_matches_plain(dev, T, B, H):
    from helen_tpu_torch.ops import gru_window as gw

    rng = np.random.default_rng(T * B + H + 3)
    xa, xb = (torch.from_numpy(rng.standard_normal((T, B, H)).astype(np.float32)).to(dev)
              for _ in range(2))
    h0f, h0b = (torch.from_numpy(rng.uniform(-1, 1, (B, H)).astype(np.float32)).to(dev)
                for _ in range(2))
    layer = fast(make_layer(rng, 2 * H, H, dev))
    before = dict(gw.launch_counts)
    got = gw.bigru_window_in2_fast(xa, xb, h0f, h0b, layer)
    torch.cuda.synchronize()
    assert gw.launch_counts == {k: v + ran_fast("in2", H, B).get(k, 0)
                                for k, v in before.items()}
    assert_outputs_close(got, gw.bigru_window_in2_fast_plain(xa, xb, h0f, h0b, layer),
                         FAST_TOL)


@pytest.mark.parametrize("T,B,H", [(100, 64, 1024), (7, 13, 640), (9, 17, 1000),
                                   (4, 1, 1024), (5, 3, 160)])
def test_k3f_kernel_matches_plain(dev, T, B, H):
    from helen_tpu_torch.ops import gru_window_xp as gx

    xp_f, xp_b, h0f, h0b, layer = xp_case(np.random.default_rng(T * B + H + 4), T, B, H,
                                          dev)
    args = (xp_f.to(torch.bfloat16), xp_b.to(torch.bfloat16), h0f, h0b, fast(layer))
    before = dict(gx.launch_counts)
    got = gx.bigru_window_xp_fast(*args)
    torch.cuda.synchronize()
    ran = xp_ran("bigru_window_xp_fast", H, gx.xp_fwd_design(H, B, fast=True), fast=True)
    assert gx.launch_counts == {k: v + (k in ran) for k, v in before.items()}
    assert_outputs_close(got, gx.bigru_window_xp_fast_plain(*args), FAST_TOL)


def test_fast_wrappers_refuse_what_the_kernels_do_not_take(dev):
    from helen_tpu_torch.ops import gru_window as gw
    from helen_tpu_torch.ops import gru_window_xp as gx

    rng = np.random.default_rng(7)
    T, B, H = 4, 8, 128
    l1, l2 = make_layer(rng, 90, H, dev), make_layer(rng, 2 * H, H, dev)
    h0 = torch.zeros(B, H, device=dev)
    image = torch.zeros(B, 10, 90, dtype=torch.uint8, device=dev)
    x = torch.zeros(T, B, H, device=dev)
    with pytest.raises(TypeError):  # float32 weights
        gw.bigru_window_in1_fast(image, 0, T, h0, h0, l1)
    with pytest.raises(TypeError):
        gw.bigru_window_in2_fast(x, x, h0, h0, l2)
    with pytest.raises(ValueError):  # K1f's weights given to K2f
        gw.bigru_window_in2_fast(x, x, h0, h0, fast(l1))
    with pytest.raises(ValueError):  # window past the image's end
        gw.bigru_window_in1_fast(image, 8, T, h0, h0, fast(l1))
    with pytest.raises(ValueError):  # h0 on the CPU
        gw.bigru_window_in1_fast(image, 0, T, h0.cpu(), h0, fast(l1))
    with pytest.raises(ValueError):  # a half on the CPU
        gw.bigru_window_in2_fast(x, x.cpu(), h0, h0, fast(l2))
    with pytest.raises(ValueError):  # a weight on the CPU
        gw.bigru_window_in2_fast(x, x, h0, h0, fast({d: {k: v.cpu() for k, v in p.items()}
                                                     for d, p in l2.items()}))

    xp_f, xp_b, h0f, h0b, layer = xp_case(rng, T, B, 640, dev)
    xb_f, xb_b, fl = xp_f.to(torch.bfloat16), xp_b.to(torch.bfloat16), fast(layer)
    with pytest.raises(TypeError):  # float32 streams
        gx.bigru_window_xp_fast(xp_f, xp_b, h0f, h0b, fl)
    with pytest.raises(TypeError):  # float32 W_hh
        gx.bigru_window_xp_fast(xb_f, xb_b, h0f, h0b, layer)
    with pytest.raises(ValueError):  # the streams' shapes differ
        gx.bigru_window_xp_fast(xb_f, xb_b[:-1], h0f, h0b, fl)
    with pytest.raises(ValueError):  # h0 on the CPU
        gx.bigru_window_xp_fast(xb_f, xb_b, h0f.cpu(), h0b, fl)
    wide = xp_case(rng, 2, 8, 1152, dev)  # past the fast grid: the chain at 8 rows
    gx.bigru_window_xp_fast(wide[0].to(torch.bfloat16), wide[1].to(torch.bfloat16),
                            wide[2], wide[3], fast(wide[4]))
    with pytest.raises(ValueError, match="use --backend torch"):
        gx.xp_fwd_design(14_600, 8, fast=True)


@pytest.mark.parametrize("H,want", [(128, "cuda_fast_inproj"), (640, "cuda_fast_xp")])
def test_fast_consensus_launch_counts(dev, H, want):
    """One fast consensus_labels batch launches exactly the fast kernels of
    its route, once per window and layer, and none of the parity tier's; its
    labels agree with the fast plain route."""
    import dataclasses

    from helen_tpu_torch.config import MODEL, WINDOW
    from helen_tpu_torch.io.checkpoint import params_to_torch
    from helen_tpu_torch.models.transducer import consensus_labels, engaged_kernel, init_params
    from helen_tpu_torch.ops import gru_window as gw
    from helen_tpu_torch.ops import gru_window_bwd as gb
    from helen_tpu_torch.ops import gru_window_xp as gx
    from helen_tpu_torch.ops import gru_window_xp_bwd as gxb

    params = params_to_torch(init_params(torch.Generator().manual_seed(H),
                                         dataclasses.replace(MODEL, hidden_size=H)),
                             dev, fast=True)
    assert engaged_kernel(params, "cuda_fast") == want
    rng = np.random.default_rng(H)
    images = torch.from_numpy(rng.integers(0, 40, size=(24, 1000, 90), dtype=np.uint8)).to(dev)
    mods = (gw, gb, gx, gxb)
    for m in mods:
        m.reset_launch_counts()
    with torch.no_grad():
        kb, kr = consensus_labels(params, images, backend="cuda_fast")
    torch.cuda.synchronize()
    counts = {k: v for m in mods for k, v in m.launch_counts.items()}
    n_win = WINDOW.num_windows(1000)
    expect = {k: 0 for k in counts}
    if want == "cuda_fast_inproj":
        # K1f/K2f in the two-launch design, never bigru_window_kernel<FAST>
        expect.update(bigru_window_in1_fast=n_win, bigru_window_in2_fast=n_win,
                      bigru_window_proj_in1_fast=n_win, bigru_window_proj_in2_fast=n_win,
                      bigru_window_rec_fast=2 * n_win)
    else:
        expect.update(bigru_window_xp_fast=2 * n_win, bigru_window_xp_fast_grid=2 * n_win)
    assert counts == expect
    with torch.no_grad():
        pb, pr = consensus_labels(params, images, backend="torch_fast")
    assert int((kb != pb).sum()) <= 1e-3 * kb.numel()
    assert int((kr != pr).sum()) <= 1e-3 * kr.numel()


# ---------------------------------------------------------------------------
# the fused encoder+decoder window: K5 and K5f
# ---------------------------------------------------------------------------

# the flagship window (the cluster design, 8 rows per cluster), an off-grid
# H (the one-pass kernel: 1 row in parity, 4 in the fast tier), a short
# window at 1 row per cluster with a ragged edge, an H whose two directions
# share a warp in the one-pass kernel, and the widest H a T=100 parity
# one-pass block holds (1 row; 566 threads)
@pytest.mark.parametrize("T,B,H", [(100, 512, 128), (7, 13, 160), (5, 3, 128), (9, 7, 40),
                                   (100, 5, 283)])
@pytest.mark.parametrize("tier", ["parity", "fast"])
def test_k5_kernel_equals_chained_kernels(dev, T, B, H, tier):
    """K5 (K5f), in the design ``encdec_design`` picks, against K1 -> K2
    (K1f -> K2f in the design whose arithmetic K5f's design shares: the
    two-launch one for the cluster design, the one-launch one for the
    one-pass kernel) launched one after the other: bit-identical outputs and
    final states (the same sums in the same order; only the stack boundary
    moves); and against its plain version within the tier's tolerance. One
    call counts K5 (K5f) and its design's kernel once each."""
    from helen_tpu_torch.ops import gru_window as gw
    from helen_tpu_torch.ops import gru_window_encdec as ge

    rng = np.random.default_rng(T * B + H + 5)
    L, start = T + 30, 17
    image = torch.from_numpy(rng.integers(0, 256, size=(B, L, 90), dtype=np.uint8)).to(dev)
    h0f, h0b = (torch.from_numpy(rng.uniform(-1, 1, (B, H)).astype(np.float32)).to(dev)
                for _ in range(2))
    enc = make_layer(rng, 90, H, dev, w_ih_scale=1 / 64)
    dec = make_layer(rng, 2 * H, H, dev)
    name = "transducer_window_encdec"
    in1, in2 = gw.bigru_window_in1, gw.bigru_window_in2
    plain, tol = ge.transducer_window_encdec_plain, TOL
    fast_tier = tier == "fast"
    design = ge.encdec_design(H, B, fast_tier)
    if fast_tier:
        enc, dec, name = fast(enc), fast(dec), name + "_fast"
        in1, in2 = gw.bigru_window_in1_fast, gw.bigru_window_in2_fast
        plain, tol = ge.transducer_window_encdec_fast_plain, FAST_TOL
    kernel = name.replace("encdec", f"encdec_{design}")
    before = dict(gw.launch_counts)
    got = getattr(ge, name)(image, start, T, h0f, h0b, enc, dec)
    torch.cuda.synchronize()
    assert gw.launch_counts == {**before, name: before[name] + 1, kernel: before[kernel] + 1}
    chain_design = ("smem" if design == "cluster" else "chain") if fast_tier else None
    chained = in2(*in1(image, start, T, h0f, h0b, enc, design=chain_design), dec,
                  design=chain_design)
    for g, c, what in zip(got, chained, ("out_f", "out_b", "h_f", "h_b")):
        assert torch.equal(g, c), f"{what}: max |K5 - chained| {float((g - c).abs().max())}"
    assert_outputs_close(got, plain(image, start, T, h0f, h0b, enc, dec), tol)


def test_k5_fit_follows_the_card(dev):
    """The Python fit functions agree with the kernel source's sizes and
    thread limits, the card's opt-in shared memory is Hopper's, and a
    geometry past the fit is refused before any launch."""
    from helen_tpu_torch.ops import gru_window as gw
    from helen_tpu_torch.ops import gru_window_encdec as ge
    from helen_tpu_torch.ops import library

    lib = gw.get_lib()
    for h, bt, d, t, fst in ((128, 2, 90, 100, False), (128, 4, 90, 100, True),
                             (283, 1, 90, 100, False), (40, 4, 90, 9, True)):
        assert lib.transducer_window_encdec_smem(h, bt, d, t, int(fst)) == \
            ge.encdec_smem_bytes(h, bt, d, t, fst)
    for bt in ge.BLOCK_ROWS:
        assert lib.transducer_window_encdec_max_threads(bt) == ge.encdec_max_threads(bt)
    assert library.device_smem_budget() == library.HOPPER_SMEM_OPTIN
    # the cluster design: its sizes (get_lib holds them to the source) and
    # the card holds at least one cluster of each kind
    assert lib.transducer_window_encdec_cluster_smem(128, 8) == \
        ge.cluster_smem_bytes(128, 8, False)
    assert lib.transducer_window_encdec_cluster_fast_smem(128) == \
        ge.cluster_smem_bytes(128, 8, True)
    for fst in (False, True):
        for b in (256, 512):
            assert ge.cluster_active(128, b, fst) >= 1
    rng = np.random.default_rng(11)
    H = 320
    image = torch.zeros((4, 100, 90), dtype=torch.uint8, device=dev)
    h0 = torch.zeros((4, H), device=dev)
    before = dict(gw.launch_counts)
    with pytest.raises(ValueError, match='route="inproj"'):
        ge.transducer_window_encdec(image, 0, 100, h0, h0, make_layer(rng, 90, H, dev),
                                    make_layer(rng, 2 * H, H, dev))
    assert gw.launch_counts == before


def test_k5_wrapper_refuses_what_the_kernel_does_not_take(dev):
    from helen_tpu_torch.ops import gru_window_encdec as ge

    rng = np.random.default_rng(12)
    T, B, H = 4, 8, 128
    enc, dec = make_layer(rng, 90, H, dev), make_layer(rng, 2 * H, H, dev)
    h0 = torch.zeros(B, H, device=dev)
    image = torch.zeros(B, 10, 90, dtype=torch.uint8, device=dev)
    with pytest.raises(ValueError):  # float image
        ge.transducer_window_encdec(image.float(), 0, T, h0, h0, enc, dec)
    with pytest.raises(ValueError):  # window past the image's end
        ge.transducer_window_encdec(image, 8, T, h0, h0, enc, dec)
    with pytest.raises(ValueError):  # h0 on the CPU
        ge.transducer_window_encdec(image, 0, T, h0.cpu(), h0, enc, dec)
    with pytest.raises(ValueError):  # the layers swapped
        ge.transducer_window_encdec(image, 0, T, h0, h0, dec, enc)
    with pytest.raises(TypeError):  # float32 weights to K5f
        ge.transducer_window_encdec_fast(image, 0, T, h0, h0, enc, dec)


@pytest.mark.parametrize("backend", ["cuda", "cuda_fast"])
def test_encdec_route_consensus_launch_counts(dev, backend):
    """One consensus_labels batch through ``route="encdec"`` launches K5
    (K5f) once per window and nothing else, and its labels equal the
    default route's (K1 -> K2 chained) exactly; in the fast tier, whose
    default route sums on the tensor cores in another order than K5f, they
    differ in at most 1 label per 1,000 per head."""
    from helen_tpu_torch.config import MODEL, WINDOW
    from helen_tpu_torch.io.checkpoint import params_to_torch
    from helen_tpu_torch.models.transducer import consensus_labels, init_params
    from helen_tpu_torch.ops import gru_window as gw
    from helen_tpu_torch.ops import gru_window_bwd as gb
    from helen_tpu_torch.ops import gru_window_xp as gx
    from helen_tpu_torch.ops import gru_window_xp_bwd as gxb

    params = params_to_torch(init_params(torch.Generator().manual_seed(5), MODEL), dev,
                             fast=backend == "cuda_fast")
    rng = np.random.default_rng(5)
    images = torch.from_numpy(rng.integers(0, 40, size=(24, 1000, 90), dtype=np.uint8)).to(dev)
    mods = (gw, gb, gx, gxb)
    for m in mods:
        m.reset_launch_counts()
    with torch.no_grad():
        kb, kr = consensus_labels(params, images, backend=backend, route="encdec")
    torch.cuda.synchronize()
    counts = {k: v for m in mods for k, v in m.launch_counts.items()}
    name = "transducer_window_encdec" + ("_fast" if backend == "cuda_fast" else "")
    n = WINDOW.num_windows(1000)
    assert counts == {**{k: 0 for k in counts}, name: n,
                      name.replace("encdec", "encdec_cluster"): n}
    with torch.no_grad():
        db, dr = consensus_labels(params, images, backend=backend)
    if backend == "cuda":
        assert torch.equal(kb, db) and torch.equal(kr, dr)
    else:
        assert int((kb != db).sum()) <= 1e-3 * kb.numel()
        assert int((kr != dr).sum()) <= 1e-3 * kr.numel()


# ---------------------------------------------------------------------------
# the two-launch design of K1/K2: the projection pass plus the recurrence
# with W_hh in shared memory (ops.gru_window_smem)
# ---------------------------------------------------------------------------

def k1_case(rng, T, B, H, dev):
    L, start = T + 30, 17
    image = torch.from_numpy(rng.integers(0, 256, size=(B, L, 90), dtype=np.uint8)).to(dev)
    h0f, h0b = (torch.from_numpy(rng.uniform(-1, 1, (B, H)).astype(np.float32)).to(dev)
                for _ in range(2))
    return (image, start, T, h0f, h0b, make_layer(rng, 90, H, dev, w_ih_scale=1 / 64))


def k2_case(rng, T, B, H, dev):
    xa, xb, h0f, h0b = (torch.from_numpy(rng.uniform(-1, 1, s).astype(np.float32)).to(dev)
                        for s in ((T, B, H), (T, B, H), (B, H), (B, H)))
    return (xa, xb, h0f, h0b, make_layer(rng, 2 * H, H, dev))


# the main path's batch (8 rows per block), the training batch (4 rows), a
# ragged one (8 rows, a part-filled last block); the flagship H and the
# widest at 8 rows
@pytest.mark.parametrize("T,B,H", [(100, 512, 128), (100, 256, 128), (100, 300, 128),
                                   (100, 512, 136), (100, 256, 136), (100, 300, 136)])
@pytest.mark.parametrize("kind", ["in1", "in2"])
def test_smem_design_equals_chain_design(dev, kind, T, B, H):
    """K1/K2 as the projection pass plus the recurrence against
    bigru_window_kernel: max abs diff exactly 0.0 (every sum in the same
    order); each design counted as launched; the default design is the new
    one at these shapes."""
    from helen_tpu_torch.ops import gru_window as gw

    rng = np.random.default_rng(T * B + H + (kind == "in2"))
    case = (k1_case if kind == "in1" else k2_case)(rng, T, B, H, dev)
    fn = getattr(gw, f"bigru_window_{kind}")
    assert gw.window_design(H, B) == "smem"
    plus_one = lambda before, *names: {**before, **{n: before[n] + 1 for n in names}}  # noqa: E731
    before = dict(gw.launch_counts)
    new = fn(*case, design="smem")
    torch.cuda.synchronize()
    assert gw.launch_counts == plus_one(before, f"bigru_window_{kind}",
                                        f"bigru_window_proj_{kind}", "bigru_window_rec_smem")
    before = dict(gw.launch_counts)
    old = fn(*case, design="chain")
    torch.cuda.synchronize()
    assert gw.launch_counts == plus_one(before, f"bigru_window_{kind}")
    for n, o, what in zip(new, old, ("out_f", "out_b", "h_f", "h_b")):
        assert torch.equal(n, o), f"{what}: max |smem - chain| {float((n - o).abs().max())}"
    assert_outputs_close(new, getattr(gw, f"bigru_window_{kind}_plain")(*case))


# ragged batches at 1, 2 and 8 rows per block, an H that is no multiple of
# 4 (scalar tail of the h chain, unaligned 3H columns)
@pytest.mark.parametrize("T,B,H", [(100, 512, 128), (9, 13, 136), (5, 3, 40), (6, 67, 37)])
def test_smem_kernels_match_their_plain_versions(dev, T, B, H):
    """Each new kernel against its plain version on the same inputs: the
    projections against window_proj_plain (sums in k order), the recurrence
    against gru_scan over the kernel's own xp."""
    from helen_tpu_torch.ops import gru_window_smem as gs

    rng = np.random.default_rng(T + B + H)
    image, start, _, h0f, h0b, l1 = k1_case(rng, T, B, H, dev)
    xa, xb, _, _, l2 = k2_case(rng, T, B, H, dev)
    xp1 = gs.bigru_window_proj_in1(image, start, T, l1)
    xp2 = gs.bigru_window_proj_in2(xa, xb, l2)
    torch.cuda.synchronize()
    for got, want in ((xp1, gs.window_proj_plain(gs.image_window(image, start, T), l1)),
                      (xp2, gs.window_proj_plain(torch.cat([xa, xb], -1), l2))):
        assert got.shape == (2, T, B, 3 * H)
        assert float((got - want).abs().max()) <= TOL * max(1.0, float(want.abs().max()))
    for xp, layer in ((xp1, l1), (xp2, l2)):
        got = gs.bigru_window_rec_smem(xp, h0f, h0b, layer)
        assert_outputs_close(got, gs.window_rec_plain(xp, h0f, h0b, layer))


def test_smem_recurrence_takes_an_unaligned_w_hh(dev):
    """A W_hh view 4 bytes past a 16-byte boundary takes the kernel's
    4-byte copies: the same bits as an aligned copy."""
    from helen_tpu_torch.ops import gru_window_smem as gs

    rng = np.random.default_rng(21)
    T, B, H = 20, 16, 128
    xa, xb, h0f, h0b, layer = k2_case(rng, T, B, H, dev)
    xp = gs.bigru_window_proj_in2(xa, xb, layer)
    shifted = {d: dict(p) for d, p in layer.items()}
    for d in ("fwd", "bwd"):
        buf = torch.empty(H * 3 * H + 1, device=dev)
        w = buf[1:].view(H, 3 * H)
        w.copy_(layer[d]["w_hh"])
        shifted[d]["w_hh"] = w
    for a, b in zip(gs.bigru_window_rec_smem(xp, h0f, h0b, layer),
                    gs.bigru_window_rec_smem(xp, h0f, h0b, shifted)):
        assert torch.equal(a, b)


def test_smem_wrappers_refuse_what_the_kernels_do_not_take(dev):
    from helen_tpu_torch.ops import gru_window as gw
    from helen_tpu_torch.ops import gru_window_smem as gs

    rng = np.random.default_rng(22)
    xa, xb, h0f, h0b, layer = k2_case(rng, 4, 8, 160, dev)
    xp = torch.zeros(2, 4, 8, 3 * 160, device=dev)
    before = dict(gw.launch_counts)
    with pytest.raises(ValueError, match="bigru_window_kernel takes it"):
        gs.bigru_window_rec_smem(xp, h0f, h0b, layer)
    with pytest.raises(ValueError, match="does not take H=160"):
        gw.bigru_window_in2(xa, xb, h0f, h0b, layer, design="smem")
    assert gw.launch_counts == before
    xa, xb, h0f, h0b, layer = k2_case(rng, 4, 8, 128, dev)
    with pytest.raises(ValueError):  # xp of another batch
        gs.bigru_window_rec_smem(torch.zeros(2, 4, 9, 384, device=dev), h0f, h0b, layer)
    with pytest.raises(ValueError):  # K1's weights given to K2's projection
        gs.bigru_window_proj_in2(xa, xb, make_layer(rng, 90, 128, dev))
    lib = gw.get_lib()
    for h in (1, 37, 128, 136, 137):
        for rows in gs.BLOCK_ROWS:
            assert lib.bigru_window_rec_smem_bytes(h, rows) == gs.rec_smem_bytes(h, rows)


@pytest.mark.parametrize("design", ["smem", "chain"])
def test_k5_equals_either_design_of_the_chain(dev, design):
    """K5 against K1 -> K2 in each design at the flagship shape: 0.0."""
    from helen_tpu_torch.ops import gru_window as gw
    from helen_tpu_torch.ops import gru_window_encdec as ge

    rng = np.random.default_rng(23)
    image, start, T, h0f, h0b, enc = k1_case(rng, 100, 512, 128, dev)
    dec = make_layer(rng, 256, 128, dev)
    got = ge.transducer_window_encdec(image, start, T, h0f, h0b, enc, dec)
    chained = gw.bigru_window_in2(
        *gw.bigru_window_in1(image, start, T, h0f, h0b, enc, design=design), dec, design=design)
    for g, c in zip(got, chained):
        assert torch.equal(g, c), float((g - c).abs().max())


# ---------------------------------------------------------------------------
# K5/K5f's cluster design (ops.gru_window_encdec, encdec_design "cluster")
# ---------------------------------------------------------------------------

def encdec_case(rng, T, B, H, dev):
    image, start, T, h0f, h0b, enc = k1_case(rng, T, B, H, dev)
    return image, start, T, h0f, h0b, enc, make_layer(rng, 2 * H, H, dev)


# the main path's batch (8 rows per cluster), the training batch (4 rows), a
# ragged one (8 rows, a part-filled last cluster), and small shapes at 1 and
# 2 rows, H off the warp grid
@pytest.mark.parametrize("T,B,H", [(100, 512, 128), (100, 256, 128), (100, 300, 128),
                                   (9, 70, 64), (7, 3, 40), (5, 9, 37)])
def test_k5_cluster_equals_onepass_and_chain(dev, T, B, H):
    """Parity: K5 in the cluster design against the one-pass kernel and
    against K1 -> K2 in the main path's design: 0.0 (one fmaf chain per
    projection output in k order, the chain's own recurrence step); the
    cluster kernel's wrapper alone gives the same and counts only itself;
    within TOL of the cluster's plain version."""
    from helen_tpu_torch.ops import gru_window as gw
    from helen_tpu_torch.ops import gru_window_encdec as ge

    rng = np.random.default_rng(T + B + H)
    case = encdec_case(rng, T, B, H, dev)
    assert ge.encdec_design(H, B) == "cluster"
    got = ge.transducer_window_encdec(*case)
    onepass = ge.transducer_window_encdec(*case, design="onepass")
    image, start, T, h0f, h0b, enc, dec = case
    chained = gw.bigru_window_in2(*gw.bigru_window_in1(image, start, T, h0f, h0b, enc), dec)
    before = dict(gw.launch_counts)
    alone = ge.transducer_window_encdec_cluster(*case)
    assert gw.launch_counts == {**before, "transducer_window_encdec_cluster":
                                before["transducer_window_encdec_cluster"] + 1}
    for g, o, c, a in zip(got, onepass, chained, alone):
        assert torch.equal(g, o), float((g - o).abs().max())
        assert torch.equal(g, c), float((g - c).abs().max())
        assert torch.equal(g, a)
    assert_outputs_close(got, ge.transducer_window_encdec_cluster_plain(*case))


@pytest.mark.parametrize("T,B,H", [(100, 512, 128), (100, 256, 128), (100, 300, 128),
                                   (9, 70, 64), (7, 3, 40), (5, 9, 37)])
def test_k5f_cluster_equals_the_two_launch_chain(dev, T, B, H):
    """Fast: K5f in the cluster design against K1f -> K2f in the main
    path's two-launch design: 0.0 (its producer sums each output over the
    k16 tiles in order in one accumulator, + b_ih after, as the projection
    pass; its consumer steps through the recurrence's own pieces); within
    FAST_TOL of its plain version and of the one-pass kernel (the one-launch
    chain's order of sums)."""
    from helen_tpu_torch.ops import gru_window as gw
    from helen_tpu_torch.ops import gru_window_encdec as ge

    rng = np.random.default_rng(T + B + H + 1)
    image, start, T, h0f, h0b, enc, dec = encdec_case(rng, T, B, H, dev)
    enc, dec = fast(enc), fast(dec)
    case = (image, start, T, h0f, h0b, enc, dec)
    assert ge.encdec_design(H, B, fast=True) == "cluster"
    got = ge.transducer_window_encdec_fast(*case)
    chained = gw.bigru_window_in2_fast(
        *gw.bigru_window_in1_fast(image, start, T, h0f, h0b, enc, design="smem"), dec,
        design="smem")
    for g, c, what in zip(got, chained, ("out_f", "out_b", "h_f", "h_b")):
        assert torch.equal(g, c), f"{what}: max |K5f - chain| {float((g - c).abs().max())}"
    assert_outputs_close(got, ge.transducer_window_encdec_cluster_fast_plain(*case), FAST_TOL)
    assert_outputs_close(got, ge.transducer_window_encdec_fast(*case, design="onepass"),
                         FAST_TOL)


def test_k5_cluster_is_bit_identical_across_launches(dev):
    from helen_tpu_torch.ops import gru_window_encdec as ge

    rng = np.random.default_rng(31)
    image, start, T, h0f, h0b, enc, dec = encdec_case(rng, 100, 300, 128, dev)
    for kernel, layers in ((ge.transducer_window_encdec_cluster, (enc, dec)),
                           (ge.transducer_window_encdec_cluster_fast, (fast(enc), fast(dec)))):
        a = kernel(image, start, T, h0f, h0b, *layers)
        b = kernel(image, start, T, h0f, h0b, *layers)
        assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_k5_cluster_refuses_what_it_does_not_take(dev):
    """A forced cluster design where the rule does not hold (parity H=160,
    the golden h160 fixture's width; fast H=144) raises before any launch;
    the cluster wrapper checks its arguments as K5's does."""
    from helen_tpu_torch.ops import gru_window as gw
    from helen_tpu_torch.ops import gru_window_encdec as ge

    rng = np.random.default_rng(32)
    before = dict(gw.launch_counts)
    for H, tier in ((160, False), (144, True)):
        image, start, T, h0f, h0b, enc, dec = encdec_case(rng, 5, 16, H, dev)
        if tier:
            enc, dec = fast(enc), fast(dec)
        kernel = ge.transducer_window_encdec_fast if tier else ge.transducer_window_encdec
        alone = (ge.transducer_window_encdec_cluster_fast if tier
                 else ge.transducer_window_encdec_cluster)
        with pytest.raises(ValueError, match="does not take"):
            kernel(image, start, T, h0f, h0b, enc, dec, design="cluster")
        with pytest.raises(ValueError, match="does not take"):
            alone(image, start, T, h0f, h0b, enc, dec)
    assert gw.launch_counts == before
    image, start, T, h0f, h0b, enc, dec = encdec_case(rng, 5, 16, 128, dev)
    with pytest.raises(ValueError):  # float image
        ge.transducer_window_encdec_cluster(image.float(), start, T, h0f, h0b, enc, dec)
    with pytest.raises(ValueError):  # the layers swapped
        ge.transducer_window_encdec_cluster(image, start, T, h0f, h0b, dec, enc)
    with pytest.raises(TypeError):  # float32 weights to K5f's cluster kernel
        ge.transducer_window_encdec_cluster_fast(image, start, T, h0f, h0b, enc, dec)
    assert gw.launch_counts == before


def test_tbptt_batch_smem_design_equals_chain_design(dev, monkeypatch):
    """One TBPTT batch (19 windows: forward, backward, Adam) with K1/K2 in
    the two-launch design, then with every K1/K2 forced to bigru_window_kernel:
    the same loss sums, params and Adam moments, bit for bit."""
    from helen_tpu_torch.config import MODEL
    from helen_tpu_torch.io.checkpoint import opt_leaves, params_to_torch
    from helen_tpu_torch.models.transducer import init_params, param_leaves
    from helen_tpu_torch.ops import gru_window as gw
    from helen_tpu_torch.train.train_loop import Adam, tbptt_step

    rng = np.random.default_rng(24)
    B = 32
    images = torch.from_numpy(rng.integers(0, 40, (B, 1000, 90), dtype=np.uint8)).to(dev)
    yb = torch.from_numpy(rng.integers(0, 5, (B, 1000))).to(dev)
    yr = torch.from_numpy(rng.integers(0, 11, (B, 1000))).to(dev)
    params0 = init_params(torch.Generator().manual_seed(7), MODEL)
    runs = {}
    for design in ("smem", "chain"):
        if design == "chain":
            monkeypatch.setattr(gw, "window_design", lambda *a, **k: "chain")
        p = params_to_torch(params0, dev)
        for t in param_leaves(p):
            t.requires_grad_(True)
        adam = Adam(0.0)
        state = adam.init(p)
        gw.reset_launch_counts()
        tot = tbptt_step(p, adam, state, 1e-4, images, yb, yr, B, "cuda")
        torch.cuda.synchronize()
        assert (gw.launch_counts["bigru_window_rec_smem"] > 0) == (design == "smem")
        assert gw.launch_counts["bigru_window_in1"] == 19
        runs[design] = ([t.detach().clone() for t in tot]
                        + [t.detach() for t in param_leaves(p)]
                        + [torch.as_tensor(v) for v in opt_leaves(state)[1:]])
    for a, b in zip(runs["smem"], runs["chain"]):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# the backward's pass 1 as the gate pass, the recurrence with W_hh^T in
# shared memory and the dx pass (ops.gru_window_bwd_smem)
# ---------------------------------------------------------------------------

def flat_rec(res):
    dxp, dhpn, dx, dh0f, dh0b = res
    return [("dxp", dxp), ("dhp_n", dhpn), ("dh0_f", dh0f), ("dh0_b", dh0b)] + (
        [("dx", dx)] if dx is not None else [])


def flat_grads(res):
    dx, dh0f, dh0b, g = res
    return [("dh0_f", dh0f), ("dh0_b", dh0b)] + ([("dx", dx)] if dx is not None else []) + [
        (f"{d}.{k}", g[d][k]) for d in ("fwd", "bwd") for k in ("w_ih", "w_hh", "b_ih", "b_hh")]


# the training batch (4 rows per block), the main path's batch (8 rows), a
# ragged one (8 rows, a part-filled last block); the flagship H and the
# widest that fits at those rows
@pytest.mark.parametrize("T,B,H", [(100, 256, 128), (100, 512, 128), (100, 300, 128),
                                   (100, 256, 135), (100, 512, 131), (100, 300, 131)])
@pytest.mark.parametrize("kind", ["image", "pair"])
def test_bwd_smem_design_equals_chain_design(dev, kind, T, B, H):
    """Pass 1 as the gate pass, the recurrence and the dx pass against
    bwd_rec_kernel: dxp, dhp_n, dx, dh0 and (through pass 2) every dW/db
    exactly equal; each design counted as launched; the default design is
    the new one at these shapes; pass 1 against its plain version."""
    from helen_tpu_torch.ops import gru_window as gw
    from helen_tpu_torch.ops import gru_window_bwd as gb

    args = bwd_case(np.random.default_rng(T * B + H + (kind == "pair")), kind, T, B, H, dev)
    assert gb.bwd_design(H, B) == "smem"
    proj = "bigru_window_proj_in1" if kind == "image" else "bigru_window_proj_in2"
    before, before_gw = dict(gb.launch_counts), dict(gw.launch_counts)
    new = gb.bigru_window_bwd_rec(*args, design="smem")
    torch.cuda.synchronize()
    ran = ["bigru_window_bwd_rec", "bigru_window_bwd_hp", "bigru_window_bwd_rec_smem"] + (
        ["bigru_window_bwd_dx"] if kind == "pair" else [])
    assert gb.launch_counts == {k: v + (k in ran) for k, v in before.items()}
    assert gw.launch_counts == {k: v + (k == proj) for k, v in before_gw.items()}
    before = dict(gb.launch_counts)
    old = gb.bigru_window_bwd_rec(*args, design="chain")
    torch.cuda.synchronize()
    ran = ["bigru_window_bwd_rec", "bigru_window_bwd_rec_chain"]
    assert gb.launch_counts == {k: v + (k in ran) for k, v in before.items()}
    assert (new[2] is None) == (kind == "image")
    for (what, n), (_, o) in zip(flat_rec(new), flat_rec(old)):
        assert torch.equal(n, o), f"{what}: max |smem - chain| {float((n - o).abs().max())}"
    full = [gb.bigru_window_bwd(*args, design=d) for d in ("smem", "chain")]
    for (what, n), (_, o) in zip(flat_grads(full[0]), flat_grads(full[1])):
        assert torch.equal(n, o), f"{what}: max |smem - chain| {float((n - o).abs().max())}"
    want = gb.bigru_window_bwd_rec_plain(*args, need_dx=kind == "pair")
    for (what, n), (_, w) in zip(flat_rec(new), flat_rec(want)):
        _scaled_close(n, w, what)


def test_bwd_smem_is_bit_identical_across_launches(dev):
    from helen_tpu_torch.ops import gru_window_bwd as gb

    args = bwd_case(np.random.default_rng(25), "pair", 100, 256, 128, dev)
    assert gb.bwd_design(128, 256) == "smem"
    a, b = gb.bigru_window_bwd(*args), gb.bigru_window_bwd(*args)
    for (what, x), (_, y) in zip(flat_grads(a), flat_grads(b)):
        assert torch.equal(x, y), what


# 4 rows per block at B=256, ragged batches at 8, 2 and 1 rows; an H that
# is no multiple of 4 (scalar tails of the carry chain and of the tile
# product's stores)
@pytest.mark.parametrize("T,B,H", [(100, 256, 128), (9, 300, 128), (5, 67, 40),
                                   (6, 13, 37)])
def test_bwd_smem_kernels_match_their_plain_versions(dev, T, B, H):
    """Each new kernel against its plain version on the same inputs: hp
    against h_prev @ W_hh, the recurrence against unwind_gates over the
    kernel's own xp and hp, dx against dxp @ W_ih^T."""
    from helen_tpu_torch.ops import gru_window_bwd_smem as gbs
    from helen_tpu_torch.ops import gru_window_smem as gs

    src, start, h0f, h0b, of, ob, dof, dob, dhf, dhb, layer = bwd_case(
        np.random.default_rng(T + B + H), "pair", T, B, H, dev)
    xp = gs.bigru_window_proj_in2(*src, layer)
    hp = gbs.bigru_window_bwd_hp(h0f, h0b, of, ob, layer)
    torch.cuda.synchronize()
    _scaled_close(hp, gbs.bwd_hp_plain(h0f, h0b, of, ob, layer), "hp")
    rest = (h0f, h0b, of, ob, dof, dob, dhf, dhb, layer)
    got = gbs.bigru_window_bwd_rec_smem(xp, hp, *rest)
    want = gbs.bwd_rec_smem_plain(xp, hp, *rest)
    for g, w, what in zip(got, want, ("dxp", "dhp_n", "dh0_f", "dh0_b")):
        _scaled_close(g, w, what)
    dx = gbs.bigru_window_bwd_dx(got[0], layer)
    assert dx.shape == (2, T, B, 2 * H)
    _scaled_close(dx, gbs.bwd_dx_plain(got[0], layer), "dx")


def test_bwd_smem_wrappers_refuse_what_the_kernels_do_not_take(dev):
    from helen_tpu_torch.ops import gru_window_bwd as gb
    from helen_tpu_torch.ops import gru_window_bwd_smem as gbs
    from helen_tpu_torch.ops import library

    args = bwd_case(np.random.default_rng(26), "pair", 4, 8, 160, dev)
    src, start, h0f, h0b, of, ob, dof, dob, dhf, dhb, layer = args
    assert gb.bwd_design(160, 8) == "chain"
    xp = torch.zeros(2, 4, 8, 3 * 160, device=dev)
    before = dict(gb.launch_counts)
    with pytest.raises(ValueError, match="bwd_rec_kernel takes it"):
        gbs.bigru_window_bwd_rec_smem(xp, xp, h0f, h0b, of, ob, dof, dob, dhf, dhb, layer)
    with pytest.raises(ValueError, match="does not take H=160"):
        gb.bigru_window_bwd(*args, design="smem")
    assert gb.launch_counts == before
    src, start, h0f, h0b, of, ob, dof, dob, dhf, dhb, layer = bwd_case(
        np.random.default_rng(27), "pair", 4, 8, 128, dev)
    with pytest.raises(ValueError):  # hp of another batch
        gbs.bigru_window_bwd_rec_smem(torch.zeros(2, 4, 8, 384, device=dev),
                                      torch.zeros(2, 4, 9, 384, device=dev),
                                      h0f, h0b, of, ob, dof, dob, dhf, dhb, layer)
    with pytest.raises(ValueError):  # dxp of another width
        gbs.bigru_window_bwd_dx(torch.zeros(2, 4, 8, 390, device=dev), layer)
    lib = library.get_lib()
    for h in (1, 37, 128, 131, 135, 136):
        for rows in (1, 2, 4, 8):
            assert lib.bigru_window_bwd_rec_smem_bytes(h, rows) == gbs.bwd_rec_smem_bytes(h, rows)


def test_tbptt_batch_bwd_smem_design_equals_chain_design(dev, monkeypatch):
    """One TBPTT batch (19 windows: forward, backward, Adam) with pass 1 in
    the new design, then with every pass 1 forced to bwd_rec_kernel: the
    same loss sums, params and Adam moments, bit for bit."""
    from helen_tpu_torch.config import MODEL
    from helen_tpu_torch.io.checkpoint import opt_leaves, params_to_torch
    from helen_tpu_torch.models.transducer import init_params, param_leaves
    from helen_tpu_torch.ops import gru_window_bwd as gb
    from helen_tpu_torch.train.train_loop import Adam, tbptt_step

    rng = np.random.default_rng(28)
    B = 32
    images = torch.from_numpy(rng.integers(0, 40, (B, 1000, 90), dtype=np.uint8)).to(dev)
    yb = torch.from_numpy(rng.integers(0, 5, (B, 1000))).to(dev)
    yr = torch.from_numpy(rng.integers(0, 11, (B, 1000))).to(dev)
    params0 = init_params(torch.Generator().manual_seed(7), MODEL)
    runs = {}
    for design in ("smem", "chain"):
        if design == "chain":
            monkeypatch.setattr(gb, "bwd_design", lambda *a, **k: "chain")
        p = params_to_torch(params0, dev)
        for t in param_leaves(p):
            t.requires_grad_(True)
        adam = Adam(0.0)
        state = adam.init(p)
        gb.reset_launch_counts()
        tot = tbptt_step(p, adam, state, 1e-4, images, yb, yr, B, "cuda")
        torch.cuda.synchronize()
        smem = design == "smem"
        assert gb.launch_counts["bigru_window_bwd_rec"] == 2 * 19
        assert gb.launch_counts["bigru_window_bwd_rec_smem"] == (2 * 19 if smem else 0)
        assert gb.launch_counts["bigru_window_bwd_dx"] == (19 if smem else 0)
        assert gb.launch_counts["bigru_window_bwd_rec_chain"] == (0 if smem else 2 * 19)
        runs[design] = ([t.detach().clone() for t in tot]
                        + [t.detach() for t in param_leaves(p)]
                        + [torch.as_tensor(v) for v in opt_leaves(state)[1:]])
    for a, b in zip(runs["smem"], runs["chain"]):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# K4's pass 1 as the gate pass and the grid-wide recurrence with W_hh spread
# over the SMs' shared memory (ops.gru_window_xp_bwd_grid)
# ---------------------------------------------------------------------------

def flat_xp(res):
    return [("dxp_f", res[0]), ("dxp_b", res[1]), ("dh0_f", res[2]), ("dh0_b", res[3])] + [
        (f"{d}.{k}", res[4][d][k]) for d in ("fwd", "bwd") for k in ("w_hh", "b_hh")]


# the wide training shape, a shorter window at a batch of 24, H=640 and 768
# (10 and 12 units per block) at ragged batches, one of them past a block's
# 64-row block, the forced route's H=128 (2 units per block), and an H that
# is no multiple of 4 (dhp rows not 16-byte aligned: loaded a float at a
# time); then the edges of the thread tile: one row (B=1), a ragged row
# block past 64 rows (65 = 64 + 1; 129 = 128 + 1, with U=11 and a last block
# of 7 units: 700 = 63 x 11 + 7), 1020 = 63 x 16 + 12 at 200 rows, and a
# last block of 8 units at an H that is no multiple of 16 (1000 = 62 x 16 + 8)
@pytest.mark.parametrize("T,B,H", [(100, 64, 1024), (40, 24, 1024), (7, 13, 640),
                                   (5, 300, 768), (6, 8, 128), (4, 7, 610),
                                   (3, 1, 1024), (4, 65, 1024), (3, 129, 700),
                                   (3, 200, 1020), (5, 13, 1000)])
def test_xp_bwd_grid_design_equals_chain_design(dev, T, B, H):
    """Pass 1 as the gate pass and the grid recurrence against
    xp_bwd_rec_kernel: dxp, dhp_n, dh0 and (through pass 2) dW_hh, db_hh
    exactly equal; each design counted as launched, the grid under its
    tile; pass 1 against its plain version."""
    from helen_tpu_torch.ops import gru_window_xp_bwd as gxb
    from helen_tpu_torch.ops import gru_window_xp_bwd_grid as gg

    args = xp_bwd_case(np.random.default_rng(T * B + H + 9), T, B, H, dev)
    assert gxb.xp_bwd_design(H, B) == "grid"
    before = dict(gxb.launch_counts)
    new = gxb.bigru_window_xp_bwd_rec(*args, design="grid")
    torch.cuda.synchronize()
    ran = ("bigru_window_xp_bwd_rec", "bigru_window_xp_bwd_hp", "bigru_window_xp_bwd_rec_grid",
           f"bigru_window_xp_bwd_rec_grid_r{gg.grid_tile(B)}")
    assert gxb.launch_counts == {k: v + (k in ran) for k, v in before.items()}
    before = dict(gxb.launch_counts)
    old = gxb.bigru_window_xp_bwd_rec(*args, design="chain")
    torch.cuda.synchronize()
    ran = ("bigru_window_xp_bwd_rec", "bigru_window_xp_bwd_rec_chain",
           f"bigru_window_xp_bwd_rec_chain_r{gxb.bwd_chain_rows(H, smem_budget())}")
    assert gxb.launch_counts == {k: v + (k in ran) for k, v in before.items()}
    for what, n, o in zip(("dxp", "dhp_n", "dh0_f", "dh0_b"), new, old):
        assert torch.equal(n, o), f"{what}: max |grid - chain| {float((n - o).abs().max())}"
    full = [gxb.bigru_window_xp_bwd(*args, design=d) for d in ("grid", "chain")]
    for (what, n), (_, o) in zip(flat_xp(full[0]), flat_xp(full[1])):
        assert torch.equal(n, o), f"{what}: max |grid - chain| {float((n - o).abs().max())}"
    want = gxb.bigru_window_xp_bwd_rec_plain(*args)
    for what, n, w in zip(("dxp", "dhp_n", "dh0_f", "dh0_b"), new, want):
        _scaled_close(n, w, what)


def test_xp_bwd_grid_is_bit_identical_across_launches(dev):
    from helen_tpu_torch.ops import gru_window_xp_bwd as gxb

    args = xp_bwd_case(np.random.default_rng(29), 100, 64, 1024, dev)
    a, b = (gxb.bigru_window_xp_bwd(*args, design="grid") for _ in range(2))
    for (what, x), (_, y) in zip(flat_xp(a), flat_xp(b)):
        assert torch.equal(x, y), what


def test_xp_bwd_grid_kernel_matches_its_plain_version(dev):
    """The recurrence alone against unwind_gates over the gate pass's own hp."""
    from helen_tpu_torch.ops import gru_window_bwd_smem as gbs
    from helen_tpu_torch.ops import gru_window_xp_bwd as gxb
    from helen_tpu_torch.ops import gru_window_xp_bwd_grid as gg

    xp_f, xp_b, h0f, h0b, of, ob, dof, dob, dhf, dhb, layer = xp_bwd_case(
        np.random.default_rng(30), 9, 70, 1024, dev)
    hp = gbs.bigru_window_bwd_hp(h0f, h0b, of, ob, layer)
    rest = (h0f, h0b, of, ob, dof, dob, dhf, dhb, layer)
    got = gxb.bigru_window_xp_bwd_rec_grid(xp_f, xp_b, hp, *rest)
    want = gg.xp_bwd_rec_grid_plain(xp_f, xp_b, hp, *rest)
    for g, w, what in zip(got, want, ("dxp", "dhp_n", "dh0_f", "dh0_b")):
        _scaled_close(g, w, what)


def test_xp_bwd_grid_refuses_what_the_card_does_not_hold(dev, monkeypatch):
    """A forced "grid" on a card whose SMs do not hold W_hh raises before any
    launch; a grid of more blocks than the card holds at once is refused by
    the cooperative launch, and the wrapper raises: nothing falls back."""
    from helen_tpu_torch.ops import gru_window_bwd_smem as gbs
    from helen_tpu_torch.ops import gru_window_xp_bwd as gxb
    from helen_tpu_torch.ops import gru_window_xp_bwd_grid as gg
    from helen_tpu_torch.ops import library

    args = xp_bwd_case(np.random.default_rng(31), 4, 8, 1024, dev)
    xp_f, xp_b, h0f, h0b, of, ob, dof, dob, dhf, dhb, layer = args
    sms, budget = library.card_limits()
    before = dict(gxb.launch_counts)
    monkeypatch.setattr(library, "_card", {torch.cuda.current_device(): (114, budget)})
    assert gxb.xp_bwd_design(1024, 8) == "chain"
    with pytest.raises(ValueError, match="does not take H=1024"):
        gxb.bigru_window_xp_bwd(*args, design="grid")
    with pytest.raises(ValueError, match="does not take H=1024"):
        gxb.bigru_window_xp_bwd_rec_grid(xp_f, xp_b, torch.zeros(2, 4, 8, 3072, device=dev),
                                         h0f, h0b, of, ob, dof, dob, dhf, dhb, layer)
    assert gxb.launch_counts == before
    monkeypatch.setattr(library, "_card", {torch.cuda.current_device(): (sms, budget)})
    hp = gbs.bigru_window_bwd_hp(h0f, h0b, of, ob, layer)
    with pytest.raises(RuntimeError, match="bigru_window_xp_bwd_rec_grid launch failed"):
        gg.launch_rec_grid(xp_f, xp_b, hp, h0f, h0b, of, ob, dof, dob, dhf, dhb, layer,
                           gg.grid_units(1024, sms, budget) - 1, gxb.launch_counts, dev)
    assert gxb.launch_counts == before
    lib = library.get_lib()
    for h in (128, 160, 640, 768, 1000, 1024):
        for u in (2, 3, 10, 12, 16):
            assert lib.bigru_window_xp_bwd_grid_smem_bytes(h, u) == gg.grid_smem_bytes(h, u)


def test_xp_bwd_grid_refuses_a_tile_it_does_not_have(dev):
    """The kernel's entry takes 4 or 2 rows a thread (GRID_TILES); any other
    is refused before a launch (cudaErrorInvalidValue) and the outputs are
    left as they were; each tile it has gives the chain design's bits."""
    from helen_tpu_torch.ops import gru_window_bwd_smem as gbs
    from helen_tpu_torch.ops import gru_window_xp_bwd as gxb
    from helen_tpu_torch.ops import gru_window_xp_bwd_grid as gg
    from helen_tpu_torch.ops import library

    T, B, H = 4, 64, 1024
    xp_f, xp_b, h0f, h0b, of, ob, dof, dob, dhf, dhb, layer = xp_bwd_case(
        np.random.default_rng(33), T, B, H, dev)
    hp = gbs.bigru_window_bwd_hp(h0f, h0b, of, ob, layer)
    units = gg.grid_units(H, *library.card_limits())
    w = [layer[d][k] for d in ("fwd", "bwd") for k in ("w_hh", "b_hh")]
    want = gxb.bigru_window_xp_bwd_rec(xp_f, xp_b, h0f, h0b, of, ob, dof, dob, dhf, dhb,
                                       layer, design="chain")
    assert set(gg.GRID_TILES) == {2, 4}
    for rpt in (0, 1, 2, 3, 4, 5, 8, 16):
        outs = [torch.full(s, 7.0, device=dev)
                for s in ((2, T, B, 3 * H), (2, T, B, H), (B, H), (B, H))]
        arrive = torch.zeros(library.GRID_COUNTERS, dtype=torch.int32, device=dev)
        err = library.get_lib().bigru_window_xp_bwd_rec_grid(
            *(t.data_ptr() for t in (xp_f, xp_b, hp, h0f, h0b, of, ob, dof, dob, dhf, dhb, *w,
                                     *outs, arrive)),
            T, B, H, units, rpt, torch.cuda.current_stream().cuda_stream)
        torch.cuda.synchronize()
        if rpt in gg.GRID_TILES:
            assert err == 0, rpt
            for what, g, x in zip(("dxp", "dhp_n", "dh0_f", "dh0_b"), outs, want):
                assert torch.equal(g, x), (rpt, what)
        else:
            assert err == 1, rpt  # cudaErrorInvalidValue
            assert all(bool((o == 7.0).all()) for o in outs), rpt


def test_tbptt_batch_xp_bwd_grid_design_equals_chain_design(dev, monkeypatch):
    """One TBPTT batch at H=640 on the xp route (19 windows: forward,
    backward, Adam) with pass 1 in the grid design, then with every pass 1
    forced to xp_bwd_rec_kernel: the same loss sums, params and Adam
    moments, bit for bit."""
    import dataclasses

    from helen_tpu_torch.config import MODEL
    from helen_tpu_torch.io.checkpoint import opt_leaves, params_to_torch
    from helen_tpu_torch.models.transducer import init_params, param_leaves
    from helen_tpu_torch.ops import gru_window_xp_bwd as gxb
    from helen_tpu_torch.ops import gru_window_xp_bwd_grid as gg
    from helen_tpu_torch.train.train_loop import Adam, tbptt_step

    rng = np.random.default_rng(32)
    B = 8
    tile = f"bigru_window_xp_bwd_rec_grid_r{gg.grid_tile(B)}"
    assert gg.grid_tile(B) == gg.grid_tile(64)  # the wide train's tile
    images = torch.from_numpy(rng.integers(0, 40, (B, 1000, 90), dtype=np.uint8)).to(dev)
    yb = torch.from_numpy(rng.integers(0, 5, (B, 1000))).to(dev)
    yr = torch.from_numpy(rng.integers(0, 11, (B, 1000))).to(dev)
    params0 = init_params(torch.Generator().manual_seed(8),
                          dataclasses.replace(MODEL, hidden_size=640))
    runs = {}
    for design in ("grid", "chain"):
        if design == "chain":
            monkeypatch.setattr(gxb, "xp_bwd_design", lambda *a, **k: "chain")
        p = params_to_torch(params0, dev)
        for t in param_leaves(p):
            t.requires_grad_(True)
        adam = Adam(0.0)
        state = adam.init(p)
        gxb.reset_launch_counts()
        tot = tbptt_step(p, adam, state, 1e-4, images, yb, yr, B, "cuda")
        torch.cuda.synchronize()
        grid = design == "grid"
        assert gxb.launch_counts["bigru_window_xp_bwd_rec"] == 2 * 19
        assert gxb.launch_counts["bigru_window_xp_bwd_hp"] == (2 * 19 if grid else 0)
        assert gxb.launch_counts["bigru_window_xp_bwd_rec_grid"] == (2 * 19 if grid else 0)
        assert gxb.launch_counts[tile] == (2 * 19 if grid else 0)
        assert gxb.launch_counts["bigru_window_xp_bwd_rec_chain"] == (0 if grid else 2 * 19)
        runs[design] = ([t.detach().clone() for t in tot]
                        + [t.detach() for t in param_leaves(p)]
                        + [torch.as_tensor(v) for v in opt_leaves(state)[1:]])
    for a, b in zip(runs["grid"], runs["chain"]):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# K3 and K3f in the grid design: the recurrence with W_hh spread over the
# SMs' shared memory (ops.gru_window_xp_grid)
# ---------------------------------------------------------------------------

# the wide inference and training batches at H=1024, H=640 and 768 (10 and 12
# units per block) at ragged batches, one of them past K3's 128-row and K3f's
# 256-row block, the forced route's H=128 (2 units per block), and an H that
# is no multiple of 8 (h rows loaded an element at a time); then the edges
# of K3's thread tiles: B=1 at H=1024 (4 rows a thread, one row of 64), a
# last block short of U (1000 = 62 x 16 + 8; 1020 = 63 x 16 + 12; 700 = 63 x
# 11 + 7, an odd U) at Hs no multiple of a chunk's 16 k (1020 and 700 not of
# 8), at 4 rows a thread (B=13) and 8 (B=300 and 200 in ragged row blocks of
# 256; 129 at U=11)
XP_GRID_SHAPES = [(100, 512, 1024), (100, 64, 1024), (7, 13, 640), (5, 300, 768), (6, 8, 128),
                  (4, 7, 610), (3, 1, 1024), (4, 13, 1000), (3, 300, 1000), (3, 200, 1020),
                  (5, 129, 700)]


def xp_grid_counts(before, name, design, H):
    ran = xp_ran(name, H, design, fast=name.endswith("_fast"))
    return {k: v + (k in ran) for k, v in before.items()}


@pytest.mark.parametrize("T,B,H", XP_GRID_SHAPES)
def test_xp_grid_design_equals_chain_design(dev, T, B, H):
    """K3 in the grid design against xp_window_kernel: out and hn exactly
    equal, each design counted as launched; the grid against the plain
    version."""
    from helen_tpu_torch.ops import gru_window_xp as gx

    args = xp_case(np.random.default_rng(T * B + H + 41), T, B, H, dev)
    assert gx.xp_fwd_design(H, B) == "grid"
    before = dict(gx.launch_counts)
    new = gx.bigru_window_xp(*args)
    torch.cuda.synchronize()
    assert gx.launch_counts == xp_grid_counts(before, "bigru_window_xp", "grid", H)
    before = dict(gx.launch_counts)
    old = gx.bigru_window_xp(*args, design="chain")
    torch.cuda.synchronize()
    assert gx.launch_counts == xp_grid_counts(before, "bigru_window_xp", "chain", H)
    for what, n, o in zip(("out_f", "out_b", "h_f", "h_b"), new, old):
        assert torch.equal(n, o), f"{what}: max |grid - chain| {float((n - o).abs().max())}"
    assert_outputs_close(new, gx.bigru_window_xp_plain(*args))


@pytest.mark.parametrize("T,B,H", XP_GRID_SHAPES)
def test_xp_fast_grid_matches_plain(dev, T, B, H):
    """K3f in the grid design (bf16 mma.sync, fp32 sums) against its plain
    version at FAST_TOL, each design counted as launched; its distance from
    the one-launch K3f is printed."""
    from helen_tpu_torch.ops import gru_window_xp as gx

    xp_f, xp_b, h0f, h0b, layer = xp_case(np.random.default_rng(T * B + H + 43), T, B, H, dev)
    args = (xp_f.to(torch.bfloat16), xp_b.to(torch.bfloat16), h0f, h0b, fast(layer))
    assert gx.xp_fwd_design(H, B, fast=True) == "grid"
    before = dict(gx.launch_counts)
    new = gx.bigru_window_xp_fast(*args)
    torch.cuda.synchronize()
    assert gx.launch_counts == xp_grid_counts(before, "bigru_window_xp_fast", "grid", H)
    before = dict(gx.launch_counts)
    old = gx.bigru_window_xp_fast(*args, design="chain")
    torch.cuda.synchronize()
    assert gx.launch_counts == xp_grid_counts(before, "bigru_window_xp_fast", "chain", H)
    assert_outputs_close(new, gx.bigru_window_xp_fast_plain(*args), FAST_TOL)
    print(f"K3f T={T} B={B} H={H}: max |grid - one-launch| {max_diff(new, old):.3g}")


@pytest.mark.parametrize("T,B,H", XP_GRID_SHAPES)
def test_xp_fast_designs_equal_their_plain_orders(dev, T, B, H):
    """Each K3f design equals, bit for bit, its plain version summed in its
    own order: the grid the tensor cores' (models.gru.mma_product), the
    chain k order's."""
    from helen_tpu_torch.ops import gru_window_xp as gx

    xp_f, xp_b, h0f, h0b, layer = xp_case(np.random.default_rng(T * B + H + 44), T, B, H, dev)
    args = (xp_f.to(torch.bfloat16), xp_b.to(torch.bfloat16), h0f, h0b, fast(layer))
    for design in gx.DESIGNS:
        got = gx.bigru_window_xp_fast(*args, design=design)
        want = gx.bigru_window_xp_fast_plain(*args, design=design)
        assert all(torch.equal(g, w) for g, w in zip(got, want)), design


def max_diff(a, b):
    return max(float((x - y).abs().max()) for x, y in zip(a, b))


@pytest.mark.parametrize("B", [512, 64])
@pytest.mark.parametrize("D", [90, 2048])
def test_xp_grid_equals_chain_for_both_layer_kinds(dev, B, D):
    """K3's grid design against xp_window_kernel, bit for bit, on xp
    projected as the main path projects each layer kind: layer 0 from an
    image window of counts (D=90, large and saturating inputs), the decoder
    from a pair of K3 outputs in [-1, 1] (D=2048); a window of T=100 at the
    consensus batch (the 8-row tile) and the wide train's B=64 (4 rows)."""
    from helen_tpu_torch.ops import gru_window_xp as gx
    from helen_tpu_torch.ops import gru_window_xp_grid as xg

    T, H = 100, 1024
    rng = np.random.default_rng(B + D)
    layer = make_layer(rng, D, H, dev)
    if D == 90:
        x = torch.from_numpy(rng.integers(0, 60, (T, B, D)).astype(np.float32)).to(dev)
    else:
        x = torch.from_numpy(rng.uniform(-1, 1, (T, B, D)).astype(np.float32)).to(dev)
    xp_f, xp_b = (x @ layer[d]["w_ih"] + layer[d]["b_ih"] for d in ("fwd", "bwd"))
    h0f, h0b = (torch.from_numpy(rng.uniform(-1, 1, (B, H)).astype(np.float32)).to(dev)
                for _ in range(2))
    assert xg.grid_tile(B) == (8 if B == 512 else 4)
    new = gx.bigru_window_xp(xp_f, xp_b, h0f, h0b, layer, design="grid")
    old = gx.bigru_window_xp(xp_f, xp_b, h0f, h0b, layer, design="chain")
    torch.cuda.synchronize()
    for what, n, o in zip(("out_f", "out_b", "h_f", "h_b"), new, old):
        assert torch.equal(n, o), f"{what}: max |grid - chain| {float((n - o).abs().max())}"


def test_xp_grid_refuses_a_tile_it_does_not_have(dev):
    """The kernel's entry takes 8 or 4 rows a thread; any other is
    refused before a launch (cudaErrorInvalidValue) and the outputs are left
    as they were."""
    from helen_tpu_torch.ops import gru_window_xp_grid as xg
    from helen_tpu_torch.ops import library
    from helen_tpu_torch.ops.library import GRID_COUNTERS, card_limits

    T, B, H = 3, 16, 1024
    xp_f, xp_b, h0f, h0b, layer = xp_case(np.random.default_rng(47), T, B, H, dev)
    units = xg.grid_units(H, *card_limits())
    w = [layer[d][k] for d in ("fwd", "bwd") for k in ("w_hh", "b_hh")]
    for rpt in (0, 1, 2, 3, 16):
        outs = [o.fill_(7.0) for o in library.outputs(T, B, H, dev)]
        arrive = torch.zeros(GRID_COUNTERS, dtype=torch.int32, device=dev)
        err = library.get_lib().bigru_window_xp_grid(
            *(t.data_ptr() for t in (xp_f, xp_b, h0f, h0b, *w, *outs, arrive)), T, B, H, units,
            rpt, torch.cuda.current_stream().cuda_stream)
        torch.cuda.synchronize()
        assert err == 1, rpt  # cudaErrorInvalidValue
        assert all(bool((o == 7.0).all()) for o in outs)


@pytest.mark.parametrize("tier", ["parity", "fast"])
def test_xp_grid_is_bit_identical_across_launches(dev, tier):
    from helen_tpu_torch.ops import gru_window_xp as gx

    xp_f, xp_b, h0f, h0b, layer = xp_case(np.random.default_rng(44), 100, 64, 1024, dev)
    if tier == "fast":
        run = lambda: gx.bigru_window_xp_fast(  # noqa: E731
            xp_f.to(torch.bfloat16), xp_b.to(torch.bfloat16), h0f, h0b, fast(layer),
            design="grid")
    else:
        run = lambda: gx.bigru_window_xp(xp_f, xp_b, h0f, h0b, layer, design="grid")  # noqa: E731
    a, b = run(), run()
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_xp_grid_refuses_what_the_card_does_not_hold(dev, monkeypatch):
    """A forced "grid" on a card whose SMs do not hold W_hh raises before any
    launch; a grid of more blocks than the card holds at once is refused by
    the cooperative launch, and the wrapper raises: nothing falls back. The
    library's shared-memory formula is the Python mirror's."""
    from helen_tpu_torch.ops import gru_window_xp as gx
    from helen_tpu_torch.ops import gru_window_xp_grid as xg
    from helen_tpu_torch.ops import library

    xp_f, xp_b, h0f, h0b, layer = xp_case(np.random.default_rng(45), 4, 8, 1024, dev)
    sms, budget = library.card_limits()
    before = dict(gx.launch_counts)
    monkeypatch.setattr(library, "_card", {torch.cuda.current_device(): (114, budget)})
    assert gx.xp_fwd_design(1024, 8) == "chain"
    with pytest.raises(ValueError, match="does not take H=1024"):
        gx.bigru_window_xp(xp_f, xp_b, h0f, h0b, layer, design="grid")
    assert gx.launch_counts == before
    monkeypatch.setattr(library, "_card", {torch.cuda.current_device(): (sms, budget)})
    fl = fast(layer)
    for tier, ins, lay in ((False, (xp_f, xp_b), layer),
                           (True, (xp_f.to(torch.bfloat16), xp_b.to(torch.bfloat16)), fl)):
        units = xg.grid_units(1024, sms, budget, tier) - 1
        with pytest.raises(RuntimeError, match=f"{xg.KERNELS[tier]} launch failed"):
            xg.launch_xp_grid(*ins, h0f, h0b, lay, units, gx.launch_counts, dev, tier)
    assert gx.launch_counts == before
    lib = library.get_lib()
    for h in (128, 160, 610, 640, 768, 1000, 1024):
        for u in (2, 3, 10, 12, 16, 24):
            for f in (0, 1):
                assert lib.bigru_window_xp_grid_smem_bytes(h, u, f) == xg.grid_smem_bytes(h, u, f)


# ---------------------------------------------------------------------------
# the xp route's kernels at every rows-per-block count the design rules pick
# past the widths chip_smoke.py's phase 15a runs, and K3f's grid at U=17
# ---------------------------------------------------------------------------

def wide_xp_case(T, B, H, dev, seed):
    """Projected streams, h0 pair and a layer's recurrent weights
    (``{"fwd", "bwd"}`` of ``w_hh``, ``b_hh``; the wrappers read no other
    key), drawn on the card: at H=14,600 a direction's W_hh is 2.6 GB."""
    g = torch.Generator(device=dev).manual_seed(seed)
    u = lambda k, *s: (torch.rand(s, generator=g, device=dev) * 2 - 1) * k  # noqa: E731
    k = 1.0 / H ** 0.5
    layer = {d: {"w_hh": u(k, H, 3 * H), "b_hh": u(k, 3 * H)} for d in ("fwd", "bwd")}
    return u(1, T, B, 3 * H), u(1, T, B, 3 * H), u(1, B, H), u(1, B, H), layer


# (kernel, T, B, H, design, rows per block or grid units on the H100): K3 at
# 4, 2 and 1 rows, K3f's grid at 17 units and its chain at 2 and 1 rows,
# K4's pass 1 at 2 and 1 rows; ragged batches where rows > 1. Short windows:
# each block reads all of W_hh at every step.
WIDE_CASES = [("k3", 2, 5, 4000, "chain", 4), ("k3", 2, 3, 8000, "chain", 2),
              ("k3", 1, 2, 14_600, "chain", 1), ("k3f", 3, 13, 1088, "grid", 17),
              ("k3f", 2, 3, 4000, "chain", 2), ("k3f", 2, 2, 8000, "chain", 1),
              ("k4", 2, 5, 3000, "chain", 2), ("k4", 2, 2, 6000, "chain", 1)]


@pytest.mark.parametrize("kernel,T,B,H,design,n", WIDE_CASES)
def test_xp_kernels_at_each_rows_per_block_match_plain(dev, kernel, T, B, H, design, n):
    """Each design the rules pick past the widths phase 15a runs, against
    its plain version at phase 15a's bars: K3 within TOL, K3f bit for bit
    against its plain version in its design's order, K4 (pass 1, then
    pass 2) within TOL times the largest output magnitude; each launch
    counted under its design and its rows per block."""
    from helen_tpu_torch.ops import gru_window_xp as gx
    from helen_tpu_torch.ops import gru_window_xp_bwd as gxb
    from helen_tpu_torch.ops import gru_window_xp_grid as xg
    from helen_tpu_torch.ops import library

    sms, budget = library.card_limits()
    xp_f, xp_b, h0f, h0b, layer = wide_xp_case(T, B, H, dev, seed=H + T * B)
    if kernel == "k4":
        assert gxb.xp_bwd_design(H, B) == design and gxb.bwd_chain_rows(H, budget) == n
        of, ob, _, _ = gx.bigru_window_xp_plain(xp_f, xp_b, h0f, h0b, layer)
        g = torch.Generator(device=dev).manual_seed(H)
        r = lambda *s: torch.rand(s, generator=g, device=dev) * 2 - 1  # noqa: E731
        args = (xp_f, xp_b, h0f, h0b, of.contiguous(), ob.contiguous(), r(T, B, H),
                r(T, B, H), r(B, H), r(B, H), layer)
        before = dict(gxb.launch_counts)
        got = gxb.bigru_window_xp_bwd(*args)
        torch.cuda.synchronize()
        ran = ("bigru_window_xp_bwd_rec", "bigru_window_xp_bwd_wgrad",
               "bigru_window_xp_bwd_rec_chain", f"bigru_window_xp_bwd_rec_chain_r{n}")
        assert gxb.launch_counts == {k: v + (k in ran) for k, v in before.items()}
        assert_xp_grads_close(got, gxb.bigru_window_xp_bwd_plain(*args))
        return
    tier = kernel == "k3f"
    assert gx.xp_fwd_design(H, B, fast=tier) == design
    assert (xg.grid_units(H, sms, budget, tier) if design == "grid"
            else gx.chain_rows(H, budget, tier)) == n
    name = "bigru_window_xp" + ("_fast" if tier else "")
    if tier:
        xp_f, xp_b = xp_f.to(torch.bfloat16), xp_b.to(torch.bfloat16)
        layer = {d: {"w_hh": p["w_hh"].to(torch.bfloat16), "b_hh": p["b_hh"]}
                 for d, p in layer.items()}
    args = (xp_f, xp_b, h0f, h0b, layer)
    before = dict(gx.launch_counts)
    got = getattr(gx, name)(*args)
    torch.cuda.synchronize()
    ran = xp_ran(name, H, design, tier)
    assert gx.launch_counts == {k: v + (k in ran) for k, v in before.items()}
    if tier:
        want = gx.bigru_window_xp_fast_plain(*args)
        assert max_diff(got, want) == 0.0, f"{design} against its plain order"
    else:
        assert_outputs_close(got, gx.bigru_window_xp_plain(*args))


def test_tbptt_batch_xp_grid_design_equals_chain_design(dev, monkeypatch):
    """One TBPTT batch at H=640 on the xp route (19 windows: forward,
    backward, Adam) with K3 in the grid design, then with every K3 forced to
    xp_window_kernel: the same loss sums, params and Adam moments, bit for
    bit."""
    import dataclasses

    from helen_tpu_torch.config import MODEL
    from helen_tpu_torch.io.checkpoint import opt_leaves, params_to_torch
    from helen_tpu_torch.models.transducer import init_params, param_leaves
    from helen_tpu_torch.ops import gru_window_xp as gx
    from helen_tpu_torch.train.train_loop import Adam, tbptt_step

    rng = np.random.default_rng(46)
    B = 8
    images = torch.from_numpy(rng.integers(0, 40, (B, 1000, 90), dtype=np.uint8)).to(dev)
    yb = torch.from_numpy(rng.integers(0, 5, (B, 1000))).to(dev)
    yr = torch.from_numpy(rng.integers(0, 11, (B, 1000))).to(dev)
    params0 = init_params(torch.Generator().manual_seed(9),
                          dataclasses.replace(MODEL, hidden_size=640))
    rule = gx.xp_fwd_design
    runs = {}
    for d in ("grid", "chain"):
        monkeypatch.setattr(gx, "xp_fwd_design",
                            lambda H, B, design=None, fast=False, device=None, *, d=d:
                            rule(H, B, d, fast, device))
        p = params_to_torch(params0, dev)
        for t in param_leaves(p):
            t.requires_grad_(True)
        adam = Adam(0.0)
        state = adam.init(p)
        gx.reset_launch_counts()
        tot = tbptt_step(p, adam, state, 1e-4, images, yb, yr, B, "cuda")
        torch.cuda.synchronize()
        assert gx.launch_counts["bigru_window_xp"] == 2 * 19
        assert gx.launch_counts[f"bigru_window_xp_{d}"] == 2 * 19
        assert gx.launch_counts["bigru_window_xp_" + ("chain" if d == "grid" else "grid")] == 0
        runs[d] = ([t.detach().clone() for t in tot]
                   + [t.detach() for t in param_leaves(p)]
                   + [torch.as_tensor(v) for v in opt_leaves(state)[1:]])
    for a, b in zip(runs["grid"], runs["chain"]):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# pass 2 of both backwards in the split design (ops.gru_window_wgrad):
# slices of 1,600 rows on 3xTF32 tensor cores, the slices added in order
# ---------------------------------------------------------------------------

def wgrad_case(kind, T, B, H, dev):
    """Pass 2's inputs: bwd_case's window (the seed of the pass-1 design
    tests, so that (image, 100, 512, 128) is their full-range uint8 case)
    and pass 1's dxp, dhp_n from its plain version."""
    from helen_tpu_torch.ops import gru_window_bwd as gb

    args = bwd_case(np.random.default_rng(T * B + H + (kind == "pair")), kind, T, B, H, dev)
    dxp, dhpn, *_ = gb.bigru_window_bwd_rec_plain(*args, need_dx=False)
    return (*args[:6], dxp.contiguous(), dhpn.contiguous())


def xp_wgrad_case(T, B, H, dev):
    """K4 pass 2's inputs: h0 and the forward's outputs of xp_bwd_case, and
    pass 1's dxp, dhp_n from its plain version."""
    from helen_tpu_torch.ops import gru_window_xp_bwd as gxb

    args = xp_bwd_case(np.random.default_rng(T * B + H), T, B, H, dev)
    dxp, dhpn, *_ = gxb.bigru_window_xp_bwd_rec_plain(*args)
    return (*args[2:6], dxp.contiguous(), dhpn.contiguous())


def wgrad_counts(before, T, B):
    """gru_window_wgrad.launch_counts after one pass 2 from ``before``: the
    split kernel and, past one slice of 1,600 rows, the slice sum."""
    ran = {"bigru_window_wgrad_split": 1, "bigru_window_wgrad_sum": int(T * B > 1600)}
    return {k: v + ran[k] for k, v in before.items()}


def assert_wgrad_close(got, want):
    assert set(got) == set(want) == {"fwd", "bwd"}
    for d in ("fwd", "bwd"):
        assert set(got[d]) == set(want[d]), d
        for k, w in want[d].items():
            assert got[d][k].shape == w.shape, (d, k)
            _scaled_close(got[d][k], w, f"{d}.{k}")


# test_backward_kernel_matches_plain's shapes (ragged batches, H=160, both
# layer kinds), the flagship's training window (16 slices) and B=512 on
# full-range uint8 images (32 slices), where the one-slice design's dW_ih
# landed 1.03e-5 of its scale away
@pytest.mark.parametrize("kind,T,B,H", [("image", 7, 1, 128), ("image", 9, 13, 128),
                                        ("pair", 6, 257, 128), ("image", 5, 13, 160),
                                        ("pair", 5, 13, 160), ("pair", 100, 64, 128),
                                        ("image", 100, 256, 128), ("pair", 100, 256, 128),
                                        ("image", 100, 512, 128), ("pair", 100, 512, 128)])
def test_wgrad_split_matches_plain(dev, kind, T, B, H):
    from helen_tpu_torch.ops import gru_window_bwd as gb
    from helen_tpu_torch.ops import gru_window_wgrad as gwg

    args = wgrad_case(kind, T, B, H, dev)
    before = dict(gwg.launch_counts)
    got = gwg.bigru_window_wgrad(*args)
    torch.cuda.synchronize()
    assert gwg.launch_counts == wgrad_counts(before, T, B)
    assert_wgrad_close(got, gb.bigru_window_bwd_wgrad_plain(*args))


# K4's pass 2 at the wide widths, ragged batches and the wide train's B=64
@pytest.mark.parametrize("T,B,H", [(7, 1, 1024), (6, 13, 640), (5, 9, 160), (4, 7, 37),
                                   (100, 64, 640), (100, 64, 1024)])
def test_xp_wgrad_split_matches_plain(dev, T, B, H):
    from helen_tpu_torch.ops import gru_window_wgrad as gwg
    from helen_tpu_torch.ops import gru_window_xp_bwd as gxb

    args = xp_wgrad_case(T, B, H, dev)
    before = dict(gwg.launch_counts)
    got = gwg.bigru_window_xp_wgrad(*args)
    torch.cuda.synchronize()
    assert gwg.launch_counts == wgrad_counts(before, T, B)
    assert_wgrad_close(got, gxb.bigru_window_xp_bwd_wgrad_plain(*args))


@pytest.mark.parametrize("form", ["image", "pair", "xp"])
def test_wgrad_split_is_bit_identical_across_launches(dev, form):
    from helen_tpu_torch.ops import gru_window_wgrad as gwg

    if form == "xp":
        args = xp_wgrad_case(100, 64, 1024, dev)
        a, b = gwg.bigru_window_xp_wgrad(*args), gwg.bigru_window_xp_wgrad(*args)
    else:
        args = wgrad_case(form, 100, 256, 128, dev)
        a, b = gwg.bigru_window_wgrad(*args), gwg.bigru_window_wgrad(*args)
    for d in ("fwd", "bwd"):
        for k in a[d]:
            assert torch.equal(a[d][k], b[d][k]), (d, k)


def test_default_backwards_launch_the_split_design_only(dev):
    """bigru_window_bwd (both layer kinds) and bigru_window_xp_bwd take pass
    2's split design: each pass 2 counted once, as the split kernel and the
    slice sum."""
    from helen_tpu_torch.ops import gru_window_bwd as gb
    from helen_tpu_torch.ops import gru_window_wgrad as gwg
    from helen_tpu_torch.ops import gru_window_xp_bwd as gxb

    gwg.reset_launch_counts()
    before = gb.launch_counts["bigru_window_bwd_wgrad"], gxb.launch_counts[
        "bigru_window_xp_bwd_wgrad"]
    for kind in ("image", "pair"):
        gb.bigru_window_bwd(*bwd_case(np.random.default_rng(61), kind, 100, 64, 128, dev))
    gxb.bigru_window_xp_bwd(*xp_bwd_case(np.random.default_rng(62), 5, 9, 160, dev))
    torch.cuda.synchronize()
    assert gwg.launch_counts == {"bigru_window_wgrad_split": 3, "bigru_window_wgrad_sum": 2}
    assert (gb.launch_counts["bigru_window_bwd_wgrad"], gxb.launch_counts[
        "bigru_window_xp_bwd_wgrad"]) == (before[0] + 2, before[1] + 1)


def test_wgrad_wrappers_refuse_what_the_kernels_do_not_take(dev):
    from helen_tpu_torch.ops import gru_window as gw
    from helen_tpu_torch.ops import gru_window_wgrad as gwg

    src, start, h0f, h0b, of, ob, dxp, dhpn = wgrad_case("pair", 4, 8, 128, dev)
    before = dict(gwg.launch_counts)
    with pytest.raises(ValueError):  # dxp of one direction
        gwg.bigru_window_wgrad(src, start, h0f, h0b, of, ob, dxp[0], dhpn)
    with pytest.raises(ValueError):  # dhp_n on the CPU
        gwg.bigru_window_xp_wgrad(h0f, h0b, of, ob, dxp, dhpn.cpu())
    with pytest.raises(TypeError):  # a float64 output stream
        gwg.bigru_window_xp_wgrad(h0f, h0b, of.double(), ob, dxp, dhpn)
    assert gwg.launch_counts == before
    lib = gw.get_lib()
    for D, with_ih, T, B, H in ((90, 1, 100, 256, 128), (256, 1, 100, 512, 128),
                                (0, 0, 100, 64, 1024), (320, 1, 7, 13, 160), (0, 0, 64, 50, 37)):
        assert (lib.bigru_window_wgrad_scratch_bytes(D, with_ih, T, B, H)
                == gwg.wgrad_design(D, H, T, B, bool(with_ih)).scratch_bytes)


# ---------------------------------------------------------------------------
# the fast tier's two-launch design of K1f/K2f: the projection pass and the
# recurrence on bf16 tensor cores (ops.gru_window_smem, gru_window_fast.cu)
# ---------------------------------------------------------------------------

# the main path's batch (8 rows per block), the training batch (4 rows), a
# ragged one (a part-filled last block), and H=160, the widest the design takes
FAST_SMEM_SHAPES = [(100, 512, 128), (100, 256, 128), (100, 300, 128), (9, 13, 160),
                    (6, 67, 40)]


@pytest.mark.parametrize("T,B,H", FAST_SMEM_SHAPES)
def test_fast_smem_kernels_match_their_plain_versions(dev, T, B, H):
    """Each kernel of the design against its plain version on the same
    inputs: the projections (window_proj_plain on bf16-rounded rows) within
    1e-3 of the output's magnitude (at least 1), the recurrence
    (window_rec_plain with the bf16 w_hh) within 1e-3."""
    from helen_tpu_torch.models.gru import bf16_round
    from helen_tpu_torch.ops import gru_window_smem as gs

    rng = np.random.default_rng(T * B + H + 31)
    image, start, _, h0f, h0b, l1 = k1_case(rng, T, B, H, dev)
    xa, xb, _, _, l2 = k2_case(rng, T, B, H, dev)
    l1, l2 = fast(l1), fast(l2)
    pairs = (
        (gs.bigru_window_proj_in1_fast(image, start, T, l1),
         gs.window_proj_plain(bf16_round(gs.image_window(image, start, T)), l1)),
        (gs.bigru_window_proj_in2_fast(xa, xb, l2),
         gs.window_proj_plain(bf16_round(torch.cat([xa, xb], -1)), l2)),
    )
    for got, want in pairs:
        torch.cuda.synchronize()
        assert got.shape == want.shape == (2, T, B, 3 * H)
        err = float((got - want).abs().max())
        assert err <= FAST_TOL * max(1.0, float(want.abs().max())), err
    xp = pairs[1][0]
    assert_outputs_close(gs.bigru_window_rec_fast(xp, h0f, h0b, l2),
                         gs.window_rec_plain(xp, h0f, h0b, l2), FAST_TOL)


@pytest.mark.parametrize("T,B,H", FAST_SMEM_SHAPES)
@pytest.mark.parametrize("kind", ["in1", "in2"])
def test_fast_smem_design_matches_chain_design(dev, kind, T, B, H):
    """K1f/K2f in the two-launch design against bigru_window_kernel<FAST>
    (design "chain"): within 1e-3 (the tensor cores sum in another order);
    two launches of the design give the same bits."""
    from helen_tpu_torch.ops import gru_window as gw

    rng = np.random.default_rng(T * B + H + 37)
    if kind == "in1":
        image, start, _, h0f, h0b, layer = k1_case(rng, T, B, H, dev)
        run = lambda d: gw.bigru_window_in1_fast(image, start, T, h0f, h0b,  # noqa: E731
                                                 fast(layer), design=d)
    else:
        xa, xb, h0f, h0b, layer = k2_case(rng, T, B, H, dev)
        run = lambda d: gw.bigru_window_in2_fast(xa, xb, h0f, h0b, fast(layer),  # noqa: E731
                                                 design=d)
    assert gw.window_design(H, B, fast=True) == "smem"
    before = dict(gw.launch_counts)
    new = run("smem")
    assert gw.launch_counts == {k: v + ran_fast(kind, H, B).get(k, 0)
                                for k, v in before.items()}
    again, chain = run("smem"), run("chain")
    torch.cuda.synchronize()
    assert_outputs_close(new, chain, FAST_TOL)
    for g, a in zip(new, again):
        assert torch.equal(g, a)


def test_fast_smem_wrappers_refuse_what_the_kernels_do_not_take(dev):
    from helen_tpu_torch.ops import gru_window as gw
    from helen_tpu_torch.ops import gru_window_smem as gs

    rng = np.random.default_rng(41)
    T, B, H = 4, 8, 128
    image, start, _, h0f, h0b, l1 = k1_case(rng, T, B, H, dev)
    xa, xb, _, _, l2 = k2_case(rng, T, B, H, dev)
    f1, f2 = fast(l1), fast(l2)
    xp = torch.zeros(2, T, B, 3 * H, device=dev)
    before = dict(gw.launch_counts)
    with pytest.raises(TypeError):  # float32 weights
        gs.bigru_window_proj_in1_fast(image, start, T, l1)
    with pytest.raises(TypeError):
        gs.bigru_window_rec_fast(xp, h0f, h0b, l2)
    with pytest.raises(ValueError):  # K1f's weights given to K2f's projection
        gs.bigru_window_proj_in2_fast(xa, xb, f1)
    with pytest.raises(ValueError):  # a float image
        gs.bigru_window_proj_in1_fast(image.float(), start, T, f1)
    with pytest.raises(ValueError):  # window past the image's end
        gs.bigru_window_proj_in1_fast(image, image.shape[1] - 2, T, f1)
    with pytest.raises(ValueError):  # h0 on the CPU
        gs.bigru_window_rec_fast(xp, h0f.cpu(), h0b, f2)
    with pytest.raises(ValueError):  # the scratch's shape
        gs.bigru_window_rec_fast(xp[:, :, :-1], h0f, h0b, f2)
    wide = fast(make_layer(rng, 2 * 192, 192, dev))
    h192 = torch.zeros(B, 192, device=dev)
    with pytest.raises(ValueError, match="maximum 160"):  # H past FAST_REC_MAX_H
        gs.bigru_window_rec_fast(torch.zeros(2, T, B, 3 * 192, device=dev), h192, h192, wide)
    with pytest.raises(ValueError, match="fast tier"):  # design "smem" forced past it
        gw.bigru_window_in2_fast(torch.zeros(T, B, 192, device=dev),
                                 torch.zeros(T, B, 192, device=dev), h192, h192, wide,
                                 design="smem")
    assert gw.launch_counts == before
    for g, p in zip(gs.bigru_window_rec_fast(gs.bigru_window_proj_in2_fast(xa, xb, f2),
                                             h0f, h0b, f2),
                    gw.bigru_window_in2_fast_plain(xa, xb, h0f, h0b, f2)):
        assert float((g - p).abs().max()) <= FAST_TOL


def test_fast_smem_fit_follows_the_source(dev):
    """The library's fit sizes and limit equal the Python rule's."""
    from helen_tpu_torch.ops import gru_window as gw
    from helen_tpu_torch.ops import gru_window_smem as gs

    lib = gw.get_lib()
    assert lib.bigru_window_rec_fast_max_h() == gs.FAST_REC_MAX_H
    for h in (1, 15, 16, 40, 128, 136, 160):
        assert lib.bigru_window_rec_fast_smem_bytes(h) == gs.fast_rec_smem_bytes(h)
