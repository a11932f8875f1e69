"""The fast (bf16) tier of the port against helen_tpu's ``pallas_fast``, on
the CPU.

K1f, K2f and K3f (``bigru_window_in1_fast``, ``bigru_window_in2_fast``,
``bigru_window_xp_fast``: the fast instantiations of the window kernels) run
only on a CUDA device (tests/test_torch_cuda.py, chip_smoke.py phase 10);
here their plain versions, which the wrappers take on CPU tensors, are held
against the Pallas bodies they replace, run with ``fast=True`` in interpret
mode, on inputs made with numpy from a seed. Tolerance 1e-3 for the
recurrences: where two sums are taken in another order, a bf16 rounding of
h or xp can land one ulp apart, at most 2^-8 relative, times a weight of at
most 1/sqrt(H).

Then the tier as a whole: the bf16 weight copies bit for bit against
``astype(jnp.bfloat16)``; consensus on a random-weight flagship-geometry
model and, on the forced xp route, an H=640 one against helen_tpu's
``consensus_labels(backend="pallas_fast")`` with its window kernels run in
interpret mode; the trained checkpoint with 0 flips between the tiers; the
dispatch of the fast backends.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_fixtures import TRAINED_NPZ

torch.set_num_threads(2)

TOL = 1e-3
F = 90
# (T, B, H) as tests/test_torch_gru_window.py: the flagship hidden size and
# an off-lane-grid one (the in-projection route); the xp-stream kernel of
# helen_tpu takes H % 128 == 0
SHAPES = [(8, 16, 128), (5, 8, 160)]
XP_SHAPES = [(8, 16, 128), (5, 8, 256)]


def make_layer(rng, d, h, w_ih_scale=1.0):
    k = 1.0 / np.sqrt(h)
    u = lambda *s: rng.uniform(-k, k, s).astype(np.float32)  # noqa: E731
    return {dr: {"w_ih": u(d, 3 * h) * np.float32(w_ih_scale), "w_hh": u(h, 3 * h),
                 "b_ih": u(3 * h), "b_hh": u(3 * h)} for dr in ("fwd", "bwd")}


def to_jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def fast_layer(layer):
    from helen_tpu_torch.io.checkpoint import fast_layer as fl
    from helen_tpu_torch.io.checkpoint import params_to_torch

    return fl(params_to_torch(layer, "cpu"))


def close(got, want, what, tol=TOL):
    got = got.detach().numpy() if hasattr(got, "detach") else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got, want, atol=tol, rtol=0, err_msg=what)


def random_params(h, seed):
    """A flagship-geometry param tree of hidden size ``h`` made with numpy,
    from the distributions of helen_tpu's ``init_params``: GRU tensors
    uniform(+-1/sqrt(H)), heads uniform(+-1/sqrt(2H))."""
    rng = np.random.default_rng(seed)
    k = 1.0 / np.sqrt(2 * h)
    u = lambda b, *s: rng.uniform(-b, b, s).astype(np.float32)  # noqa: E731
    return {"encoder": make_layer(rng, F, h), "decoder": make_layer(rng, 2 * h, h),
            "base_head": {"w": u(k, 2 * h, 5), "b": u(k, 5)},
            "rle_head": {"w": u(k, 2 * h, 11), "b": u(k, 11)}}


# ---------------------------------------------------------------------------
# the weight copies
# ---------------------------------------------------------------------------

def test_bf16_copies_match_jax_bit_for_bit():
    """``params_to_torch(..., fast=True)``: every GRU ``w_ih``/``w_hh`` is a
    bf16 copy equal bit for bit to ``jnp.asarray(w).astype(jnp.bfloat16)``
    (values that straddle a rounding tie included), ``w_ih_f32`` holds the
    same values in float32, biases and heads stay the float32 values."""
    from helen_tpu_torch.io.checkpoint import fast_weights, is_fast, params_to_torch

    params = random_params(32, seed=1)
    params["decoder"]["l1"] = make_layer(np.random.default_rng(2), 64, 32)
    # ties of round-to-nearest-even: 1 + 2^-8 and 1 + 3 x 2^-8 (bf16 keeps 7
    # fraction bits), and a value just past a tie
    params["encoder"]["fwd"]["w_hh"][0, :3] = [1 + 2 ** -8, 1 + 3 * 2 ** -8,
                                               np.float32(1 + 2 ** -8 + 2 ** -20)]
    fp = params_to_torch(params, "cpu", fast=True)
    assert is_fast(fp) and not is_fast(params_to_torch(params, "cpu"))
    assert fast_weights(fp) is fp
    for stack in ("encoder", "decoder"):
        for key in [k for k in params[stack] if k.startswith("l")] + [None]:
            layer = params[stack] if key is None else params[stack][key]
            got = fp[stack] if key is None else fp[stack][key]
            for d in ("fwd", "bwd"):
                for w in ("w_ih", "w_hh"):
                    t = got[d][w]
                    assert t.dtype == torch.bfloat16, (stack, key, d, w)
                    want = np.asarray(jnp.asarray(layer[d][w]).astype(jnp.bfloat16))
                    np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                                  want.view(np.int16))
                np.testing.assert_array_equal(got[d]["w_ih_f32"].numpy(),
                                              got[d]["w_ih"].float().numpy())
                for b in ("b_ih", "b_hh"):
                    assert got[d][b].dtype == torch.float32
                    np.testing.assert_array_equal(got[d][b].numpy(), layer[d][b])
    for head in ("base_head", "rle_head"):
        assert fp[head]["w"].dtype == torch.float32
        np.testing.assert_array_equal(fp[head]["w"].numpy(), params[head]["w"])
    assert fp["encoder"]["fwd"]["w_hh"][0, :3].float().tolist() == [1.0, 1 + 2 ** -6,
                                                                   1 + 2 ** -7]


# ---------------------------------------------------------------------------
# each kernel's plain version against the Pallas body it replaces
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("T,B,H", SHAPES)
def test_k1f_plain_matches_pallas_inproj1_fast(T, B, H):
    """K1f's plain version against ``bigru_apply_inproj(..., fast=True,
    exact_input=True, interpret=True)``, ``_kernel_inproj1`` with
    ``fast=True``, on a uint8 window over the full byte range."""
    from helen_tpu.ops.gru_pallas import bigru_apply_inproj

    from helen_tpu_torch.ops.gru_window import bigru_window_in1_fast_plain

    rng = np.random.default_rng(T + H)
    L, start = T + 7, 4
    image = rng.integers(0, 256, size=(B, L, F), dtype=np.uint8)
    h0f, h0b = (rng.uniform(-1, 1, (B, H)).astype(np.float32) for _ in range(2))
    layer = make_layer(rng, F, H, w_ih_scale=1 / 64)
    x = jnp.asarray(image[:, start:start + T].transpose(1, 0, 2).astype(np.float32))
    want = bigru_apply_inproj(to_jax(layer), x, jnp.asarray(h0f), jnp.asarray(h0b),
                              fast=True, exact_input=True, interpret=True)
    got = bigru_window_in1_fast_plain(torch.from_numpy(image), start, T,
                                      torch.from_numpy(h0f), torch.from_numpy(h0b),
                                      fast_layer(layer))
    for g, w, what in zip(got, want, ("out_f", "out_b", "h_f", "h_b")):
        close(g, w, what)


@pytest.mark.parametrize("T,B,H", SHAPES)
def test_k2f_plain_matches_pallas_inproj2_fast(T, B, H):
    """K2f's plain version against the pair form of ``bigru_apply_inproj``
    with ``fast=True`` (``_kernel_inproj2``; the halves rounded to bf16)."""
    from helen_tpu.ops.gru_pallas import bigru_apply_inproj

    from helen_tpu_torch.ops.gru_window import bigru_window_in2_fast_plain

    rng = np.random.default_rng(2 * T + H)
    xa, xb = (rng.standard_normal((T, B, H)).astype(np.float32) for _ in range(2))
    h0f, h0b = (rng.uniform(-1, 1, (B, H)).astype(np.float32) for _ in range(2))
    layer = make_layer(rng, 2 * H, H)
    want = bigru_apply_inproj(to_jax(layer), (jnp.asarray(xa), jnp.asarray(xb)),
                              jnp.asarray(h0f), jnp.asarray(h0b), fast=True,
                              interpret=True)
    got = bigru_window_in2_fast_plain(*(torch.from_numpy(a) for a in (xa, xb, h0f, h0b)),
                                      fast_layer(layer))
    for g, w, what in zip(got, want, ("out_f", "out_b", "h_f", "h_b")):
        close(g, w, what)


@pytest.mark.parametrize("T,B,H", XP_SHAPES)
def test_k3f_plain_matches_pallas_kernel_fast(T, B, H):
    """K3f's plain version against ``fused_bigru_window`` with bf16
    ``w_f``/``w_b`` (``_kernel`` with ``fast=True``), the same bf16 xp
    streams on both sides."""
    from helen_tpu.ops.gru_pallas import fused_bigru_window

    from helen_tpu_torch.ops.gru_window_xp import bigru_window_xp_fast_plain

    rng = np.random.default_rng(3 * T + H)
    layer = make_layer(rng, 2 * H, H)
    x = rng.uniform(-1, 1, (T, B, 2 * H)).astype(np.float32)
    xp = [x @ layer[d]["w_ih"] + layer[d]["b_ih"] for d in ("fwd", "bwd")]
    h0f, h0b = (rng.uniform(-1, 1, (B, H)).astype(np.float32) for _ in range(2))
    bf = jnp.bfloat16
    jxp = [jnp.asarray(a).astype(bf) for a in xp]
    txp = [torch.from_numpy(a).to(torch.bfloat16) for a in xp]
    for j, t in zip(jxp, txp):  # both frameworks round to nearest even
        np.testing.assert_array_equal(np.asarray(j).view(np.int16),
                                      t.view(torch.int16).numpy())
    f, b = layer["fwd"], layer["bwd"]
    want = fused_bigru_window(*jxp, jnp.asarray(h0f), jnp.asarray(h0b),
                              jnp.asarray(f["w_hh"]).astype(bf),
                              jnp.asarray(b["w_hh"]).astype(bf),
                              jnp.asarray(f["b_hh"][None]), jnp.asarray(b["b_hh"][None]),
                              interpret=True)
    got = bigru_window_xp_fast_plain(*txp, torch.from_numpy(h0f), torch.from_numpy(h0b),
                                     fast_layer(layer))
    for g, w, what in zip(got, want, ("out_f", "out_b", "h_f", "h_b")):
        close(g, w, what)


@pytest.mark.parametrize("kind", ["image_d90", "pair_d2h"])
def test_xp_fast_layer_matches_bigru_apply_fused_fast(kind):
    """The port's fast xp layer (``window_xp_fast`` on CPU tensors: the
    float32 projection rounded once to bf16 after the bias, then K3f's
    plain version) against ``bigru_apply_fused(fast=True,
    interpret=True)``: a uint8 D=90 window read from the image, and a D=2H
    pair input."""
    from helen_tpu.ops.gru_pallas import bigru_apply_fused

    from helen_tpu_torch.ops.gru_window_bwd import window_input
    from helen_tpu_torch.ops.gru_window_xp import window_xp_fast

    rng = np.random.default_rng(37)
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
    out, hf, hb = bigru_apply_fused(to_jax(layer), jnp.asarray(x), jnp.asarray(h0f),
                                    jnp.asarray(h0b), interpret=True, fast=True)
    with torch.no_grad():
        of, ob, gf, gb = window_xp_fast(src, start, T, torch.from_numpy(h0f),
                                        torch.from_numpy(h0b), fast_layer(layer))
    close(torch.cat([of, ob], -1), out, "out")
    close(gf, hf, "h_f")
    close(gb, hb, "h_b")


def test_fast_wrappers_take_the_plain_version_on_cpu_and_count_no_launch():
    from helen_tpu_torch.ops import gru_window as gw
    from helen_tpu_torch.ops import gru_window_xp as gx

    rng = np.random.default_rng(4)
    T, B, H = 4, 5, 16
    image = torch.from_numpy(rng.integers(0, 9, (B, T + 3, F), dtype=np.uint8))
    h0 = [torch.from_numpy(rng.uniform(-1, 1, (B, H)).astype(np.float32)) for _ in range(2)]
    l1, l2 = fast_layer(make_layer(rng, F, H)), fast_layer(make_layer(rng, 2 * H, H))
    xp = [torch.from_numpy(rng.uniform(-1, 1, (T, B, 3 * H)).astype(np.float32))
          .to(torch.bfloat16) for _ in range(2)]
    gw.reset_launch_counts()
    gx.reset_launch_counts()
    pairs = [
        (gw.bigru_window_in1_fast(image, 2, T, *h0, l1),
         gw.bigru_window_in1_fast_plain(image, 2, T, *h0, l1)),
        (gw.bigru_window_in2_fast(h0[0][None].expand(T, B, H).contiguous(),
                                  h0[1][None].expand(T, B, H).contiguous(), *h0, l2),
         gw.bigru_window_in2_fast_plain(h0[0][None].expand(T, B, H).contiguous(),
                                        h0[1][None].expand(T, B, H).contiguous(), *h0, l2)),
        (gx.bigru_window_xp_fast(*xp, *h0, l2), gx.bigru_window_xp_fast_plain(*xp, *h0, l2)),
    ]
    for got, want in pairs:
        for g, p in zip(got, want):
            torch.testing.assert_close(g, p, rtol=0, atol=0)
            assert g.dtype == torch.float32
    assert not any(gw.launch_counts.values()) and not any(gx.launch_counts.values())


def test_fast_wrappers_raise_off_cpu_and_cuda():
    from helen_tpu_torch.ops import gru_window as gw
    from helen_tpu_torch.ops import gru_window_xp as gx

    T, B, H = 3, 2, 16
    meta = lambda *s, dt=torch.float32: torch.empty(s, device="meta", dtype=dt)  # noqa: E731
    h0, x = meta(B, H), meta(T, B, H)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        gw.bigru_window_in1_fast(meta(B, T, F, dt=torch.uint8), 0, T, h0, h0, {})
    with pytest.raises(ValueError, match="CUDA or CPU"):
        gw.bigru_window_in2_fast(x, x, h0, h0, {})
    with pytest.raises(ValueError, match="CUDA or CPU"):
        gx.bigru_window_xp_fast(meta(T, B, 3 * H, dt=torch.bfloat16),
                                meta(T, B, 3 * H, dt=torch.bfloat16), h0, h0, {})


# ---------------------------------------------------------------------------
# the tier as a whole, against helen_tpu's pallas_fast
# ---------------------------------------------------------------------------

@pytest.fixture
def helen_interpret(monkeypatch):
    """helen_tpu's window-kernel entries in interpret mode, so that its
    ``pallas_fast`` backend runs on the CPU: ``_forward_inproj`` and
    ``forward`` import them at call time. Nothing in helen_tpu is edited."""
    import helen_tpu.ops.gru_pallas as gp

    monkeypatch.setattr(gp, "bigru_apply_inproj",
                        functools.partial(gp.bigru_apply_inproj, interpret=True))
    monkeypatch.setattr(gp, "bigru_apply_fused",
                        functools.partial(gp.bigru_apply_fused, interpret=True))


def flips(a, b) -> int:
    return int((np.asarray(a) != np.asarray(b)).sum())


@pytest.mark.parametrize("h,route,want_kernels", [(128, None, "cuda_fast_inproj"),
                                                  (640, "xp", "cuda_fast_xp")])
def test_consensus_matches_helen_tpu_pallas_fast(h, route, want_kernels, helen_interpret):
    """A random-weight model through the port's fast tier (``cuda_fast`` on
    CPU tensors: the plain versions of the route's fast kernels) against
    helen_tpu's ``consensus_probs(backend="pallas_fast")``: the flagship
    geometry (helen_tpu's in-projection route) and, on the forced xp route,
    H=640 (helen_tpu's xp route on the CPU). Votes within 1e-2; label flips
    at most 1 per 1,000 per head against helen_tpu's fast tier; against
    helen_tpu's float32 ``xla`` labels no more flips than helen_tpu's own
    fast tier has, plus 1 per 1,000."""
    from helen_tpu.config import WindowConfig as JaxWindow
    from helen_tpu.models.transducer import consensus_probs as jax_probs

    from helen_tpu_torch.config import WindowConfig
    from helen_tpu_torch.io.checkpoint import params_to_torch
    from helen_tpu_torch.models.transducer import consensus_probs, engaged_kernel

    params = random_params(h, seed=h)
    B, L = (8, 250) if h == 128 else (8, 150)
    images = np.random.default_rng(h).integers(0, 40, size=(B, L, F), dtype=np.uint8)
    jw, tw = JaxWindow(window=20, jump=10), WindowConfig(window=20, jump=10)
    jp = to_jax(params)
    want = jax_probs(jp, jnp.asarray(images), jw, backend="pallas_fast")
    ref = jax_probs(jp, jnp.asarray(images, jnp.float32), jw, backend="xla")
    tp = params_to_torch(params, "cpu", fast=True)
    assert engaged_kernel(tp, "cuda_fast", route) == want_kernels
    with torch.no_grad():
        got = consensus_probs(tp, torch.from_numpy(images), tw, backend="cuda_fast",
                              route=route)
    n = B * L
    for g, w, r, head in zip(got, want, ref, ("base", "rle")):
        g, w, r = g.numpy(), np.asarray(w), np.asarray(r)
        np.testing.assert_allclose(g, w, atol=1e-2, rtol=0, err_msg=head)
        gl, wl, rl = g.argmax(-1), w.argmax(-1), r.argmax(-1)
        assert flips(gl, wl) <= 1e-3 * n, (head, flips(gl, wl))
        assert flips(gl, rl) <= flips(wl, rl) + 1e-3 * n, (head, flips(gl, rl), flips(wl, rl))


def test_trained_checkpoint_fast_labels_equal_parity_labels(tmp_path):
    """BENCH_r05's ``trained_fast_flips`` regime: the trained checkpoint on
    synthetic images gives the same labels in the fast tier (``torch_fast``)
    as in the parity tier (``torch``), 0 + 0 flips, on the full
    1000-column images (19 windows)."""
    from helen_tpu_torch.io.checkpoint import load_model_any, params_to_torch
    from helen_tpu_torch.io.images import MarginPolishDataset
    from helen_tpu_torch.io.synthetic import random_sequence, write_image_file
    from helen_tpu_torch.models.transducer import consensus_labels

    path = str(tmp_path / "img.h5")
    write_image_file(path, {"c": random_sequence(16000, seed=21)}, region_cols=1000,
                     overlap_cols=80, noise=0.1, seed=22)
    ds = MarginPolishDataset([path])
    images = torch.from_numpy(np.stack([ds.load(i).image for i in range(len(ds))]))
    assert images.shape[0] >= 4
    params, _ = load_model_any(TRAINED_NPZ)
    with torch.no_grad():
        pb, pr = consensus_labels(params_to_torch(params, "cpu"), images, backend="torch")
        fb, fr = consensus_labels(params_to_torch(params, "cpu", fast=True), images,
                                  backend="torch_fast")
    assert (flips(fb, pb), flips(fr, pr)) == (0, 0)


# ---------------------------------------------------------------------------
# dispatch
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


def test_fast_backends_resolve_and_never_fall_back(monkeypatch):
    from helen_tpu_torch.models.transducer import resolve_backend
    from helen_tpu_torch.ops import library

    # the H100's SMs and opt-in shared memory per block, set by hand
    monkeypatch.setattr(library, "_card", {0: (132, 232_448)})

    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    for name in ("pallas_fast", "fast"):
        assert resolve_backend(name, cpu) == "torch_fast"
        assert resolve_backend(name, cuda) == "cuda_fast"
    assert resolve_backend("torch_fast", cuda) == "torch_fast"
    with pytest.raises(ValueError, match="needs a CUDA device"):
        resolve_backend("cuda_fast", cpu)
    # past 1024 the fast xp kernels take the width (K3f's grid to H=1088,
    # its chain design past it); only the card's shared memory at one row
    # per block stops them (H=14,528 on the H100), and then resolving
    # refuses, naming --backend torch, rather than fall back
    big = tiny_params(1040)
    assert resolve_backend("pallas_fast", cuda, big) == "cuda_fast"
    assert resolve_backend("pallas_fast", cpu, big) == "torch_fast"
    from helen_tpu_torch.ops import gru_window_xp as gx

    assert gx.chain_rows(14_528, 232_448, fast=True) == 1
    assert gx.chain_rows(14_529, 232_448, fast=True) is None
    h, meta = 14_529, lambda *s: torch.empty(s, device="meta")  # noqa: E731
    widest = {"encoder": {d: {"w_ih": meta(F, 3 * h), "w_hh": meta(h, 3 * h)}
                          for d in ("fwd", "bwd")},
              "base_head": {"w": meta(2 * h, 5)}, "rle_head": {"w": meta(2 * h, 11)}}
    with pytest.raises(ValueError, match="--backend torch"):
        resolve_backend("pallas_fast", cuda, widest)
    assert resolve_backend("pallas_fast", cpu, widest) == "torch_fast"


@pytest.mark.parametrize("name", ["pallas_fast", "fast", "cuda_fast", "torch_fast"])
def test_fast_tier_is_not_a_train_backend(name):
    from helen_tpu_torch.models.transducer import resolve_backend

    for dev in ("cpu", "cuda"):
        with pytest.raises(ValueError, match="not a train backend"):
            resolve_backend(name, torch.device(dev), kind="train")


def test_engaged_kernel_names_the_fast_families():
    from helen_tpu_torch.models.transducer import engaged_kernel

    small, wide, big = (tiny_params(h) for h in (128, 640, 1040))
    assert engaged_kernel(small, "cuda_fast") == "cuda_fast_inproj"
    assert engaged_kernel(small, "cuda_fast", route="xp") == "cuda_fast_xp"
    assert engaged_kernel(wide, "cuda_fast") == "cuda_fast_xp"
    assert engaged_kernel(small, "torch_fast") == "torch_fast"
    assert engaged_kernel(big, "torch_fast") == "torch_fast"
    assert engaged_kernel(big, "cuda_fast") == "cuda_fast_xp"  # no fixed cap past 1024
    with pytest.raises(ValueError, match="route selects"):
        engaged_kernel(small, "torch_fast", route="xp")
    with pytest.raises(ValueError, match="unresolved"):
        engaged_kernel(small, "pallas_fast")


def test_fast_forward_refuses_grad_and_needs_no_fast_tree():
    """The fast tier has no backward: ``forward`` on a fast backend raises
    with grad enabled. Under ``no_grad`` a float32 tree is cast per call
    and gives what the fast tree gives."""
    from helen_tpu_torch.io.checkpoint import params_to_torch
    from helen_tpu_torch.models.transducer import forward, init_hidden, model_geometry

    params = params_to_torch(random_params(16, seed=3), "cpu")
    x = torch.from_numpy(np.random.default_rng(3).integers(0, 30, (2, 30, F), dtype=np.uint8))
    hidden = init_hidden(2, model_geometry(params))
    for backend in ("torch_fast", "cuda_fast"):
        with pytest.raises(RuntimeError, match="inference only"):
            forward(params, x, hidden, backend, start=5, window=20)
    with torch.no_grad():
        a = forward(params, x, hidden, "torch_fast", start=5, window=20)
        b = forward(params_to_torch(random_params(16, seed=3), "cpu", fast=True), x, hidden,
                    "torch_fast", start=5, window=20)
    for u, v in zip(a, b):
        torch.testing.assert_close(u, v, rtol=0, atol=0)
