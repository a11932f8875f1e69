"""The fused encoder+decoder window of the port against helen_tpu's, on the
CPU.

K5 and K5f (``transducer_window_encdec`` and ``_fast``, the port of
``_kernel_fused_encdec``) run only on a CUDA device
(tests/test_torch_cuda.py, chip_smoke.py phase 11); here the wrappers take
their plain versions (K1 -> K2 and K1f -> K2f chained) on CPU tensors, and
the port's ``transducer_apply_fused_encdec`` is held against helen_tpu's in
interpret mode at its own test's shapes (``tests/test_pallas.py:507``):
parity within 1e-5 (the Pallas side computes its products as bf16x3
passes, the port in fp32, sums in other orders), fast within 1e-3 (a bf16
rounding of h one ulp apart, times a weight of at most 1/sqrt(H)); and
against helen_tpu's float32 ``bigru_apply`` chain within 1e-5.

Then the route as a whole (``route="encdec"``, library only, inference
only): a small consensus against a window loop around helen_tpu's fused
entry, the golden fixtures, the refusals, the dispatch that never picks it,
and the fit functions.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_fixtures import FIXTURES, golden, stage_golden_images

torch.set_num_threads(2)

F = 90


def helen_layers(H, seed, w_ih_scale=1.0):
    """An encoder (D=90) and a decoder (D=2H) layer from helen_tpu's
    ``bigru_init``, as numpy; the encoder's ``w_ih`` times ``w_ih_scale``."""
    from helen_tpu.models.gru import bigru_init

    to_np = functools.partial(jax.tree_util.tree_map, np.asarray)
    enc = to_np(bigru_init(jax.random.PRNGKey(seed), F, H))
    for d in enc.values():
        d["w_ih"] = d["w_ih"] * np.float32(w_ih_scale)
    return enc, to_np(bigru_init(jax.random.PRNGKey(seed + 1), 2 * H, H))


def to_torch(tree):
    from helen_tpu_torch.io.checkpoint import params_to_torch

    return params_to_torch(tree, "cpu")


def to_jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def fused_inputs(w_ih_scale):
    """helen_tpu's fused-kernel test inputs (``tests/test_pallas.py:507``):
    T=7, B=8, D=90, H=128, uint8 x in [0, 40), standard-normal h0."""
    T, B, H = 7, 8, 128
    enc, dec = helen_layers(H, 10, w_ih_scale)
    rng = np.random.default_rng(10)
    x = rng.integers(0, 40, size=(T, B, F)).astype(np.uint8)
    h0f, h0b = (rng.standard_normal((B, H)).astype(np.float32) for _ in range(2))
    return enc, dec, x, h0f, h0b


def port_fused(enc, dec, x, h0f, h0b, fast):
    from helen_tpu_torch.ops.gru_window_encdec import transducer_apply_fused_encdec

    return transducer_apply_fused_encdec(to_torch(enc), to_torch(dec), torch.from_numpy(x),
                                         torch.from_numpy(h0f), torch.from_numpy(h0b),
                                         fast=fast, exact_input=True)


def assert_outputs_close(got, want, tol):
    for g, w, what in zip(got, want, ("out_f", "out_b", "h_f", "h_b")):
        w = np.asarray(w)
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape, what
        np.testing.assert_allclose(g.numpy(), w, atol=tol, rtol=0, err_msg=what)


@pytest.mark.parametrize("fast,tol", [(False, 1e-5), (True, 1e-3)])
def test_fused_encdec_matches_helen_tpu(fast, tol):
    """The port's ``transducer_apply_fused_encdec`` against helen_tpu's
    (``interpret=True``) on its own test's inputs, weights from
    ``bigru_init`` carried across by ``params_to_torch``: all four of the
    decoder's outputs. The encoder's ``w_ih`` is scaled by 1/64, as the
    port's K1 tests scale it: helen_tpu's TPU product splits each float32
    weight into two bf16 halves (16 significant bits), which with the
    unscaled weights and x up to 39 moves its parity tier 4e-5 from float32
    (the next test holds the port to float32 there)."""
    from helen_tpu.ops.gru_pallas import transducer_apply_fused_encdec as jax_fused

    enc, dec, x, h0f, h0b = fused_inputs(1 / 64)
    want = jax_fused(to_jax(enc), to_jax(dec), jnp.asarray(x), jnp.asarray(h0f),
                     jnp.asarray(h0b), fast=fast, exact_input=True, interpret=True)
    assert_outputs_close(port_fused(enc, dec, x, h0f, h0b, fast), want, tol)


def test_fused_encdec_matches_helen_tpu_float32_chain():
    """With ``bigru_init``'s weights as they are, the port's parity entry
    against helen_tpu's float32 reference: ``bigru_apply`` at HIGHEST for
    the encoder, then for the decoder on its output from its final states,
    within 1e-5 (sums in other orders)."""
    from helen_tpu.models.gru import bigru_apply

    enc, dec, x, h0f, h0b = fused_inputs(1.0)
    hi = jax.lax.Precision.HIGHEST
    out, hf, hb = bigru_apply(to_jax(enc), jnp.asarray(x, jnp.float32), jnp.asarray(h0f),
                              jnp.asarray(h0b), precision=hi)
    out, hf, hb = bigru_apply(to_jax(dec), out, hf, hb, precision=hi)
    H = h0f.shape[1]
    assert_outputs_close(port_fused(enc, dec, x, h0f, h0b, False),
                         (out[..., :H], out[..., H:], hf, hb), 1e-5)


@pytest.mark.parametrize("fast", [False, True])
def test_wrapper_on_cpu_is_the_chain_and_counts_no_launch(fast):
    """On CPU tensors K5 (K5f) is its plain version, K1 -> K2 (K1f -> K2f)
    chained, to the bit, at an H that is not a multiple of 32 (the two
    directions share a warp on the card), and no launch is counted."""
    from helen_tpu_torch.io.checkpoint import fast_layer
    from helen_tpu_torch.ops import gru_window as gw
    from helen_tpu_torch.ops import gru_window_encdec as ge

    T, B, H = 6, 5, 40
    enc, dec = (to_torch(layer) for layer in helen_layers(H, 3))
    if fast:
        enc, dec = fast_layer(enc), fast_layer(dec)
    rng = np.random.default_rng(3)
    image = torch.from_numpy(rng.integers(0, 256, (B, T + 9, F), dtype=np.uint8))
    h0 = [torch.from_numpy(rng.uniform(-1, 1, (B, H)).astype(np.float32)) for _ in range(2)]
    in1, in2 = ((gw.bigru_window_in1_fast_plain, gw.bigru_window_in2_fast_plain) if fast
                else (gw.bigru_window_in1_plain, gw.bigru_window_in2_plain))
    kernel = ge.transducer_window_encdec_fast if fast else ge.transducer_window_encdec
    gw.reset_launch_counts()
    got = kernel(image, 4, T, *h0, enc, dec)
    of, ob, hf, hb = in1(image, 4, T, *h0, enc)
    for g, w in zip(got, in2(of, ob, hf, hb, dec)):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    assert not any(gw.launch_counts.values())


def test_wrapper_raises_off_cpu_and_cuda():
    from helen_tpu_torch.ops import gru_window_encdec as ge

    T, B, H = 3, 2, 16
    meta = lambda *s, dt=torch.float32: torch.empty(s, dtype=dt, device="meta")  # noqa: E731
    for kernel in (ge.transducer_window_encdec, ge.transducer_window_encdec_fast):
        with pytest.raises(ValueError, match="CUDA or CPU"):
            kernel(meta(B, 10, F, dt=torch.uint8), 0, T, meta(B, H), meta(B, H), {}, {})


def random_params(h, seed):
    """A flagship-geometry param tree made with numpy: GRU tensors
    uniform(+-1/sqrt(H)), heads uniform(+-1/sqrt(2H))."""
    rng = np.random.default_rng(seed)
    k, kh = 1.0 / np.sqrt(h), 1.0 / np.sqrt(2 * h)
    u = lambda b, *s: rng.uniform(-b, b, s).astype(np.float32)  # noqa: E731
    gru = lambda d: {dr: {"w_ih": u(k, d, 3 * h), "w_hh": u(k, h, 3 * h),  # noqa: E731
                          "b_ih": u(k, 3 * h), "b_hh": u(k, 3 * h)} for dr in ("fwd", "bwd")}
    return {"encoder": gru(F), "decoder": gru(2 * h),
            "base_head": {"w": u(kh, 2 * h, 5), "b": u(kh, 5)},
            "rle_head": {"w": u(kh, 2 * h, 11), "b": u(kh, 11)}}


def helen_tpu_window_loop(params, images, window, jump):
    """helen_tpu's ``transducer_apply_fused_encdec`` (interpret mode) over
    the sliding windows, the decoder's final states seeding the next
    window's encoder, the heads and the softmax vote in numpy."""
    from helen_tpu.ops.gru_pallas import transducer_apply_fused_encdec as jax_fused

    B, L, _ = images.shape
    H = params["encoder"]["fwd"]["w_hh"].shape[0]
    enc, dec = to_jax(params["encoder"]), to_jax(params["decoder"])
    hf = hb = jnp.zeros((B, H), jnp.float32)
    votes = {name: np.zeros((B, L, params[name]["w"].shape[1]), np.float32)
             for name in ("base_head", "rle_head")}
    for start in range(0, L - window + 1, jump):
        x = jnp.asarray(images[:, start:start + window].transpose(1, 0, 2))
        of, ob, hf, hb = jax_fused(enc, dec, x, hf, hb, exact_input=True, interpret=True)
        out = np.concatenate([np.asarray(of), np.asarray(ob)], -1)  # (T, B, 2H)
        for name, v in votes.items():
            logits = out @ params[name]["w"] + params[name]["b"]
            e = np.exp(logits - logits.max(-1, keepdims=True))
            v[:, start:start + window] += (e / e.sum(-1, keepdims=True)).transpose(1, 0, 2)
    return votes["base_head"], votes["rle_head"]


def test_consensus_through_the_route_matches_helen_tpu_fused_loop():
    """The slice as a whole: ``consensus_probs(backend="cuda",
    route="encdec")`` (on CPU tensors the plain K5) against a window loop
    around helen_tpu's fused entry, L=40, window 10, stride 5: votes within
    1e-5, labels equal."""
    from helen_tpu_torch.config import WindowConfig
    from helen_tpu_torch.models.transducer import consensus_probs, engaged_kernel

    params = random_params(128, seed=5)
    images = np.random.default_rng(5).integers(0, 40, size=(8, 40, F), dtype=np.uint8)
    want = helen_tpu_window_loop(params, images, window=10, jump=5)
    tp = to_torch(params)
    assert engaged_kernel(tp, "cuda", "encdec") == "cuda_encdec"
    with torch.no_grad():
        got = consensus_probs(tp, torch.from_numpy(images), WindowConfig(window=10, jump=5),
                              backend="cuda", route="encdec")
    for g, w, head in zip(got, want, ("base", "rle")):
        np.testing.assert_allclose(g.numpy(), w, atol=1e-5, rtol=0, err_msg=head)
        np.testing.assert_array_equal(g.argmax(-1).numpy(), w.argmax(-1), err_msg=head)


@pytest.mark.parametrize("fixture", ["model", "h160"])
def test_golden_labels_through_the_encdec_route(fixture, tmp_path):
    """The one-layer golden geometries (the flagship, and H=160, off the
    warp grid) through ``route="encdec"``: labels byte-identical to the
    recorded reference labels."""
    from helen_tpu_torch.io.checkpoint import load_model_any
    from helen_tpu_torch.io.images import MarginPolishDataset
    from helen_tpu_torch.models.transducer import consensus_labels

    ckpt, labels, _ = FIXTURES[fixture]
    ds = MarginPolishDataset([f"{stage_golden_images(tmp_path)}/golden_images.h5"])
    recs = [ds.load(i) for i in range(len(ds))]
    params, _ = load_model_any(golden(ckpt))
    with torch.no_grad():
        base, rle = consensus_labels(to_torch(params),
                                     torch.from_numpy(np.stack([r.image for r in recs])),
                                     backend="cuda", route="encdec")
    want = np.load(golden(labels))
    for j, r in enumerate(recs):
        k = f"{r.contig}-{r.contig_start}-{r.contig_end}-{r.chunk_id}"
        assert base[j].numpy().tobytes() == want[f"base/{k}"].tobytes(), k
        assert rle[j].numpy().tobytes() == want[f"rle/{k}"].tobytes(), k


def _refusal(case):
    """Run the refused call of ``case``."""
    import dataclasses

    from helen_tpu_torch.config import MODEL
    from helen_tpu_torch.io.checkpoint import load_model_any
    from helen_tpu_torch.models.transducer import forward, init_hidden, init_params
    from helen_tpu_torch.train.train_loop import Adam, tbptt_step

    x = torch.zeros((2, 120, F), dtype=torch.uint8)
    if case == "two_layers":
        params, _ = load_model_any(golden(FIXTURES["l2_h128"][0]))
        params = to_torch(params)
        with torch.no_grad():
            forward(params, x, init_hidden(2, dataclasses.replace(MODEL, gru_layers=2)), "cuda",
                    start=0, window=100, route="encdec")
        return
    params = init_params(torch.Generator().manual_seed(0), MODEL)
    hidden = init_hidden(2, MODEL)
    if case == "past_the_fit":  # H=320 at T=100: 262,560 bytes at 1 row
        cfg = dataclasses.replace(MODEL, hidden_size=320)
        with torch.no_grad():
            forward(init_params(torch.Generator().manual_seed(0), cfg), x,
                    init_hidden(2, cfg), "cuda", start=0, window=100, route="encdec")
    elif case == "grad":
        forward(params, x, hidden, "cuda", start=0, window=100, route="encdec")
    elif case == "tbptt":
        adam = Adam(0.0)
        labels = torch.zeros((2, 120), dtype=torch.long)
        tbptt_step(params, adam, adam.init(params), 1e-4, x, labels, labels, 2, "cuda",
                   route="encdec")
    elif case in ("torch", "torch_fast"):
        with torch.no_grad():
            forward(params, x, hidden, case, start=0, window=100, route="encdec")


@pytest.mark.parametrize("case,error,match", [
    ("two_layers", ValueError, 'one encoder and one decoder layer.*route="inproj"'),
    ("past_the_fit", ValueError, 'does not fit.*route="inproj"'),
    ("grad", RuntimeError, "inference only"),
    ("tbptt", ValueError, "inference only"),
    ("torch", ValueError, "backend 'cuda' or 'cuda_fast'"),
    ("torch_fast", ValueError, "backend 'cuda' or 'cuda_fast'"),
])
def test_route_refusals(case, error, match):
    """What the route refuses, each with an error and nothing computed
    another way: two layers (golden_l2_h128), an H past the fit of a
    T=100 window, grad enabled, ``tbptt_step``, and a plain backend with a
    route."""
    with pytest.raises(error, match=match):
        _refusal(case)


def test_route_none_never_engages_encdec(monkeypatch):
    """The dispatch rule never picks the fused kernel: ``route=None`` names
    the chained families at every width, and a forward with K5 and K5f
    made to raise runs through."""
    from helen_tpu_torch.config import MODEL, WindowConfig
    from helen_tpu_torch.models import transducer as tr

    def refuse(*_):
        raise AssertionError("K5 engaged without route='encdec'")

    monkeypatch.setattr(tr, "transducer_window_encdec", refuse)
    monkeypatch.setattr(tr, "transducer_window_encdec_fast", refuse)
    for h, family in ((128, "inproj"), (283, "inproj"), (512, "inproj"), (640, "xp")):
        p = to_torch(random_params(h, seed=1))
        assert tr.kernel_route(h) == family
        for backend in ("cuda", "cuda_fast"):
            assert tr.engaged_kernel(p, backend) == f"{backend}_{family}"
            if h <= 512:
                assert tr.engaged_kernel(p, backend, "encdec") == f"{backend}_encdec"
    params = tr.init_params(torch.Generator().manual_seed(2), MODEL)
    images = torch.from_numpy(np.random.default_rng(2).integers(0, 30, (2, 30, F),
                                                                dtype=np.uint8))
    with torch.no_grad():
        for backend in ("cuda", "cuda_fast"):
            tr.consensus_labels(params, images, WindowConfig(window=10, jump=5), backend)
        with pytest.raises(AssertionError, match="K5 engaged"):
            tr.consensus_labels(params, images, WindowConfig(window=10, jump=5), "cuda",
                                route="encdec")
    with pytest.raises(ValueError, match="maximum 512"):
        tr.engaged_kernel(to_torch(random_params(640, seed=1)), "cuda", "encdec")


def test_encdec_fit_functions():
    """The port's fit functions, in the form of helen_tpu's VMEM estimator
    test (``tests/test_pallas.py:540``) with this card's budget: shared
    memory scales with T*BT*H, the block rows shrink until the budget fits,
    and the fit gate holds at the smallest block."""
    from helen_tpu_torch.ops.gru_window_encdec import (
        encdec_block_rows,
        encdec_fits_smem,
        encdec_smem_bytes,
    )
    from helen_tpu_torch.ops.library import HOPPER_SMEM_OPTIN

    assert HOPPER_SMEM_OPTIN == 232_448
    small = encdec_smem_bytes(128, 1, 90, 100, fast=False)
    big = encdec_smem_bytes(128, 4, 90, 100, fast=False)
    assert big > small > 0
    assert encdec_smem_bytes(128, 2, 90, 100, fast=False) == 211_776
    # the fast tier holds the boundary in bf16: about half the bytes
    assert encdec_smem_bytes(128, 4, 90, 100, fast=True) == 226_944
    # the flagship window: 2 rows per block in parity, 4 in the fast tier
    assert encdec_block_rows(128, 90, 100, fast=False) == 2
    assert encdec_block_rows(128, 90, 100, fast=True) == 4
    # a smaller budget forces fewer rows; a larger one stops at 4
    assert encdec_block_rows(128, 90, 100, False, budget=small) == 1
    assert encdec_block_rows(128, 90, 100, False, budget=big) == 4
    assert encdec_block_rows(128, 90, 100, False, budget=small - 1) == 0
    # parity fits up to H=283 at T=100, the fast tier further; 2H threads
    # per block cap both at 512, and at 256 for 4 rows
    assert encdec_fits_smem(283, 90, 100, False)
    assert not encdec_fits_smem(284, 90, 100, False)
    assert encdec_fits_smem(512, 90, 40, True)
    assert encdec_block_rows(512, 90, 10, False, budget=10 ** 8) == 2
    assert not encdec_fits_smem(513, 90, 10, False, budget=10 ** 8)
    assert not encdec_fits_smem(2048, 90, 100, False)
