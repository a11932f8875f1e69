"""The plain versions of the CUDA window kernels against helen_tpu's Pallas
kernels (interpret mode) and its lax.scan GRU.

K1 (``bigru_window_in1``, the port of ``_kernel_inproj1``) reads its window
straight from a (B, L, F) uint8 image; it is held against
``bigru_apply_inproj(..., exact_input=True, interpret=True)`` on the same
window. K2 (``bigru_window_in2``, the port of ``_kernel_inproj2``) is held
against the pair form. Both are held against ``bigru_apply`` at HIGHEST.
Tolerance 2e-5, as tests/test_pallas.py holds the in-projection kernels: the
Pallas side computes its products as bf16x3 hi/lo passes, the port in fp32,
and their sums are taken in other orders. The kernels themselves run only on
a CUDA device (tests/test_torch_cuda.py, and chip_smoke.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

TOL = 2e-5
# (T, B, H) as tests/test_pallas.py: the flagship hidden size and an
# off-lane-grid one
SHAPES = [(8, 16, 128), (5, 8, 160)]
F = 90


def make_layer(rng, d, h, w_ih_scale=1.0):
    k = 1.0 / np.sqrt(h)
    u = lambda *s: rng.uniform(-k, k, s).astype(np.float32)  # noqa: E731
    return {dr: {"w_ih": u(d, 3 * h) * np.float32(w_ih_scale), "w_hh": u(h, 3 * h),
                 "b_ih": u(3 * h), "b_hh": u(3 * h)} for dr in ("fwd", "bwd")}


def to_jax(layer):
    return jax.tree_util.tree_map(jnp.asarray, layer)


def to_torch(layer):
    from helen_tpu_torch.io.checkpoint import params_to_torch

    return params_to_torch(layer, "cpu")


def close(got, want, what):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=TOL, rtol=0,
                               err_msg=what)


def k1_inputs(T, B, H, seed=0):
    """A (B, L, F) uint8 image over the full byte range, a window start
    inside it, h0 pair, and K1 weights (w_ih scaled so that the 0-255
    inputs keep the gates off saturation)."""
    rng = np.random.default_rng(seed)
    L, start = T + 7, 4
    image = rng.integers(0, 256, size=(B, L, F), dtype=np.uint8)
    h0f, h0b = (rng.uniform(-1, 1, (B, H)).astype(np.float32) for _ in range(2))
    return image, start, h0f, h0b, make_layer(rng, F, H, w_ih_scale=1 / 64)


def k2_inputs(T, B, H, seed=1):
    rng = np.random.default_rng(seed)
    xa, xb = (rng.standard_normal((T, B, H)).astype(np.float32) for _ in range(2))
    h0f, h0b = (rng.uniform(-1, 1, (B, H)).astype(np.float32) for _ in range(2))
    return xa, xb, h0f, h0b, make_layer(rng, 2 * H, H)


@pytest.mark.parametrize("T,B,H", SHAPES)
def test_k1_plain_matches_pallas_inproj1(T, B, H):
    from helen_tpu.ops.gru_pallas import bigru_apply_inproj

    from helen_tpu_torch.ops.gru_window import bigru_window_in1_plain

    image, start, h0f, h0b, layer = k1_inputs(T, B, H)
    x = jnp.asarray(image[:, start:start + T].transpose(1, 0, 2).astype(np.float32))
    want = bigru_apply_inproj(to_jax(layer), x, jnp.asarray(h0f), jnp.asarray(h0b),
                              exact_input=True, interpret=True)
    got = bigru_window_in1_plain(torch.from_numpy(image), start, T,
                                 torch.from_numpy(h0f), torch.from_numpy(h0b),
                                 to_torch(layer))
    for g, w, what in zip(got, want, ("out_f", "out_b", "h_f", "h_b")):
        assert tuple(g.shape) == tuple(w.shape), what
        close(g, w, what)


@pytest.mark.parametrize("T,B,H", SHAPES)
def test_k2_plain_matches_pallas_inproj2(T, B, H):
    from helen_tpu.ops.gru_pallas import bigru_apply_inproj

    from helen_tpu_torch.ops.gru_window import bigru_window_in2_plain

    xa, xb, h0f, h0b, layer = k2_inputs(T, B, H)
    want = bigru_apply_inproj(to_jax(layer), (jnp.asarray(xa), jnp.asarray(xb)),
                              jnp.asarray(h0f), jnp.asarray(h0b), interpret=True)
    got = bigru_window_in2_plain(*(torch.from_numpy(a) for a in (xa, xb, h0f, h0b)),
                                 to_torch(layer))
    for g, w, what in zip(got, want, ("out_f", "out_b", "h_f", "h_b")):
        assert tuple(g.shape) == tuple(w.shape), what
        close(g, w, what)


@pytest.mark.parametrize("T,B,H", SHAPES)
def test_k1_plain_matches_scan_highest(T, B, H):
    from helen_tpu.models.gru import bigru_apply

    from helen_tpu_torch.ops.gru_window import bigru_window_in1_plain

    image, start, h0f, h0b, layer = k1_inputs(T, B, H, seed=2)
    x = jnp.asarray(image[:, start:start + T].transpose(1, 0, 2).astype(np.float32))
    out, hf, hb = bigru_apply(to_jax(layer), x, jnp.asarray(h0f), jnp.asarray(h0b),
                              precision=jax.lax.Precision.HIGHEST)
    of, ob, gf, gb = bigru_window_in1_plain(torch.from_numpy(image), start, T,
                                            torch.from_numpy(h0f),
                                            torch.from_numpy(h0b), to_torch(layer))
    close(torch.cat([of, ob], -1), out, "out")
    close(gf, hf, "h_f")
    close(gb, hb, "h_b")


@pytest.mark.parametrize("T,B,H", SHAPES)
def test_k2_plain_matches_scan_highest(T, B, H):
    from helen_tpu.models.gru import bigru_apply

    from helen_tpu_torch.ops.gru_window import bigru_window_in2_plain

    xa, xb, h0f, h0b, layer = k2_inputs(T, B, H, seed=3)
    out, hf, hb = bigru_apply(to_jax(layer), jnp.concatenate([xa, xb], -1),
                              jnp.asarray(h0f), jnp.asarray(h0b),
                              precision=jax.lax.Precision.HIGHEST)
    of, ob, gf, gb = bigru_window_in2_plain(
        *(torch.from_numpy(a) for a in (xa, xb, h0f, h0b)), to_torch(layer))
    close(torch.cat([of, ob], -1), out, "out")
    close(gf, hf, "h_f")
    close(gb, hb, "h_b")


def test_backward_direction_final_state_is_after_time_zero():
    """The backward scan's final state is the h it computes at t = 0, and
    its output at time t is written at t (not at T-1-t)."""
    from helen_tpu_torch.models.gru import gru_cell
    from helen_tpu_torch.ops.gru_window import bigru_window_in2_plain

    T, B, H = 4, 3, 128
    xa, xb, h0f, h0b, layer = k2_inputs(T, B, H, seed=4)
    lt = to_torch(layer)
    xa_t, xb_t = torch.from_numpy(xa), torch.from_numpy(xb)
    of, ob, hf, hb = bigru_window_in2_plain(xa_t, xb_t, torch.from_numpy(h0f),
                                            torch.from_numpy(h0b), lt)
    p = lt["bwd"]
    xp = torch.cat([xa_t, xb_t], -1) @ p["w_ih"] + p["b_ih"]
    h = torch.from_numpy(h0b)
    for t in range(T - 1, -1, -1):
        h = gru_cell(xp[t], h, p["w_hh"], p["b_hh"])
        # the concat projection sums in another order than the halves'
        torch.testing.assert_close(ob[t], h, rtol=0, atol=1e-6)
    torch.testing.assert_close(hb, ob[0], rtol=0, atol=0)
    torch.testing.assert_close(hf, of[-1], rtol=0, atol=0)


def test_wrappers_take_the_plain_version_on_cpu_and_count_no_launch():
    from helen_tpu_torch.ops import gru_window as gw

    T, B, H = 5, 8, 128
    image, start, h0f, h0b, layer = k1_inputs(T, B, H)
    lt = to_torch(layer)
    args = (torch.from_numpy(image), start, T, torch.from_numpy(h0f),
            torch.from_numpy(h0b), lt)
    gw.reset_launch_counts()
    for g, p in zip(gw.bigru_window_in1(*args), gw.bigru_window_in1_plain(*args)):
        torch.testing.assert_close(g, p, rtol=0, atol=0)
    xa, xb, h0f2, h0b2, layer2 = k2_inputs(T, B, H)
    args2 = (*(torch.from_numpy(a) for a in (xa, xb, h0f2, h0b2)), to_torch(layer2))
    for g, p in zip(gw.bigru_window_in2(*args2), gw.bigru_window_in2_plain(*args2)):
        torch.testing.assert_close(g, p, rtol=0, atol=0)
    assert gw.launch_counts == {"bigru_window_in1": 0, "bigru_window_in2": 0,
                                "bigru_window_proj_in1": 0, "bigru_window_proj_in2": 0,
                                "bigru_window_rec_smem": 0,
                                "bigru_window_in1_fast": 0, "bigru_window_in2_fast": 0,
                                "bigru_window_proj_in1_fast": 0,
                                "bigru_window_proj_in2_fast": 0, "bigru_window_rec_fast": 0,
                                "transducer_window_encdec": 0,
                                "transducer_window_encdec_fast": 0,
                                "transducer_window_encdec_cluster": 0,
                                "transducer_window_encdec_cluster_fast": 0,
                                "transducer_window_encdec_onepass": 0,
                                "transducer_window_encdec_onepass_fast": 0}


def test_wrappers_raise_off_cpu_and_cuda():
    """A tensor on a device that is neither the CPU nor CUDA is refused, not
    computed some other way."""
    from helen_tpu_torch.ops import gru_window as gw

    T, B, H = 3, 2, 128
    meta = lambda *s, dt=torch.float32: torch.empty(s, dtype=dt, device="meta")  # noqa: E731
    layer = {d: {"w_ih": meta(F, 3 * H), "w_hh": meta(H, 3 * H), "b_ih": meta(3 * H),
                 "b_hh": meta(3 * H)} for d in ("fwd", "bwd")}
    with pytest.raises(ValueError, match="CUDA or CPU"):
        gw.bigru_window_in1(meta(B, 10, F, dt=torch.uint8), 0, T, meta(B, H), meta(B, H),
                            layer)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        gw.bigru_window_in2(meta(T, B, H), meta(T, B, H), meta(B, H), meta(B, H), layer)


def test_build_targets_hopper_and_raises_without_nvcc(monkeypatch, tmp_path):
    from helen_tpu_torch.ops import library

    assert "arch=compute_90a,code=sm_90a" in library.NVCC_FLAGS
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        library.build_kernels()
