"""helen_tpu_torch.models.transducer against helen_tpu's ``xla`` backend.

``forward`` and ``consensus_probs`` on the port's plain route (CPU, fp32) are
held against helen_tpu's lax.scan path at HIGHEST precision on the same
numpy-seeded weights and uint8 images, and the per-image labels of the three
golden geometries equal the labels recorded by the reference torch code.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_fixtures import FIXTURES, golden, stage_golden_images

torch.set_num_threads(2)

HIGHEST = jax.lax.Precision.HIGHEST
# both sides fp32 on the CPU, sums in other orders; votes are sums of 19
# softmaxes (tests/test_model_parity.py holds the reference at these)
ATOL, VOTE_ATOL = 2e-5, 1e-4


def random_params(h, layers, seed):
    from helen_tpu.config import ModelConfig
    from helen_tpu.models.transducer import init_params

    p = init_params(jax.random.PRNGKey(seed), ModelConfig(hidden_size=h, gru_layers=layers))
    return jax.tree_util.tree_map(np.asarray, p)


def both(params_np):
    from helen_tpu_torch.io.checkpoint import params_to_torch

    return jax.tree_util.tree_map(jnp.asarray, params_np), params_to_torch(params_np, "cpu")


GEOMS = [(128, 1), (128, 2), (160, 1)]


@pytest.mark.parametrize("h,layers", GEOMS)
def test_forward_matches_xla(h, layers):
    from helen_tpu.models.transducer import forward as jax_forward

    from helen_tpu_torch.models.transducer import forward

    jp, tp = both(random_params(h, layers, seed=h + layers))
    rng = np.random.default_rng(h * layers)
    B, L, W, start = 3, 40, 24, 9
    image = rng.integers(0, 40, size=(B, L, 90), dtype=np.uint8)
    hidden = rng.uniform(-1, 1, (B, 2 * layers, h)).astype(np.float32)
    jb, jr, jh = jax_forward(jp, jnp.asarray(image[:, start:start + W], jnp.float32),
                             jnp.asarray(hidden), precision=HIGHEST, backend="xla")
    tb, tr, th = forward(tp, torch.from_numpy(image), torch.from_numpy(hidden),
                         backend="torch", start=start, window=W)
    for got, want, what in ((tb, jb, "base"), (tr, jr, "rle"), (th, jh, "hidden")):
        assert tuple(got.shape) == tuple(want.shape), what
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0,
                                   err_msg=what)


@pytest.mark.parametrize("h,layers", GEOMS)
def test_consensus_probs_match_xla(h, layers):
    from helen_tpu.config import WindowConfig as JaxWindow
    from helen_tpu.models.transducer import consensus_probs as jax_probs

    from helen_tpu_torch.config import WindowConfig
    from helen_tpu_torch.models.transducer import consensus_labels, consensus_probs

    jp, tp = both(random_params(h, layers, seed=7 * h + layers))
    rng = np.random.default_rng(3 + layers)
    images = rng.integers(0, 40, size=(2, 120, 90), dtype=np.uint8)
    jb, jr = jax_probs(jp, jnp.asarray(images, jnp.float32), JaxWindow(window=30, jump=15),
                       precision=HIGHEST, backend="xla")
    win = WindowConfig(window=30, jump=15)
    tb, tr = consensus_probs(tp, torch.from_numpy(images), win, backend="torch")
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), atol=VOTE_ATOL, rtol=0)
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), atol=VOTE_ATOL, rtol=0)
    lb, lr = consensus_labels(tp, torch.from_numpy(images), win, backend="torch")
    assert lb.dtype == torch.uint8 and lr.dtype == torch.uint8
    np.testing.assert_array_equal(lb.numpy(), tb.argmax(-1).numpy())


def test_argmax_takes_the_first_max():
    """Tied votes resolve to the lowest class, as jnp.argmax does."""
    from helen_tpu_torch.config import WindowConfig
    from helen_tpu_torch.models import transducer

    p = random_params(128, 1, seed=0)
    for head in ("base_head", "rle_head"):  # zero heads: every class ties
        p[head] = {k: np.zeros_like(v) for k, v in p[head].items()}
    _, tp = both(p)
    images = torch.zeros((2, 60, 90), dtype=torch.uint8)
    lb, lr = transducer.consensus_labels(tp, images, WindowConfig(window=20, jump=10))
    assert not lb.any() and not lr.any()


@pytest.mark.parametrize("fixture", sorted(FIXTURES))
def test_labels_equal_the_recorded_golden_labels(fixture, tmp_path):
    from helen_tpu_torch.infer.consensus import ConsensusStep
    from helen_tpu_torch.io.checkpoint import load_model_any
    from helen_tpu_torch.io.images import MarginPolishDataset

    ckpt, labels, _ = FIXTURES[fixture]
    d = stage_golden_images(tmp_path)
    ds = MarginPolishDataset([f"{d}/golden_images.h5"])
    recs = [ds.load(i) for i in range(len(ds))]
    params, _ = load_model_any(golden(ckpt))
    base, rle = ConsensusStep(params, "cpu")(np.stack([r.image for r in recs]))
    want = np.load(golden(labels))
    keys = sorted(k[len("base/"):] for k in want.files if k.startswith("base/"))
    got = {f"{r.contig}-{r.contig_start}-{r.contig_end}-{r.chunk_id}": j
           for j, r in enumerate(recs)}
    assert sorted(got) == keys
    for k in keys:
        np.testing.assert_array_equal(base[got[k]], want[f"base/{k}"], err_msg=k)
        np.testing.assert_array_equal(rle[got[k]], want[f"rle/{k}"], err_msg=k)


def test_geometry_and_hidden_layout():
    from helen_tpu_torch.models.transducer import init_hidden, model_geometry

    _, tp = both(random_params(160, 2, seed=1))
    g = model_geometry(tp)
    assert (g.hidden_size, g.gru_layers, g.input_features) == (160, 2, 90)
    assert (g.num_base_classes, g.num_rle_classes) == (5, 11)
    assert tuple(init_hidden(4, g).shape) == (4, 4, 160)


def test_resolve_backend():
    from helen_tpu_torch.models.transducer import resolve_backend

    cpu = torch.device("cpu")
    assert resolve_backend(None, cpu) == "torch"
    assert resolve_backend("auto", cpu) == "torch"
    assert resolve_backend("torch", cpu) == "torch"
    with pytest.raises(ValueError, match="needs a CUDA device"):
        resolve_backend("cuda", cpu)
    # helen_tpu's inference backend names (helen_tpu/cli.py:34-36); none
    # changes the device
    assert resolve_backend("xla", cpu) == "torch"
    assert resolve_backend("pallas", cpu) == "torch"
    assert resolve_backend("pallas", torch.device("cuda")) == "cuda"
    assert resolve_backend("pallas_fast", cpu) == "torch_fast"
    with pytest.raises(ValueError, match="not one of"):
        resolve_backend("pallas_train", cpu)


def _meta_params(h):
    """A param tree of hidden size ``h`` with shapes only (no storage)."""
    def stack(d_in):
        return {d: {"w_ih": torch.empty(d_in, 3 * h, device="meta"),
                    "w_hh": torch.empty(h, 3 * h, device="meta")} for d in ("fwd", "bwd")}

    return {"encoder": stack(90), "decoder": stack(2 * h),
            "base_head": {"w": torch.empty(2 * h, 5, device="meta")},
            "rle_head": {"w": torch.empty(2 * h, 11, device="meta")}}


@pytest.mark.parametrize("h", [1056, 1152, 2048])
def test_resolve_backend_refuses_past_the_kernels_maximum(monkeypatch, h):
    """Past H=1024 every backend that picks a kernel on a CUDA device
    (``auto``, ``fast`` and helen_tpu's ``pallas`` / ``pallas_fast`` as well
    as ``cuda``), in both kinds, resolves to the xp route's kernels: the
    route has no fixed cap (its chain design takes fewer rows per block as
    H grows). ``resolve_backend`` refuses, naming ``--backend torch``,
    only past what the card's shared memory holds at one row (the H100's
    limits set by hand: 29,056 for K3, 14,528 for K3f, 11,622 for K4's
    pass 1, which only training runs), before any work. The plain
    versions run on the card only when asked for, and resolving a backend
    leaves the process's TF32 setting alone. The device is only named:
    nothing runs on it."""
    from helen_tpu_torch.models.transducer import engaged_kernel, resolve_backend
    from helen_tpu_torch.ops import library

    monkeypatch.setattr(library, "_card", {0: (132, 232_448)})
    cuda = torch.device("cuda")
    wide = _meta_params(h)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    for requested, kind, want in [(None, "infer", "cuda"), ("auto", "infer", "cuda"),
                                  ("pallas", "infer", "cuda"), ("fast", "infer", "cuda_fast"),
                                  ("pallas_fast", "infer", "cuda_fast"),
                                  ("cuda", "infer", "cuda"), ("cuda_fast", "infer", "cuda_fast"),
                                  (None, "train", "cuda"), ("auto", "train", "cuda"),
                                  ("cuda", "train", "cuda"), ("pallas_train", "train", "cuda")]:
        got = resolve_backend(requested, cuda, wide, kind=kind)
        assert got == want
        assert engaged_kernel(wide, got) == want + "_xp"
    for requested, kind, want in [("torch", "infer", "torch"), ("xla", "infer", "torch"),
                                  ("torch_fast", "infer", "torch_fast"),
                                  ("torch", "train", "torch"), ("xla", "train", "torch")]:
        assert resolve_backend(requested, cuda, wide, kind=kind) == want
        assert engaged_kernel(wide, want) == want
    assert torch.backends.cuda.matmul.allow_tf32 == tf32
    # the CPU keeps its plain versions whatever the width
    assert resolve_backend("auto", torch.device("cpu"), wide) == "torch"
    # the kernels' maximum on the card: at its widest kernel width each
    # surface resolves to the kernels, one unit wider it refuses, and the
    # plain versions take any width
    for widest, requested, kind, plain in ((29_056, "pallas", "infer", "torch"),
                                           (14_528, "pallas_fast", "infer", "torch_fast"),
                                           (11_622, "pallas_train", "train", "torch")):
        assert resolve_backend(requested, cuda, _meta_params(widest), kind=kind).startswith(
            "cuda")
        with pytest.raises(ValueError, match="use --backend torch"):
            resolve_backend(requested, cuda, _meta_params(widest + 1), kind=kind)
        assert resolve_backend(plain, cuda, _meta_params(widest + 1), kind=kind) == plain
    # a width the parity forward takes and the backward does not: inference
    # runs it on the kernels, training is refused
    assert resolve_backend("auto", cuda, _meta_params(11_623)) == "cuda"
    with pytest.raises(ValueError, match="use --backend torch"):
        resolve_backend("auto", cuda, _meta_params(11_623), kind="train")