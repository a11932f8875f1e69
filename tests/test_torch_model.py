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


def test_resolve_backend_refuses_past_the_kernels_maximum():
    """Past XP_MAX_H every backend that would pick a kernel on a CUDA
    device (``auto``, ``fast`` and helen_tpu's ``pallas`` / ``pallas_fast``
    as well as ``cuda``), in both kinds, raises naming ``--backend torch``:
    the port does not take helen_tpu's quiet fallback to its plain route on
    the card. The plain versions run there only when asked for, and
    resolving a backend leaves the process's TF32 setting alone. The
    device is only named: nothing runs on it."""
    from helen_tpu_torch.models.transducer import XP_MAX_H, engaged_kernel, resolve_backend

    cuda = torch.device("cuda")
    wide = _meta_params(1056)
    assert 1056 > XP_MAX_H
    tf32 = torch.backends.cuda.matmul.allow_tf32
    for requested, kind in [(None, "infer"), ("auto", "infer"), ("pallas", "infer"),
                            ("fast", "infer"), ("pallas_fast", "infer"), ("cuda", "infer"),
                            ("cuda_fast", "infer"), (None, "train"), ("auto", "train"),
                            ("cuda", "train"), ("pallas_train", "train")]:
        with pytest.raises(ValueError, match="maximum 1024 .*use --backend torch"):
            resolve_backend(requested, cuda, wide, kind=kind)
    for requested, kind, want in [("torch", "infer", "torch"), ("xla", "infer", "torch"),
                                  ("torch_fast", "infer", "torch_fast"),
                                  ("torch", "train", "torch"), ("xla", "train", "torch")]:
        assert resolve_backend(requested, cuda, wide, kind=kind) == want
        assert engaged_kernel(wide, want) == want
    assert torch.backends.cuda.matmul.allow_tf32 == tf32
    # at the kernels' maximum the kernels are picked
    assert resolve_backend("auto", cuda, _meta_params(XP_MAX_H)) == "cuda"
    assert resolve_backend("fast", cuda, _meta_params(XP_MAX_H)) == "cuda_fast"
    # the CPU keeps its plain versions whatever the width
    assert resolve_backend("auto", torch.device("cpu"), wide) == "torch"
