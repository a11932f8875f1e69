"""The plain reference against the port's plain route (backend "torch") at
a tiny size on the CPU: votes and labels, and one TBPTT batch."""
import os
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from benchmark.lib import data  # noqa: E402
from benchmark.reference import transducer as ref  # noqa: E402

CFG = {"hidden_size": 16, "gru_layers": 1, "input_features": 90, "num_base_classes": 5,
       "num_rle_classes": 11, "image_columns": 1000, "window": 100, "jump": 50}
TRAFFIC = {"batch": 3}


def _inputs(seed, cfg=CFG):
    gen = torch.Generator().manual_seed(seed)
    weights = data.make_params(cfg, gen, "cpu")
    images, lb, lr = data.make_images(cfg, TRAFFIC, gen, "cpu", 1)
    return weights, torch.from_numpy(images[0]), torch.from_numpy(lb[0]), torch.from_numpy(lr[0])


@pytest.mark.parametrize("layers", [1, 2])
def test_votes_and_labels_match_the_port(layers):
    from helen_tpu_torch.models.transducer import consensus_labels, consensus_probs

    cfg = {**CFG, "gru_layers": layers}
    weights, images, _, _ = _inputs(7, cfg)
    base_v, rle_v = ref.consensus_votes(weights, images, 100, 50, "fp32")
    pb, pr = consensus_probs(weights, images, backend="torch")
    torch.testing.assert_close(base_v, pb, rtol=0, atol=1e-5)
    torch.testing.assert_close(rle_v, pr, rtol=0, atol=1e-5)
    lb, lr = consensus_labels(weights, images, backend="torch")
    assert torch.equal(base_v.argmax(-1).to(torch.uint8), lb)
    assert torch.equal(rle_v.argmax(-1).to(torch.uint8), lr)


def test_one_tbptt_batch_matches_the_port():
    from helen_tpu_torch.models.transducer import param_leaves
    from helen_tpu_torch.train.train_loop import Adam, tbptt_step

    weights, images, lb, lr = _inputs(8)
    params = data.tree_to(weights, "cpu")
    for p in param_leaves(params):
        p.requires_grad_(True)
    adam = Adam()
    state = adam.init(params)
    tot, _, _ = tbptt_step(params, adam, state, 1e-4, images, lb.long(), lr.long(),
                           images.shape[0], "torch")
    ref_params = data.tree_to(weights, "cpu")
    ref_adam = ref.Adam(ref.leaves(ref_params), 1e-4)
    ref_tot = ref.tbptt_batch(ref_params, ref_adam, images, lb, lr, 100, 50, "fp32")
    assert float(tot) == pytest.approx(ref_tot, rel=1e-6)
    for p, r in zip(param_leaves(params), ref.leaves(ref_params)):
        torch.testing.assert_close(p.detach(), r, rtol=0, atol=1e-6)
    for m, r in zip(param_leaves(state["mu"]), ref_adam.mu):
        torch.testing.assert_close(m, r, rtol=1e-5, atol=1e-9)


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2 ** -10, 1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11, -3.0 - 2 ** -12])
    assert ref.tf32_round(x).tolist() == [1.0 + 2 ** -10, 1.0, 1.0 + 2 ** -9, -3.0]


def test_tf32_product_differs_from_fp32_and_has_gradients():
    gen = torch.Generator().manual_seed(0)
    a = torch.rand(8, 32, generator=gen, requires_grad=True)
    b = torch.rand(32, 4, generator=gen, requires_grad=True)
    low = ref.matmul(a, b, "tf32")
    assert 0 < float((low - a @ b).detach().abs().max()) < 1e-2
    ga, gb = torch.autograd.grad(low.sum(), (a, b))
    torch.testing.assert_close(ga, torch.ones(8, 4) @ b.detach().T, rtol=1e-2, atol=1e-2)
    assert gb.shape == b.shape
