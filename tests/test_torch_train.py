"""The port's training path against helen_tpu's, on the CPU.

Inputs are made with numpy from a seed and handed to both packages. Each
comparison states its tolerance:

* losses: rtol 1e-6 (the same log-softmax sums in float32);
* the plain backward against helen_tpu's Pallas ``_bwd_kernel_ip`` in
  interpret mode: rtol 1e-4, atol 1e-5, as tests/test_pallas.py holds the
  train kernels against the scan (sums over T*B rows in another order);
* one window's gradients through the port's autograd Functions against
  ``jax.grad`` of helen_tpu's ``forward``: rtol 1e-4, atol 1e-5;
* one TBPTT batch and one Trainer epoch: loss sums 1e-5 relative, params
  and Adam state 2e-5 absolute (19 chained Adam updates of float32 values
  whose gradients differ in their last bits).

The kernels themselves run on a CUDA device only (tests/test_torch_cuda.py
and chip_smoke.py); here the wrappers take their plain versions.
"""
import csv
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

RLE_W = (0.3, 0.5, 0.5, 0.5, 0.5, 0.8, 0.9, 1.0, 1.0, 1.0, 0.9)


def make_layer(rng, d, h, w_ih_scale=1.0):
    k = 1.0 / np.sqrt(h)
    u = lambda *s: rng.uniform(-k, k, s).astype(np.float32)  # noqa: E731
    return {dr: {"w_ih": u(d, 3 * h) * np.float32(w_ih_scale), "w_hh": u(h, 3 * h),
                 "b_ih": u(3 * h), "b_hh": u(3 * h)} for dr in ("fwd", "bwd")}


def to_torch(tree, requires_grad=False):
    from helen_tpu_torch.io.checkpoint import params_to_torch

    t = params_to_torch(tree, "cpu")
    if requires_grad:
        from helen_tpu_torch.models.transducer import param_leaves

        for p in param_leaves(t):
            p.requires_grad_(True)
    return t


def fresh_params(hidden, layers=1, seed=0):
    """A numpy param tree from the port's init_params."""
    from helen_tpu_torch.config import MODEL
    from helen_tpu_torch.io.checkpoint import flatten_tree, unflatten_tree
    from helen_tpu_torch.models.transducer import init_params

    cfg = dataclasses.replace(MODEL, hidden_size=hidden, gru_layers=layers)
    return unflatten_tree(flatten_tree(init_params(torch.Generator().manual_seed(seed), cfg)))


def assert_trees_close(got, want, atol, rtol=0.0):
    from helen_tpu_torch.io.checkpoint import flatten_tree

    g, w = flatten_tree(got), flatten_tree(want)
    assert sorted(g) == sorted(w)
    for k in g:
        np.testing.assert_allclose(g[k], np.asarray(w[k]), atol=atol, rtol=rtol, err_msg=k)


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("which", ["ce", "weighted_ce", "masked_parts",
                                   "masked_weighted_parts"])
def test_losses_match_helen_tpu(which):
    from helen_tpu.train import loss as jl

    from helen_tpu_torch.train import loss as tl

    rng = np.random.default_rng(7)
    B, W = 5, 9
    base = rng.standard_normal((B, W, 5)).astype(np.float32)
    rle = rng.standard_normal((B, W, 11)).astype(np.float32)
    yb = rng.integers(0, 5, (B, W)).astype(np.int32)
    yr = rng.integers(0, 11, (B, W)).astype(np.int32)
    mask = (np.arange(B) < 3).astype(np.float32)
    w = np.asarray(RLE_W, dtype=np.float32)
    J, T = jnp.asarray, torch.from_numpy
    if which == "ce":
        want, got = [jl.cross_entropy(J(base), J(yb))], [tl.cross_entropy(T(base), T(yb))]
    elif which == "weighted_ce":
        want = [jl.weighted_cross_entropy(J(rle), J(yr), J(w))]
        got = [tl.weighted_cross_entropy(T(rle), T(yr), T(w))]
    elif which == "masked_parts":
        want = jl.masked_cross_entropy_parts(J(base), J(yb), J(mask))
        got = tl.masked_cross_entropy_parts(T(base), T(yb), T(mask))
    else:
        want = jl.masked_weighted_cross_entropy_parts(J(rle), J(yr), J(w), J(mask))
        got = tl.masked_weighted_cross_entropy_parts(T(rle), T(yr), T(w), T(mask))
    for g, v in zip(got, want):
        np.testing.assert_allclose(float(g), float(v), rtol=1e-6)


def test_loss_denominators_are_the_parts():
    """The denominators alone (what a data-parallel step sums over the
    processes before dividing) are the ``*_parts`` ones bit for bit, and
    the two halves of a batch add up to the whole batch's."""
    from helen_tpu_torch.train import loss as tl

    rng = np.random.default_rng(8)
    B, W = 6, 9
    base = torch.from_numpy(rng.standard_normal((B, W, 5)).astype(np.float32))
    rle = torch.from_numpy(rng.standard_normal((B, W, 11)).astype(np.float32))
    yb = torch.from_numpy(rng.integers(0, 5, (B, W)))
    yr = torch.from_numpy(rng.integers(0, 11, (B, W)))
    mask = (torch.arange(B) < 5).to(torch.float32)
    w = torch.tensor(RLE_W, dtype=torch.float32)
    assert torch.equal(tl.masked_denominator(yb, mask),
                       tl.masked_cross_entropy_parts(base, yb, mask)[1])
    assert torch.equal(tl.masked_weighted_denominator(yr, w, mask),
                       tl.masked_weighted_cross_entropy_parts(rle, yr, w, mask)[1])
    halves = [slice(0, 3), slice(3, B)]
    assert float(sum(tl.masked_denominator(yb[h], mask[h]) for h in halves)) == 45.0
    np.testing.assert_allclose(
        float(sum(tl.masked_weighted_denominator(yr[h], w, mask[h]) for h in halves)),
        float(tl.masked_weighted_denominator(yr, w, mask)), rtol=1e-6)


# ---------------------------------------------------------------------------
# the backward: plain version, autograd Functions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["image_d90", "pair_d256"])
def test_plain_backward_matches_pallas_bwd_ip_interpret(kind):
    """The plain backward against ``fused_bigru_window_train_bwd_ip(...,
    interpret=True)`` at H=128, with nonzero h0, dout and final-state
    cotangents (a zero cotangent would hide an off-by-one in the h_prev
    shift). helen_tpu pads D to a multiple of 128; its pad rows and
    columns are sliced away."""
    from helen_tpu.ops.gru_pallas_train import fused_bigru_window_train_bwd_ip

    from helen_tpu_torch.ops.gru_window import (
        bigru_window_in1_plain,
        bigru_window_in2_plain,
    )
    from helen_tpu_torch.ops.gru_window_bwd import bigru_window_bwd_plain, window_input

    rng = np.random.default_rng(11)
    T, B, H = 5, 8, 128
    r = lambda *s: rng.uniform(-1, 1, s).astype(np.float32)  # noqa: E731
    h0f, h0b, dhf, dhb = (r(B, H) for _ in range(4))
    dof, dob = r(T, B, H), r(T, B, H)
    if kind == "image_d90":
        D, start = 90, 3
        # small counts keep the weight sums at the scale of the unit-range
        # inputs tests/test_pallas.py uses for this tolerance
        image = rng.integers(0, 3, (B, T + 6, D), dtype=np.uint8)
        layer = make_layer(rng, D, H)
        src = torch.from_numpy(image)
        fwd = bigru_window_in1_plain
        fwd_args = (src, start, T)
    else:
        D, start = 2 * H, 0
        src = (torch.from_numpy(r(T, B, H)), torch.from_numpy(r(T, B, H)))
        layer = make_layer(rng, D, H)
        fwd = bigru_window_in2_plain
        fwd_args = src
    lt = to_torch(layer)
    of, ob, _, _ = fwd(*fwd_args, torch.from_numpy(h0f), torch.from_numpy(h0b), lt)
    T_ = torch.from_numpy
    dx, dh0f, dh0b, g = bigru_window_bwd_plain(
        src, start, T_(h0f), T_(h0b), of, ob, T_(dof), T_(dob), T_(dhf), T_(dhb),
        lt, need_dx=True)

    Dp = -(-D // 128) * 128
    x = window_input(src, start, T, torch.float32).numpy()
    x = np.pad(x, ((0, 0), (0, 0), (0, Dp - D)))
    pad = lambda w: jnp.asarray(np.pad(w, ((0, Dp - D), (0, 0))))  # noqa: E731
    f, b = layer["fwd"], layer["bwd"]
    row = lambda v: jnp.asarray(v.reshape(1, -1))  # noqa: E731
    want = fused_bigru_window_train_bwd_ip(
        jnp.asarray(x), jnp.asarray(of.numpy()), jnp.asarray(ob.numpy()),
        jnp.asarray(h0f), jnp.asarray(h0b), jnp.asarray(dof), jnp.asarray(dob),
        jnp.asarray(dhf), jnp.asarray(dhb), pad(f["w_ih"]), pad(b["w_ih"]),
        jnp.asarray(f["w_hh"]), jnp.asarray(b["w_hh"]), row(f["b_ih"]), row(b["b_ih"]),
        row(f["b_hh"]), row(b["b_hh"]), interpret=True)
    (wdx, wdh0f, wdh0b, dwi_f, dwi_b, dbi_f, dbi_b, dw_f, dw_b, db_f, db_b) = (
        np.asarray(a) for a in want)
    close = lambda a, w, what: np.testing.assert_allclose(  # noqa: E731
        a.detach().numpy(), w, rtol=1e-4, atol=1e-5, err_msg=what)
    close(dx, wdx[..., :D], "dx")
    close(dh0f, wdh0f, "dh0_f")
    close(dh0b, wdh0b, "dh0_b")
    for d, (dwi, dbi, dw, db) in (("fwd", (dwi_f, dbi_f, dw_f, db_f)),
                                  ("bwd", (dwi_b, dbi_b, dw_b, db_b))):
        close(g[d]["w_ih"], dwi[:D], f"{d}.w_ih")
        close(g[d]["b_ih"], dbi[0], f"{d}.b_ih")
        close(g[d]["w_hh"], dw, f"{d}.w_hh")
        close(g[d]["b_hh"], db[0], f"{d}.b_hh")


@pytest.mark.parametrize("layers", [1, 2])
def test_window_gradients_match_jax_grad(layers):
    """One window of the transducer through the port's autograd Functions
    (backend "cuda": on CPU tensors they compute the plain forward and
    backward) against ``jax.grad`` of helen_tpu's ``forward(backend="xla")``:
    the loss reaches every output (both heads and the new hidden) and the
    gradients every param and the carried hidden."""
    from helen_tpu.models.transducer import forward as jforward

    from helen_tpu_torch.io.checkpoint import flatten_tree, unflatten_tree
    from helen_tpu_torch.models.transducer import forward, param_leaves

    rng = np.random.default_rng(20 + layers)
    B, W, H = 3, 12, 32
    params = fresh_params(H, layers, seed=layers)
    image = rng.integers(0, 12, (B, W, 90), dtype=np.uint8)
    hidden = rng.uniform(-1, 1, (B, 2 * layers, H)).astype(np.float32)
    wb, wr = rng.standard_normal((B, W, 5)), rng.standard_normal((B, W, 11))
    wh = rng.standard_normal((B, 2 * layers, H))

    def jloss(p, h):
        base, rle, hn = jforward(p, jnp.asarray(image, jnp.float32), h, backend="xla")
        return (jnp.sum(base * wb) + jnp.sum(rle * wr) + jnp.sum(hn * wh)) / B

    jp = jax.tree_util.tree_map(jnp.asarray, params)
    want_p, want_h = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(hidden))

    tp = to_torch(params, requires_grad=True)
    th = torch.from_numpy(hidden).requires_grad_(True)
    base, rle, hn = forward(tp, torch.from_numpy(image), th, backend="cuda")
    loss = ((base * torch.from_numpy(wb).float()).sum()
            + (rle * torch.from_numpy(wr).float()).sum()
            + (hn * torch.from_numpy(wh).float()).sum()) / B
    loss.backward()
    # param_leaves and flatten_tree both walk the tree in sorted key order
    got = unflatten_tree(dict(zip(flatten_tree(params),
                                  (p.grad.numpy() for p in param_leaves(tp)))))
    assert_trees_close(got, jax.tree_util.tree_map(np.asarray, want_p),
                       atol=1e-5, rtol=1e-4)
    np.testing.assert_allclose(th.grad.numpy(), np.asarray(want_h), atol=1e-5, rtol=1e-4)


@pytest.mark.parametrize("kind", ["image", "pair"])
def test_window_functions_pass_gradcheck(kind):
    """``torch.autograd.gradcheck`` of each Function in float64 at tiny
    sizes: the plain backward is the exact derivative of the plain
    forward."""
    from helen_tpu_torch.ops.gru_window_autograd import (
        flat_layer,
        tree_layer,
        window_in1,
        window_in2,
    )

    rng = np.random.default_rng(3)
    T, B, H = 3, 2, 3
    t = lambda *s: torch.tensor(rng.uniform(-1, 1, s), dtype=torch.float64,  # noqa: E731
                                requires_grad=True)
    h0 = (t(B, H), t(B, H))
    if kind == "image":
        image = torch.tensor(rng.uniform(0, 2, (B, T + 2, 4)), dtype=torch.float64)
        ws = flat_layer({d: {"w_ih": t(4, 3 * H), "w_hh": t(H, 3 * H), "b_ih": t(3 * H),
                             "b_hh": t(3 * H)} for d in ("fwd", "bwd")})
        fn = lambda *a: window_in1(image, 1, T, a[0], a[1], tree_layer(a[2:]))  # noqa: E731
        inputs = (*h0, *ws)
    else:
        ws = flat_layer({d: {"w_ih": t(2 * H, 3 * H), "w_hh": t(H, 3 * H),
                             "b_ih": t(3 * H), "b_hh": t(3 * H)} for d in ("fwd", "bwd")})
        fn = lambda *a: window_in2(a[0], a[1], a[2], a[3], tree_layer(a[4:]))  # noqa: E731
        inputs = (t(T, B, H), t(T, B, H), *h0, *ws)
    assert torch.autograd.gradcheck(fn, inputs)


# ---------------------------------------------------------------------------
# the TBPTT step, Adam, the scheduler, the Trainer
# ---------------------------------------------------------------------------

def _jax_opt_leaves(opt_state):
    """optax's state leaves: count, then mu, then nu (an empty first element
    for the weight-decay chain has no leaves)."""
    return [np.asarray(a) for a in jax.tree_util.tree_leaves(opt_state)]


@pytest.mark.parametrize("wd", [0.0, 1e-3])
def test_tbptt_batch_matches_build_tbptt_fn(wd):
    """One batch of truncated BPTT (3 windows of 100 at L=200, a padded row)
    against helen_tpu's ``build_tbptt_fn(backend="xla")`` from the same
    params and a fresh Adam state."""
    from helen_tpu.train.train_loop import build_tbptt_fn, make_optimizer

    from helen_tpu_torch.io.checkpoint import opt_leaves
    from helen_tpu_torch.models.transducer import param_leaves
    from helen_tpu_torch.train.train_loop import Adam, tbptt_step

    rng = np.random.default_rng(5)
    # lr 1e-4, the reference's default: Adam divides each gradient by its
    # own magnitude, so an element whose gradient is near zero moves by up
    # to lr whatever its last bits; the 2e-5 bound holds at this step size
    B, L, valid, H, lr = 4, 200, 3, 16, 1e-4
    params = fresh_params(H, seed=9)
    images = rng.integers(0, 20, (B, L, 90), dtype=np.uint8)
    yb = rng.integers(0, 5, (B, L)).astype(np.int32)
    yr = rng.integers(0, 11, (B, L)).astype(np.int32)

    tx = make_optimizer(wd)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    fn = jax.jit(build_tbptt_fn(tx, image_len=L, backend="xla"))
    jp, jopt, *jtot = fn(jp, tx.init(jp), jnp.float32(lr), jnp.asarray(images),
                         jnp.asarray(yb), jnp.asarray(yr), valid)

    tp = to_torch(params, requires_grad=True)
    adam = Adam(wd)
    state = adam.init(tp)
    tot = tbptt_step(tp, adam, state, lr, torch.from_numpy(images),
                     torch.from_numpy(yb).long(), torch.from_numpy(yr).long(),
                     valid, "torch")
    for g, w in zip(tot, jtot):
        np.testing.assert_allclose(float(g), float(w), rtol=1e-5)
    got = [p.detach().numpy() for p in param_leaves(tp)]
    for g, w in zip(got, jax.tree_util.tree_leaves(jp)):
        np.testing.assert_allclose(g, np.asarray(w), atol=2e-5)
    got_opt, want_opt = opt_leaves(state), _jax_opt_leaves(jopt)
    assert len(got_opt) == len(want_opt) == 1 + 2 * len(got)
    assert int(got_opt[0]) == int(want_opt[0]) == 3
    for g, w in zip(got_opt[1:], want_opt[1:]):
        np.testing.assert_allclose(g, w, atol=2e-5)


def test_plateau_scheduler_matches_helen_tpu():
    from helen_tpu.train.train_loop import PlateauScheduler as J

    from helen_tpu_torch.train.train_loop import PlateauScheduler as P

    a, b = J(lr=1.0, factor=0.5, patience=2), P(lr=1.0, factor=0.5, patience=2)
    for m in [1.0, 0.9, 0.8, 0.85, 0.85, 0.85, 0.4, 0.41, 0.4, 0.4, 0.4, 0.3]:
        assert a.step(m) == b.step(m)
        assert a.state_dict() == b.state_dict()


@pytest.fixture(scope="module")
def labeled_dirs(tmp_path_factory):
    from helen_tpu_torch.io.synthetic import random_sequence, write_image_file

    root = tmp_path_factory.mktemp("torch_train_data")
    for name, bp, seed in (("train", 15000, 31), ("test", 4000, 32)):
        os.makedirs(root / name)
        write_image_file(str(root / name / f"{name}.h5"),
                         {f"c_{name}": random_sequence(bp, seed=seed)},
                         region_cols=1000, overlap_cols=0, noise=0.05, seed=seed + 10)
    return str(root / "train"), str(root / "test")


def _trainers(labeled_dirs, tmp_path, start_ckpt, seed=4, lr=1e-4, batch=4):
    """helen_tpu's Trainer and the port's, both from ``start_ckpt``."""
    from helen_tpu.config import TRAIN as JTRAIN
    from helen_tpu.train.train_loop import Trainer as JTrainer
    from helen_tpu.utils.filesystem import list_image_files

    from helen_tpu_torch.config import TRAIN
    from helen_tpu_torch.train.train_loop import Trainer

    train_dir, test_dir = labeled_dirs
    files = list_image_files(train_dir), list_image_files(test_dir)
    jt = JTrainer(*files, cfg=dataclasses.replace(JTRAIN, batch_size=batch,
                                                  learning_rate=lr, seed=seed),
                  model_dir=str(tmp_path / "j" / "models"),
                  stats_dir=str(tmp_path / "j" / "stats"), num_workers=2,
                  retrain_model_path=start_ckpt, data_parallel=False)
    pt = Trainer(*files, cfg=dataclasses.replace(TRAIN, batch_size=batch,
                                                 learning_rate=lr, seed=seed),
                 model_dir=str(tmp_path / "p" / "models"),
                 stats_dir=str(tmp_path / "p" / "stats"), num_workers=2,
                 retrain_model_path=start_ckpt, device="cpu")
    return jt, pt


def _rows(path):
    with open(path) as f:
        return [[float(v) for v in row] for row in csv.reader(f)]


def test_trainer_epoch_matches_helen_tpu(labeled_dirs, tmp_path):
    """One epoch of the port's Trainer against helen_tpu's (one process, no
    data parallelism), both resumed from the same H=32 ``.npz``: the same
    data order, CSV rows, test loss and final checkpoints (params, Adam
    state, scheduler)."""
    from helen_tpu.io.checkpoint import load_checkpoint as jload
    from helen_tpu.train.train_loop import make_optimizer

    from helen_tpu_torch.io.checkpoint import load_checkpoint, opt_leaves, save_checkpoint

    start = str(tmp_path / "start.npz")
    save_checkpoint(start, fresh_params(32, seed=12), meta={"epochs": 0})
    jt, pt = _trainers(labeled_dirs, tmp_path, start)
    assert pt._epoch_indices(0) == jt._epoch_indices(0)
    jh, ph = jt.run(1), pt.run(1)
    np.testing.assert_allclose(ph[0].train_loss, jh[0].train_loss, rtol=1e-5)
    np.testing.assert_allclose(ph[0].test_loss, jh[0].test_loss, rtol=1e-5)
    assert ph[0].base_accuracy == jh[0].base_accuracy
    assert ph[0].rle_accuracy == jh[0].rle_accuracy
    for name in ("train_loss.csv", "test_loss.csv"):
        got, want = (_rows(tmp_path / w / "stats" / name) for w in ("p", "j"))
        assert len(got) == len(want) > 0
        for g, w in zip(got, want):
            assert g[0] == w[0]
            np.testing.assert_allclose(g[1:], w[1:], rtol=1e-5)
    ckpt = "HELEN_epoch_1_checkpoint.npz"
    gp, gmeta, gopt = load_checkpoint(str(tmp_path / "p" / "models" / ckpt), with_opt_state=True)
    wp, wmeta, wopt = jload(str(tmp_path / "j" / "models" / ckpt),
                            lambda p: make_optimizer(0.0).init(p))
    assert_trees_close(gp, wp, atol=2e-5)
    assert gmeta["epochs"] == wmeta["epochs"] == 1
    gs, ws = gmeta["scheduler"], wmeta["scheduler"]
    assert (gs["lr"], gs["num_bad"]) == (ws["lr"], ws["num_bad"])
    np.testing.assert_allclose(gs["best"], ws["best"], rtol=1e-5)  # the test loss
    got, want = opt_leaves(gopt), _jax_opt_leaves(wopt)
    assert int(got[0]) == int(want[0]) > 0
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g, w, atol=2e-5)


def test_port_checkpoint_restores_in_helen_tpu(tmp_path):
    """Adam state the port writes loads in helen_tpu through
    ``load_checkpoint(path, tx.init)`` with equal count, mu and nu."""
    from helen_tpu.io.checkpoint import load_checkpoint as jload
    from helen_tpu.train.train_loop import make_optimizer

    from helen_tpu_torch.io.checkpoint import opt_leaves, opt_state_to_numpy, save_checkpoint
    from helen_tpu_torch.train.train_loop import Adam, tbptt_step

    rng = np.random.default_rng(2)
    tp = to_torch(fresh_params(8, layers=2, seed=3), requires_grad=True)
    adam = Adam(1e-3)
    state = adam.init(tp)
    tbptt_step(tp, adam, state, 1e-3, torch.from_numpy(rng.integers(0, 9, (2, 150, 90),
                                                                    dtype=np.uint8)),
               torch.from_numpy(rng.integers(0, 5, (2, 150))),
               torch.from_numpy(rng.integers(0, 11, (2, 150))), 2, "torch")
    path = str(tmp_path / "port.npz")
    save_checkpoint(path, tp, meta={"epochs": 1}, opt_state=state)
    params, meta, jopt = jload(path, lambda p: make_optimizer(1e-3).init(p))
    assert meta["epochs"] == 1
    want = opt_leaves(opt_state_to_numpy(state))
    got = _jax_opt_leaves(jopt)
    assert len(got) == len(want) and int(got[0]) == 2
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_helen_tpu_checkpoint_resumes_in_port_trainer(labeled_dirs, tmp_path):
    """A checkpoint helen_tpu writes (params, Adam state after a step,
    scheduler state, mid-epoch batch) resumes in the port's Trainer with
    the same state."""
    from helen_tpu.io.checkpoint import save_checkpoint as jsave
    from helen_tpu.train.train_loop import build_tbptt_fn, make_optimizer

    from helen_tpu_torch.io.checkpoint import opt_leaves
    from helen_tpu_torch.models.transducer import param_leaves
    from helen_tpu_torch.train.train_loop import Trainer

    rng = np.random.default_rng(8)
    tx = make_optimizer(0.0)
    jp = jax.tree_util.tree_map(jnp.asarray, fresh_params(16, seed=5))
    fn = jax.jit(build_tbptt_fn(tx, image_len=150, backend="xla"))
    jp, jopt, *_ = fn(jp, tx.init(jp), jnp.float32(1e-3),
                      jnp.asarray(rng.integers(0, 9, (2, 150, 90), dtype=np.uint8)),
                      jnp.asarray(rng.integers(0, 5, (2, 150)).astype(np.int32)),
                      jnp.asarray(rng.integers(0, 11, (2, 150)).astype(np.int32)), 2)
    sched = {"lr": 1e-4, "best": 0.5, "num_bad": 3}
    path = str(tmp_path / "jax.npz")
    jsave(path, jp, meta={"epochs": 2, "batch_in_epoch": 1, "scheduler": sched},
          opt_state=jopt)
    train_dir, test_dir = labeled_dirs
    pt = Trainer([os.path.join(train_dir, "train.h5")], [os.path.join(test_dir, "test.h5")],
                 model_dir=str(tmp_path / "m"), stats_dir=str(tmp_path / "s"),
                 retrain_model_path=path, device="cpu")
    assert (pt.start_epoch, pt.start_batch) == (2, 1)
    assert pt.scheduler.state_dict() == sched
    for g, w in zip(param_leaves(pt.params), jax.tree_util.tree_leaves(jp)):
        np.testing.assert_array_equal(g.detach().numpy(), np.asarray(w))
    got, want = opt_leaves(pt.opt_state), _jax_opt_leaves(jopt)
    assert pt.opt_state["count"] == 2  # two windows of 100 in 150 columns
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


# ---------------------------------------------------------------------------
# init, geometry, backend resolution
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("hidden,layers", [(128, 1), (32, 2)])
def test_init_params_matches_helen_tpu_layout(hidden, layers):
    """Same tree, shapes and parameter count as helen_tpu's ``init_params``,
    each tensor uniform within its bound (1/sqrt(H) for the GRUs,
    1/sqrt(2H) for the heads); the values differ from jax.random's."""
    from helen_tpu.config import MODEL as JMODEL
    from helen_tpu.models.transducer import init_params as jinit
    from helen_tpu.models.transducer import num_params as jnum

    from helen_tpu_torch.io.checkpoint import flatten_tree
    from helen_tpu_torch.models.transducer import num_params

    want = jinit(jax.random.PRNGKey(0), dataclasses.replace(
        JMODEL, hidden_size=hidden, gru_layers=layers))
    got = fresh_params(hidden, layers, seed=1)
    g, w = flatten_tree(got), flatten_tree(want)
    assert {k: v.shape for k, v in g.items()} == {k: v.shape for k, v in w.items()}
    assert num_params(to_torch(got)) == jnum(want)
    for k, v in g.items():
        bound = 1 / np.sqrt(2 * hidden if "head" in k else hidden)
        assert v.dtype == np.float32 and np.abs(v).max() <= bound, k
        if v.size > 1000:  # a uniform draw reaches near both ends
            assert v.max() > 0.9 * bound and v.min() < -0.9 * bound, k
    again = fresh_params(hidden, layers, seed=1)
    assert all(np.array_equal(g[k], flatten_tree(again)[k]) for k in g)


def test_resolve_backend_for_the_train_surface():
    from helen_tpu_torch.models.transducer import resolve_backend

    cpu = torch.device("cpu")
    assert resolve_backend("auto", cpu, kind="train") == "torch"
    assert resolve_backend("xla", cpu, kind="train") == "torch"
    with pytest.raises(ValueError, match="needs a CUDA device"):
        resolve_backend("pallas_train", cpu, kind="train")
    with pytest.raises(ValueError, match="needs a CUDA device"):
        resolve_backend("cuda", cpu, kind="train")
    with pytest.raises(ValueError):  # a train alias on the inference surface
        resolve_backend("pallas_train", cpu)
    with pytest.raises(ValueError, match="not a train backend"):
        resolve_backend("pallas_fast", cpu, kind="train")
