"""``train --model_parallel`` of the port (parallel/mesh.py,
parallel/sharding.py, the Trainer's data x tensor step) on the CPU.

* The mesh shape rule and the shards' layout: whole hidden units per
  shard, r, z and n of the same units together; the heads split on their
  2H input; a round trip through the shards is exact.
* The split forward window against the port's plain ``forward``.
* One epoch on ``["cpu", "cpu"]`` (model=2) against helen_tpu's GSPMD
  trainer on its 8-virtual-device mesh (data=4 x model=2), both from one
  shared start checkpoint, ``batch_size=8``: params within atol/rtol 1e-4
  (helen_tpu's own bar, tests/test_train.py:143-176); and against the
  port's one-device trainer.
* The CLI: the clamp warning where the width does not divide the devices,
  the refusal in a multi-process job, and that a ``--model_parallel`` run
  stays one process.
"""
import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

torch.set_num_threads(2)


@pytest.mark.parametrize("n,mp,want", [(8, 2, (4, 2)), (8, 3, (4, 2)), (1, 2, (1, 1)),
                                       (6, 4, (2, 3)), (2, 2, (1, 2)), (5, 1, (5, 1))])
def test_mesh_shape_matches_helen_tpu(n, mp, want):
    from helen_tpu.parallel.mesh import mesh_shape_for as ref

    from helen_tpu_torch.parallel.mesh import make_mesh, mesh_shape_for

    assert mesh_shape_for(n, mp) == ref(n, mp) == want
    mesh = make_mesh(["cpu"] * n, model_parallel=mp)
    assert (mesh.shape["data"], mesh.shape["model"]) == want
    assert mesh.devices.shape == want


@pytest.mark.parametrize("h,mp,layers", [(10, 3, 2), (16, 2, 1), (7, 4, 1)])
def test_shards_hold_whole_units_and_round_trip(h, mp, layers):
    from helen_tpu_torch.config import MODEL
    from helen_tpu_torch.models.transducer import init_hidden, init_params, param_leaves
    from helen_tpu_torch.models.transducer import forward
    from helen_tpu_torch.parallel.mesh import make_mesh
    from helen_tpu_torch.parallel.sharding import (
        shard_params,
        sharded_forward,
        unit_slices,
        unshard_params,
    )

    cfg = dataclasses.replace(MODEL, hidden_size=h, gru_layers=layers)
    p = init_params(torch.Generator().manual_seed(h), cfg)
    mesh = make_mesh(["cpu"] * mp, model_parallel=mp)
    sh = shard_params(mesh, p)
    slices = unit_slices(h, mp)
    assert slices[0][0] == 0 and slices[-1][1] == h
    for m, (a, b) in enumerate(slices):
        s = sh[f"shard{m}"]
        u = b - a
        w = s["encoder"]["fwd"]["w_hh"]
        assert w.shape == (h, 3 * u)
        # the r, z and n columns of the same units
        for g in range(3):
            assert torch.equal(w[:, g * u:(g + 1) * u],
                               p["encoder"]["fwd"]["w_hh"][:, g * h + a:g * h + b])
        assert s["base_head"]["w"].shape == (2 * u, 5)
        assert ("b" in s["base_head"]) == (m == 0)
    back = unshard_params(mesh, sh, "cpu")
    assert all(torch.equal(x, y) for x, y in zip(param_leaves(p), param_leaves(back)))
    rng = np.random.default_rng(h)
    img = torch.from_numpy(rng.integers(0, 40, (3, 130, 90), dtype=np.uint8))
    hid = torch.from_numpy(rng.uniform(-1, 1, (3, 2 * layers, h)).astype(np.float32))
    want = forward(p, img, hid, "torch", start=20, window=100)
    got = sharded_forward([sh[f"shard{m}"] for m in range(mp)], slices,
                          list(mesh.devices[0]), img, hid, 20, 100)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), w.detach().numpy(), atol=1e-6)
    assert init_hidden(3, cfg).shape == hid.shape


@pytest.fixture(scope="module")
def labeled_dirs(tmp_path_factory):
    from helen_tpu_torch.io.synthetic import random_sequence, write_image_file

    root = tmp_path_factory.mktemp("torch_mp_data")
    for name, bp, seed in (("train", 9000, 61), ("test", 2000, 62)):
        os.makedirs(root / name)
        write_image_file(str(root / name / f"{name}.h5"),
                         {f"c_{name}": random_sequence(bp, seed=seed)},
                         region_cols=1000, overlap_cols=0, noise=0.05, seed=seed + 10)
    return str(root / "train"), str(root / "test")


def _leaves(tree):
    from helen_tpu_torch.io.checkpoint import flatten_tree

    return {k: np.asarray(v.detach().cpu() if hasattr(v, "detach") else v)
            for k, v in flatten_tree(tree).items()}


def test_epoch_matches_helen_tpu_mesh(labeled_dirs, tmp_path):
    from helen_tpu.config import TRAIN as JTRAIN
    from helen_tpu.train.train_loop import Trainer as JTrainer
    from helen_tpu.utils.filesystem import list_image_files

    from helen_tpu_torch.config import MODEL, TRAIN
    from helen_tpu_torch.io.checkpoint import load_checkpoint, save_checkpoint
    from helen_tpu_torch.models.transducer import init_params
    from helen_tpu_torch.train.train_loop import Trainer

    assert len(jax.devices()) == 8
    start = str(tmp_path / "start.npz")
    save_checkpoint(start, init_params(torch.Generator().manual_seed(24),
                                       dataclasses.replace(MODEL, hidden_size=24)),
                    meta={"epochs": 0})
    files = [list_image_files(d) for d in labeled_dirs]
    kw = dict(batch_size=8, learning_rate=1e-3, seed=3)

    def port(sub, **extra):
        t = Trainer(*files, dataclasses.replace(TRAIN, **kw),
                    model_dir=str(tmp_path / sub / "models"),
                    stats_dir=str(tmp_path / sub / "stats"), num_workers=2,
                    retrain_model_path=start, device="cpu", **extra)
        return t, t.run(1)

    tmp, hmp = port("mp", model_parallel=2, devices=["cpu", "cpu"])
    assert (tmp.mesh.shape["data"], tmp.mesh.shape["model"]) == (1, 2)
    assert len(tmp.sharded) == 2
    jt = JTrainer(*files, dataclasses.replace(JTRAIN, **kw),
                  model_dir=str(tmp_path / "j" / "models"),
                  stats_dir=str(tmp_path / "j" / "stats"), num_workers=2,
                  retrain_model_path=start, model_parallel=2)
    assert jt.shard_multiple == 4
    jh = jt.run(1)
    tdp, hdp = port("dp")
    got = _leaves(load_checkpoint(str(tmp_path / "mp" / "models" /
                                      "HELEN_epoch_1_checkpoint.npz"))[0])
    for name, want in (("helen_tpu mesh", _leaves(jax.device_get(jt.params))),
                       ("one device", _leaves(tdp.params))):
        assert sorted(got) == sorted(want)
        for k in got:
            np.testing.assert_allclose(got[k], want[k], atol=1e-4, rtol=1e-4,
                                       err_msg=f"{name}: {k}")
    np.testing.assert_allclose(hmp[0].test_loss, jh[0].test_loss, rtol=1e-4)
    np.testing.assert_allclose(hmp[0].test_loss, hdp[0].test_loss, rtol=1e-4)


def test_cli_clamps_refuses_and_stays_one_process(labeled_dirs, tmp_path, monkeypatch):
    import logging

    from helen_tpu_torch import cli
    from helen_tpu_torch.parallel import multihost

    warnings = []

    class Keep(logging.Handler):
        def emit(self, record):
            warnings.append(record.getMessage())

    logger = logging.getLogger("helen_tpu_torch.train")
    handler = Keep(logging.WARNING)
    logger.addHandler(handler)
    args = ["--platform", "cpu", "train", "--train_image_dir", labeled_dirs[0],
            "--test_image_dir", labeled_dirs[1], "-b", "4", "-e", "1", "-w", "2",
            "--hidden_size", "8", "--model_parallel", "2", "-o", str(tmp_path / "o")]
    try:
        assert cli.main(args) == 0
    finally:
        logger.removeHandler(handler)
    assert "model_parallel=2 does not divide 1 devices; using 1" in warnings
    parsed = cli.build_parser().parse_args(
        ["train", "--train_image_dir", "x", "--test_image_dir", "y", "--model_parallel", "2"])
    assert cli._local_devices(parsed) is None
    from helen_tpu_torch.train.train_loop import Trainer

    monkeypatch.setattr(multihost, "process_count", lambda: 2)
    with pytest.raises(ValueError, match="drop --model_parallel"):
        Trainer([], [], model_parallel=2, device="cpu")
