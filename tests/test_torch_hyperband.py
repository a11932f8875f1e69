"""The port's Hyperband search (train/hyperband.py) against helen_tpu's, on
the CPU.

* The schedule: both packages' ``Hyperband`` with one stub ``run_trial``
  (the loss a function of the config): the configs drawn, the rung epochs,
  the resume states passed to survivors and the best are exactly equal.
* One bracket through each package's ``Trainer``: the most exploratory
  bracket of ``max_epochs=2, eta=2`` (two configs for one epoch, then the
  better one resumed for one more) trains real models, both from one shared
  start checkpoint (torch's and JAX's generators give different fresh
  inits); losses within the trainer-epoch tolerance of
  tests/test_torch_train.py (rtol 1e-5), the survivor and the rungs equal.
  The second bracket's trials return the stub's loss in both packages.
* ``hyperband_interface`` through the port's CLI on the CPU: its
  ``hyperband_results.json`` replays to the schedule.
"""
import dataclasses
import json
import os

import jax  # noqa: F401  (helen_tpu's Trainer; keeps JAX on the CPU via conftest)
import numpy as np
import pytest
import torch

torch.set_num_threads(2)


def _stub(calls):
    def run_trial(cfg, epochs, state):
        calls.append((dict(cfg), epochs, state))
        # a smooth function of the config with no ties
        loss = abs(np.log10(cfg["learning_rate"]) + 3.3) + 0.1 * cfg["weight_decay"] * 1e3
        return float(loss), f"state_{len(calls)}"

    return run_trial


@pytest.mark.parametrize("max_epochs,eta,seed", [(9, 3, 1), (2, 2, 0), (27, 3, 5), (8, 2, 7)])
def test_schedule_matches_helen_tpu(max_epochs, eta, seed):
    from helen_tpu.train.hyperband import Hyperband as JHyperband

    from helen_tpu_torch.train.hyperband import Hyperband

    got, want = [], []
    hb = Hyperband(_stub(got), max_epochs=max_epochs, eta=eta, seed=seed)
    jhb = JHyperband(_stub(want), max_epochs=max_epochs, eta=eta, seed=seed)
    best, jbest = hb.run(), jhb.run()
    assert (hb.s_max, hb.B) == (jhb.s_max, jhb.B)
    assert got == want  # configs, added epochs, the survivors' resume states
    assert [(r.params, r.loss, r.epochs) for r in hb.results] == [
        (r.params, r.loss, r.epochs) for r in jhb.results]
    assert (best.params, best.loss, best.epochs) == (jbest.params, jbest.loss, jbest.epochs)


@pytest.fixture(scope="module")
def labeled_dirs(tmp_path_factory):
    from helen_tpu_torch.io.synthetic import random_sequence, write_image_file

    root = tmp_path_factory.mktemp("torch_hyperband_data")
    for name, bp, seed in (("train", 5000, 41), ("test", 2000, 42)):
        os.makedirs(root / name)
        write_image_file(str(root / name / f"{name}.h5"),
                         {f"c_{name}": random_sequence(bp, seed=seed)},
                         region_cols=1000, overlap_cols=0, noise=0.05, seed=seed + 10)
    return str(root / "train"), str(root / "test")


def test_one_bracket_through_each_trainer(labeled_dirs, tmp_path):
    """The bracket s=1 of ``max_epochs=2, eta=2`` trains through each
    package's Trainer from one shared H=16 start checkpoint, as each
    package's ``hyperband_interface`` builds its trials."""
    from helen_tpu.config import TRAIN as JTRAIN
    from helen_tpu.train.hyperband import Hyperband as JHyperband
    from helen_tpu.train.train_loop import Trainer as JTrainer
    from helen_tpu.utils.filesystem import list_image_files

    from helen_tpu_torch.config import MODEL, TRAIN
    from helen_tpu_torch.io.checkpoint import save_checkpoint
    from helen_tpu_torch.models.transducer import init_params
    from helen_tpu_torch.train.hyperband import Hyperband
    from helen_tpu_torch.train.train_loop import Trainer

    start = str(tmp_path / "start.npz")
    save_checkpoint(start, init_params(torch.Generator().manual_seed(16),
                                       dataclasses.replace(MODEL, hidden_size=16)),
                    meta={"epochs": 0})
    files = [list_image_files(d) for d in labeled_dirs]
    bracket_calls = 3  # two configs for one epoch, the survivor for one more

    def runner(name, make_trainer, calls):
        stub = _stub([])

        def run_trial(cfg, epochs, state):
            calls.append((dict(cfg), epochs, state is None))
            if len(calls) > bracket_calls:
                return stub(cfg, epochs, state)
            tdir = tmp_path / name / f"trial_{len(calls):03d}"
            history = make_trainer(cfg, tdir, state or start).run(int(epochs))
            ckpt = tdir / "models" / f"HELEN_epoch_{history[-1].epoch}_checkpoint.npz"
            return history[-1].test_loss, str(ckpt)

        return run_trial

    def port_trainer(cfg, tdir, state):
        return Trainer(*files, dataclasses.replace(
            TRAIN, batch_size=4, learning_rate=cfg["learning_rate"],
            weight_decay=cfg["weight_decay"], seed=0),
            model_dir=str(tdir / "models"), stats_dir=str(tdir / "stats"), num_workers=2,
            retrain_model_path=state, device="cpu")

    def jax_trainer(cfg, tdir, state):
        return JTrainer(*files, dataclasses.replace(
            JTRAIN, batch_size=4, learning_rate=cfg["learning_rate"],
            weight_decay=cfg["weight_decay"], seed=0),
            model_dir=str(tdir / "models"), stats_dir=str(tdir / "stats"), num_workers=2,
            retrain_model_path=state, data_parallel=False)

    got, want = [], []
    hb = Hyperband(runner("p", port_trainer, got), max_epochs=2, eta=2, seed=0)
    jhb = JHyperband(runner("j", jax_trainer, want), max_epochs=2, eta=2, seed=0)
    best, jbest = hb.run(), jhb.run()
    assert got == want  # configs, added epochs, which trials were resumed
    assert [r.epochs for r in hb.results] == [r.epochs for r in jhb.results] == [1, 1, 2, 2, 2]
    for g, w in zip(hb.results, jhb.results):
        np.testing.assert_allclose(g.loss, w.loss, rtol=1e-5)
    assert best.params == jbest.params and best.epochs == jbest.epochs


def test_hyperband_cli_records_the_schedule(labeled_dirs, tmp_path, capsys, monkeypatch):
    """``python -m helen_tpu_torch hyperband --device cpu`` writes
    ``hyperband_results.json``: its trials replay through ``Hyperband``
    (the recorded losses fed back in order) to the same configs, rung
    epochs, survivors and best; each trial's checkpoint exists at its
    cumulative epoch. The trials train the default geometry, so the run is
    kept to one small epoch budget by a stub Trainer run."""
    from helen_tpu_torch.cli import main
    from helen_tpu_torch.train import train_loop
    from helen_tpu_torch.train.hyperband import Hyperband

    real_init = train_loop.Trainer.__init__

    def small_init(self, *a, **kw):  # the trials' model at H=8: a CPU-sized run
        kw.setdefault("model_cfg", dataclasses.replace(train_loop.MODEL, hidden_size=8))
        real_init(self, *a, **kw)

    monkeypatch.setattr(train_loop.Trainer, "__init__", small_init)
    out = tmp_path / "hb"
    assert main(["hyperband", "--device", "cpu", "--train_image_dir", labeled_dirs[0],
                 "--test_image_dir", labeled_dirs[1], "-b", "8", "--max_epochs", "2",
                 "--eta", "2", "--seed", "0", "-o", str(out)]) == 0
    assert "best lr=" in capsys.readouterr().out
    with open(out / "hyperband_results.json") as f:
        rec = json.load(f)
    trials = rec["trials"]
    losses = iter([t["loss"] for t in trials])
    replay = []

    def run_trial(cfg, epochs, state):
        replay.append((cfg, epochs, state))
        return next(losses), trials[len(replay) - 1]["checkpoint"]

    best = Hyperband(run_trial, max_epochs=2, eta=2, seed=0).run()
    assert [(c, e) for c, e, _ in replay] == [(t["params"], t["added_epochs"]) for t in trials]
    assert [s for _, _, s in replay] == [t["resumed_from"] for t in trials]
    assert (best.params, best.loss) == (rec["best"]["params"], rec["best"]["loss"])
    for t in trials:
        assert t["checkpoint"].endswith(f"HELEN_epoch_{t['epochs']}_checkpoint.npz")
        assert os.path.exists(t["checkpoint"])
