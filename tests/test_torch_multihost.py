"""The port's multi-process jobs (helen_tpu_torch.parallel.multihost) on
the CPU, with gloo over loopback addresses.

The pure helpers (image and file shards, the 16-bit limbs of the exact sum)
equal helen_tpu's; the CLI turns an incomplete set of job flags into an
argparse error naming what is missing; 2-process jobs
(tests/torch_multihost_worker.py, and the local launcher the CLI uses on a
host with several GPUs) run the collectives, raise at a barrier a peer
never reaches, polish the golden images to tests/golden/golden.fa and their
recorded labels under both ``--host_shard`` modes, recover a killed
process's shard with ``--resume``, give the single-process ``test``
confusion matrices exactly, and train one epoch within helen_tpu's own
tolerance of its single-process Trainer (rtol 2e-4 / atol 2e-5,
tests/multihost_worker.py), the two processes' params equal bit for bit
after every batch.
"""
import dataclasses
import glob
import json
import os
import re
import subprocess
import sys

import h5py
import numpy as np
import pytest
import torch

from torch_port_fixtures import GOLDEN_DIR, golden, stage_golden_images, store_labels

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "tests", "torch_multihost_worker.py")


def _env(**extra):
    env = dict(os.environ, OMP_NUM_THREADS="2", **extra)
    env["PYTHONPATH"] = os.pathsep.join([ROOT] + [p for p in [env.get("PYTHONPATH")] if p])
    return env


def _spawn(mode, workdir, *args, nprocs=2, env=None):
    from helen_tpu_torch.parallel.multihost import free_port

    port = str(free_port())
    return [subprocess.Popen([sys.executable, WORKER, mode, str(r), str(nprocs), port,
                              str(workdir), *map(str, args)],
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                             env=env or _env())
            for r in range(nprocs)]


def _wait(procs, timeout=150):
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return [(p.returncode, out, err) for p, (out, err) in zip(procs, outs)]


def _assert_ok(results):
    for rank, (rc, out, err) in enumerate(results):
        assert rc == 0, f"process {rank} failed ({rc}):\n{out}\n{err[-4000:]}"


def _golden_labels_hold(pred_dir):
    """Every recorded golden label, across the shard files, and the files
    are ``helen_predictions_0.hdf`` and ``_1.hdf``."""
    files = sorted(os.path.basename(p) for p in glob.glob(os.path.join(pred_dir, "*.hdf")))
    assert files == ["helen_predictions_0.hdf", "helen_predictions_1.hdf"], files
    got = {}
    for f in files:
        labels = store_labels(os.path.join(pred_dir, f))
        assert labels and not set(labels) & set(got)  # each image in one shard
        got.update(labels)
    want = np.load(golden("golden_labels.npz"))
    keys = sorted(k[len("base/"):] for k in want.files if k.startswith("base/"))
    assert sorted(got) == keys
    for k in keys:
        np.testing.assert_array_equal(got[k][0], want[f"base/{k}"])
        np.testing.assert_array_equal(got[k][1], want[f"rle/{k}"])


def _same_as_golden_fasta(path):
    with open(path, "rb") as a, open(os.path.join(GOLDEN_DIR, "golden.fa"), "rb") as b:
        return a.read() == b.read()


# ---------------------------------------------------------------------------
# the pure helpers, against helen_tpu's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("count", [1, 2, 3, 4, 7, 16])
def test_host_shards_equal_helen_tpus(count):
    from helen_tpu.parallel import multihost as jax_multihost

    from helen_tpu_torch.parallel import multihost

    files = [f"f{i:02d}.h5" for i in range(23)][::-1]
    for n in (0, 1, 2, 5, 10, 11, 37, 1000):
        blocks = [multihost.host_image_shard(n, p, count) for p in range(count)]
        assert blocks == [jax_multihost.host_image_shard(n, p, count) for p in range(count)]
        assert sum(blocks, []) == list(range(n))
        assert max(map(len, blocks)) - min(map(len, blocks)) <= 1
    for k in (0, 1, 2, 5, 23):
        shards = [multihost.host_file_shard(files[:k], p, count) for p in range(count)]
        assert shards == [jax_multihost.host_file_shard(files[:k], p, count)
                          for p in range(count)]
        assert sorted(sum(shards, [])) == sorted(files[:k])


def test_outside_a_job_every_helper_is_the_identity():
    from helen_tpu_torch.parallel import multihost

    assert (multihost.process_index(), multihost.process_count()) == (0, 1)
    assert multihost.host_image_shard(5) == list(range(5))
    assert multihost.host_file_shard(["b", "a"]) == ["a", "b"]
    assert multihost.broadcast_name("x") == "x"
    a = np.arange(4.0)
    assert multihost.allsum_hosts(a) is a
    assert multihost.allsum_hosts_exact(a).tolist() == [0, 1, 2, 3]
    t = torch.ones(3)
    assert multihost.allreduce_sum(t) is t
    multihost.barrier("alone", timeout_s=0.1)
    multihost.initialize()  # a single-process run: a no-op


@pytest.mark.parametrize("values", [
    [0, 1, 65535, 65536, (1 << 24) + 1, (1 << 32) + 5, (1 << 48) - 1],
    [[3.0, 4.0], [12345678901.0, 0.4]],
], ids=["edges", "2d"])
def test_limbs_equal_helen_tpus(values):
    from helen_tpu.parallel import multihost as jax_multihost

    from helen_tpu_torch.parallel import multihost

    limbs = multihost._split_limbs(np.asarray(values))
    np.testing.assert_array_equal(limbs, jax_multihost._split_limbs(np.asarray(values)))
    assert limbs.dtype == np.float64 and limbs.max() < 1 << 16
    back = multihost._combine_limbs(limbs)
    np.testing.assert_array_equal(back, jax_multihost._combine_limbs(limbs))
    np.testing.assert_array_equal(back, np.rint(np.asarray(values)).astype(np.int64))


@pytest.mark.parametrize("bad,match", [([-1, 2], "non-negative"),
                                       ([1 << 48], r"< 2\*\*48")])
def test_limbs_refuse_what_helen_tpus_refuse(bad, match):
    from helen_tpu.parallel import multihost as jax_multihost

    from helen_tpu_torch.parallel import multihost

    for mod in (multihost, jax_multihost):
        with pytest.raises(ValueError, match=match):
            mod._split_limbs(np.asarray(bad))


@pytest.mark.parametrize("flags,missing", [
    (["--num_processes", "2"], "--num_processes also needs --coordinator_address and "
                               "--process_id"),
    (["--process_id", "0"], "--process_id also needs --coordinator_address and "
                            "--num_processes"),
    (["--coordinator_address", "127.0.0.1:1"], "--coordinator_address also needs "
                                               "--num_processes and --process_id"),
    (["--coordinator_address", "127.0.0.1:1", "--num_processes", "2", "--process_id", "2"],
     r"--process_id 2 is not in \[0, --num_processes 2\)"),
    (["--distributed"], "--distributed reads torchrun's environment"),
], ids=["num_processes", "process_id", "coordinator", "rank_range", "distributed"])
def test_an_incomplete_job_is_an_argparse_error(flags, missing, capsys, monkeypatch):
    from helen_tpu_torch.cli import main

    for var in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(SystemExit) as exc:
        main([*flags, "polish", "-i", "imgs", "-m", "model.pkl", "--device", "cpu"])
    assert exc.value.code == 2
    err = capsys.readouterr().err
    assert re.search(missing, err), err
    assert "not yet ported" not in err


def test_worker_env_gives_each_cuda_worker_its_card():
    from helen_tpu_torch.parallel.multihost import worker_env

    assert worker_env("cuda:1", {})["CUDA_VISIBLE_DEVICES"] == "1"
    assert worker_env("cuda:1", {"CUDA_VISIBLE_DEVICES": "4,6"})["CUDA_VISIBLE_DEVICES"] == "6"
    assert worker_env("cuda:0", {"CUDA_VISIBLE_DEVICES": "4,6"})["CUDA_VISIBLE_DEVICES"] == "4"
    assert "CUDA_VISIBLE_DEVICES" not in worker_env("cpu", {})


def test_cli_runs_one_worker_per_visible_gpu(monkeypatch):
    """With several GPUs visible and no job flags the CLI hands the command
    line to the local launcher, one device each; ``--no_data_parallel``,
    ``--device cpu`` and the job flags keep one process."""
    from helen_tpu_torch import cli
    from helen_tpu_torch.infer import consensus
    from helen_tpu_torch.parallel import multihost

    calls = []
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    monkeypatch.setattr(consensus, "resolve_device", lambda name="cuda": torch.device("cpu"))
    monkeypatch.setattr(multihost, "launch_local",
                        lambda argv, devices, **k: calls.append((argv, devices)) or 0)
    argv = ["polish", "-i", "imgs", "-m", "model.pkl"]
    assert cli.main(argv) == 0
    assert calls == [(argv, ["cuda:0", "cuda:1", "cuda:2"])]
    for command in (["train", "--train_image_dir", "a", "--test_image_dir", "b"],
                    ["test", "--test_image_dir", "a", "-m", "m.npz"],
                    ["call_consensus", "-i", "imgs", "-m", "model.pkl"]):
        assert cli._local_devices(cli.build_parser().parse_args(command)) == [
            "cuda:0", "cuda:1", "cuda:2"]
    parser = cli.build_parser()
    for argv in (["polish", "-i", "i", "-m", "m", "--no_data_parallel"],
                 ["polish", "-i", "i", "-m", "m", "--device", "cpu"],
                 ["stitch", "-i", "preds"]):
        assert cli._local_devices(parser.parse_args(argv)) is None


# ---------------------------------------------------------------------------
# 2-process jobs
# ---------------------------------------------------------------------------

@pytest.mark.timeout(120)
def test_collectives_through_torchruns_environment(tmp_path):
    _assert_ok(_wait(_spawn("collectives", tmp_path)))


@pytest.mark.timeout(120)
def test_a_barrier_a_peer_never_reaches_raises_within_its_timeout(tmp_path):
    procs = _spawn("barrier", tmp_path)
    try:
        out, err = procs[0].communicate(timeout=90)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.communicate()
    assert procs[0].returncode == 0, f"{out}\n{err[-3000:]}"
    seconds = float(re.search(r"TIMEOUT_RAISED ([\d.]+)", out).group(1))
    assert 2.5 <= seconds < 30


@pytest.mark.timeout(120)
def test_two_process_polish_by_image_through_the_local_launcher(tmp_path, monkeypatch):
    """``--host_shard image`` (the default) through the launcher the CLI
    uses on a multi-GPU host, here with two CPU workers."""
    from helen_tpu_torch.parallel.multihost import launch_local

    images = stage_golden_images(tmp_path / "images")
    monkeypatch.setenv("PYTHONPATH", os.pathsep.join(
        [ROOT] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    monkeypatch.setenv("OMP_NUM_THREADS", "2")
    out = tmp_path / "out"
    assert launch_local(["polish", "-i", images, "-m", golden("golden_model.pkl"), "-o",
                         str(out), "--device", "cpu", "-t", "2", "-b", "4"],
                        ["cpu", "cpu"], timeout_s=100) == 0
    assert _same_as_golden_fasta(out / "HELEN_prediction.fa")
    preds = glob.glob(str(out / "predictions_*"))
    assert len(preds) == 1
    _golden_labels_hold(preds[0])


def _split_golden_images(directory):
    """The golden images in two files, alternate images in each."""
    src = os.path.join(stage_golden_images(directory / "whole"), "golden_images.h5")
    os.makedirs(directory / "split")
    with h5py.File(src, "r") as f:
        names = sorted(f["images"])
        for part in range(2):
            with h5py.File(str(directory / "split" / f"part{part}.h5"), "w") as g:
                for name in names[part::2]:
                    f.copy(f["images"][name], g.require_group("images"), name=name)
    return str(directory / "split")


@pytest.mark.timeout(120)
def test_two_process_polish_by_file(tmp_path):
    images = _split_golden_images(tmp_path)
    out = tmp_path / "out"
    results = _wait(_spawn("cli", tmp_path, "polish", "-i", images, "-m",
                           golden("golden_model.pkl"), "-o", out, "--device", "cpu",
                           "-t", 2, "--host_shard", "file"))
    _assert_ok(results)
    assert all(f"process {r}/2 takes 1 input files" in err
               for r, (_, _, err) in enumerate(results))
    # every process prints the FASTA path; process 0 wrote it
    assert {o.strip().splitlines()[-1] for _, o, _ in results} == {
        str(out / "HELEN_prediction.fa")}
    assert _same_as_golden_fasta(out / "HELEN_prediction.fa")
    _golden_labels_hold(glob.glob(str(out / "predictions_*"))[0])


@pytest.mark.timeout(180)
def test_killed_process_then_resume_gives_the_uninterrupted_fasta(tmp_path):
    """Process 1 flushes its store and is SIGKILLed after its third record;
    a ``--resume`` job skips what both shards hold and stitches
    tests/golden/golden.fa (the uninterrupted run's FASTA)."""
    images = stage_golden_images(tmp_path / "images")
    out = tmp_path / "out"
    args = ["polish", "-i", images, "-m", golden("golden_model.pkl"), "-o", out, "--device",
            "cpu", "-t", 2, "-b", 1, "--barrier_timeout", 60]
    first = _wait(_spawn("cli", tmp_path, *args, env=_env(HELEN_TEST_KILL_AFTER="3")))
    assert first[1][0] == -9, first[1]
    assert first[0][0] != 0  # its peer died: the shards-complete barrier raised
    assert not os.path.exists(out / "HELEN_prediction.fa")
    pred = glob.glob(str(out / "predictions_*"))
    assert len(pred) == 1
    assert os.path.exists(os.path.join(pred[0], "helen_predictions_0.hdf"))
    assert os.path.exists(os.path.join(pred[0], "helen_predictions_1.hdf.journal"))
    second = _wait(_spawn("cli", tmp_path, *args, "--resume"))
    _assert_ok(second)
    skipped = [int(re.search(r"(\d+) images written, (\d+) skipped", err).group(2))
               for _, _, err in second]
    assert skipped == [5, 3], skipped  # process 0's whole block, process 1's three
    assert _same_as_golden_fasta(out / "HELEN_prediction.fa")
    assert glob.glob(str(out / "predictions_*")) == pred


@pytest.mark.timeout(120)
def test_two_process_test_gives_the_single_process_confusion_matrices(tmp_path):
    """``test`` on two processes: each scores its block of the images, the
    confusion matrices are summed exactly, the loss in float32."""
    from helen_tpu_torch.io.checkpoint import save_checkpoint
    from helen_tpu_torch.io.synthetic import random_sequence, write_image_file
    from helen_tpu_torch.train.evaluate import test_interface

    from test_torch_train import fresh_params

    # 8 one-image contigs at batch 4: each process's block is one whole
    # batch of the single-process run, so the loss (summed per batch of
    # window means, as the reference accounts it) sums the same terms
    os.makedirs(tmp_path / "te")
    write_image_file(str(tmp_path / "te" / "i.h5"),
                     {f"c{i}": random_sequence(600, seed=40 + i) for i in range(8)},
                     region_cols=900, overlap_cols=60, noise=0.05)
    model = str(tmp_path / "m.npz")
    save_checkpoint(model, fresh_params(16, seed=3), meta={"epochs": 0})
    one = test_interface(str(tmp_path / "te"), model, batch_size=4, num_workers=2,
                         output_dir=str(tmp_path / "one"), device="cpu")
    _assert_ok(_wait(_spawn("cli", tmp_path, "test", "--test_image_dir", tmp_path / "te",
                            "-m", model, "-b", 4, "-w", 2, "-o", tmp_path / "two",
                            "--device", "cpu")))
    with open(tmp_path / "two" / "test_stats.json") as f:
        two = json.load(f)
    assert two["base_confusion_matrix"] == one["base_confusion_matrix"].tolist()
    assert two["rle_confusion_matrix"] == one["rle_confusion_matrix"].tolist()
    assert np.asarray(two["base_confusion_matrix"]).sum() > 0
    np.testing.assert_allclose(two["loss"], one["loss"], rtol=1e-5)


@pytest.mark.timeout(240)
def test_two_process_train_matches_helen_tpus_single_process_trainer(tmp_path):
    """16 one-image contigs at global batch 8 (no wrap padding, no masked
    tail), both from the same H=16 checkpoint, the port's processes reading
    the one packed cache process 0 built: the 2-process port within
    rtol 2e-4 / atol 2e-5 of helen_tpu's single-process Trainer, the
    scheduler's lr and num_bad equal, and the two processes' params equal
    bit for bit after every batch."""
    from helen_tpu.config import TRAIN as JTRAIN
    from helen_tpu.io.checkpoint import load_checkpoint as jload
    from helen_tpu.train.train_loop import Trainer as JTrainer

    from helen_tpu_torch.io.checkpoint import flatten_tree, save_checkpoint
    from helen_tpu_torch.io.synthetic import random_sequence, write_image_file

    from test_torch_train import fresh_params

    os.makedirs(tmp_path / "train")
    write_image_file(str(tmp_path / "train" / "train.h5"),
                     {f"t{i}": random_sequence(600, seed=10 + i) for i in range(16)},
                     region_cols=900, overlap_cols=60, noise=0.1)
    start = str(tmp_path / "start.npz")
    save_checkpoint(start, fresh_params(16, seed=5), meta={"epochs": 0})
    procs = _spawn("train", tmp_path)
    files = [str(tmp_path / "train" / "train.h5")]
    jt = JTrainer(files, files,
                  cfg=dataclasses.replace(JTRAIN, batch_size=8, learning_rate=1e-3, seed=7),
                  model_dir=str(tmp_path / "j" / "models"),
                  stats_dir=str(tmp_path / "j" / "stats"), num_workers=2,
                  retrain_model_path=start, data_parallel=False)
    assert len(jt.dataset) == 16
    jh = jt.run(1)
    _assert_ok(_wait(procs, timeout=200))
    want, _, _ = jload(str(tmp_path / "j" / "models" / "HELEN_epoch_1_checkpoint.npz"))
    want = {k: np.asarray(v) for k, v in flatten_tree(want).items()}
    ranks = [dict(np.load(tmp_path / f"rank{r}.npz")) for r in range(2)]
    logs = [json.load(open(tmp_path / f"rank{r}.json")) for r in range(2)]
    assert len(logs[0]["digests"]) == 2 and logs[0]["digests"] == logs[1]["digests"]
    assert logs[0] == logs[1]
    assert sorted(ranks[0]) == sorted(want)
    for k in want:
        assert ranks[0][k].tobytes() == ranks[1][k].tobytes(), k
        np.testing.assert_allclose(ranks[0][k], want[k], rtol=2e-4, atol=2e-5, err_msg=k)
    sched, jsched = logs[0]["scheduler"], jt.scheduler.state_dict()
    assert (sched["lr"], sched["num_bad"]) == (jsched["lr"], jsched["num_bad"])
    np.testing.assert_allclose(sched["best"], jsched["best"], rtol=2e-4)
    np.testing.assert_allclose(logs[0]["train_loss"], jh[0].train_loss, rtol=2e-4)
    # process 0 alone wrote the checkpoints, the stats and the packed cache
    models = tmp_path / "out" / "models"
    assert os.path.exists(models / "HELEN_epoch_1_checkpoint.npz")
    assert sorted(f for f in os.listdir(models) if "cache" in f) == ["train_images_cache.h5"]
    with open(tmp_path / "out" / "stats" / "train_loss.csv") as f:
        assert len(f.read().splitlines()) == 2
