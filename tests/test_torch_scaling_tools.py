"""The port's scaling_bench and sharding_overhead against helen_tpu's.

helen_tpu measures over the local devices of one process (here its virtual
8-device CPU mesh, tests/conftest.py); the port measures a job of one gloo
process per device (parallel.multihost.run_task), here on ["cpu"] * k. The
rows carry helen_tpu's keys for the same counts, the ``--json_out`` meta
helen_tpu's keys; the job's label sums equal helen_tpu's consensus labels
on the same params (the port's, converted) and images; the sharded and
unsharded training steps reach the same loss within 1e-5 relative.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

JOB_TIMEOUT_S = 300


@pytest.fixture(autouse=True)
def _two_threads(monkeypatch):
    """The job's processes on two threads each, as this one."""
    monkeypatch.setenv("OMP_NUM_THREADS", "2")


def json_keys(tmp_path, name, main, argv, module, monkeypatch, rows):
    """The keys of ``main(argv + --json_out)``'s meta, its ``measure``
    replaced by one that returns ``rows``; and the arguments it passed."""
    calls = []

    def measure(*args, **kwargs):
        calls.append((args, kwargs))
        return rows

    monkeypatch.setattr(module, "measure", measure)
    path = str(tmp_path / name)
    assert main([*argv, "--json_out", path]) == 0
    with open(path) as f:
        doc = json.load(f)
    assert doc["rows"] == rows
    return sorted(doc["meta"]), calls


def test_scaling_bench_rows_and_label_sums_match_helen_tpu(tmp_path, monkeypatch):
    from helen_tpu.models.transducer import consensus_labels as jax_labels
    from helen_tpu.tools import scaling_bench as theirs

    from helen_tpu_torch.models.transducer import init_params
    from helen_tpu_torch.tools import scaling_bench as ours

    want = theirs.measure([1, 2], per_device_batch=2, steps=2)
    records = {}
    got = ours.measure([1, 2], per_device_batch=2, steps=2, devices=["cpu", "cpu"],
                       records=records, timeout_s=JOB_TIMEOUT_S)
    assert [sorted(r) for r in got] == [sorted(r) for r in want]
    assert [r["devices"] for r in got] == [r["devices"] for r in want] == [1, 2]
    assert got[0]["efficiency"] == 1.0 and [r["baseline_devices"] for r in got] == [1, 1]
    assert all(r["windows_per_s"] > 0 and r["backend"] == "torch" for r in got)
    assert sorted(records) == [1, 2] and [len(records[k]) for k in (1, 2)] == [1, 2]

    params = jax.tree_util.tree_map(lambda t: jnp.asarray(t.numpy()),
                                    init_params(torch.Generator().manual_seed(0)))
    for k, procs in records.items():
        base, rle = jax_labels(params, jnp.asarray(ours.batch_images(2 * k)), backend="xla")
        # the job's sums over its 2 timed batches of the same global batch
        sums = [2 * int(np.asarray(base, np.int64).sum()), 2 * int(np.asarray(rle, np.int64).sum())]
        assert [p["label_sums"] for p in procs] == [sums] * k
        assert [p["rank"] for p in procs] == list(range(k))
        assert all(p["batches"] == 3 and p["kernel"] == "torch" for p in procs)

    keys_theirs, _ = json_keys(tmp_path, "theirs.json", theirs.main,
                               ["-b", "2", "--steps", "2", "--devices", "1,2"], theirs,
                               monkeypatch, want)
    keys_ours, calls = json_keys(tmp_path, "ours.json", ours.main,
                                 ["-b", "2", "--steps", "2", "--devices", "1,2",
                                  "--device_list", "cpu,cpu"], ours, monkeypatch, got)
    assert keys_ours == keys_theirs
    assert calls == [(([1, 2], 2, 2, None, ["cpu", "cpu"]), {})]


def test_sharding_overhead_row_and_losses_match_helen_tpu(tmp_path, monkeypatch):
    from helen_tpu.tools import sharding_overhead as theirs

    from helen_tpu_torch.tools import sharding_overhead as ours

    want = theirs.measure([2], per_device_batch=1, steps=1, image_len=100)
    records = {}
    got = ours.measure([2], per_device_batch=1, steps=1, image_len=100,
                       devices=["cpu", "cpu"], records=records, timeout_s=JOB_TIMEOUT_S)
    assert len(got) == 1 and sorted(got[0]) == sorted(want[0])
    assert got[0]["devices"] == 2 and got[0]["global_batch"] == 2
    for k in ("train_overhead", "consensus_overhead"):
        assert -0.95 < got[0][k] < 20.0  # finite, sane: helen_tpu's test's range
    solo, shard = records[2]["unsharded"], records[2]["sharded"]
    assert len(solo) == 1 and [p["rank"] for p in shard] == [0, 1]
    loss = solo[0]["loss"]
    assert np.isfinite(loss) and loss > 0
    for p in shard:
        assert abs(p["loss"] - loss) <= 1e-5 * abs(loss)
        assert p["backend"] == "torch"
    # the consensus labels' sums over the global batch agree to a few flips
    assert abs(shard[0]["label_sum"] - solo[0]["label_sum"]) <= 2 * 2 * 1000 * 1e-3
    assert shard[0]["label_sum"] == shard[1]["label_sum"]

    keys_theirs, _ = json_keys(tmp_path, "theirs.json", theirs.main,
                               ["-b", "1", "--steps", "1", "--image_len", "100",
                                "--devices", "2"], theirs, monkeypatch, want)
    keys_ours, calls = json_keys(tmp_path, "ours.json", ours.main,
                                 ["-b", "1", "--steps", "1", "--image_len", "100",
                                  "--devices", "2", "--device_list", "cpu,cpu"], ours,
                                 monkeypatch, got)
    assert keys_ours == keys_theirs
    assert calls == [(([2], 1, 1, 100, ["cpu", "cpu"]), {})]


def test_the_tools_refuse_without_a_gpu_unless_given_devices(monkeypatch):
    """No device list and no GPU: the measurement raises, naming the way to
    run on the CPU; it never falls back."""
    from helen_tpu_torch.parallel import multihost
    from helen_tpu_torch.tools import scaling_bench, sharding_overhead

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for measure in (scaling_bench.measure, sharding_overhead.measure):
        with pytest.raises(RuntimeError, match="no CUDA GPU is visible.*cpu"):
            measure([2])
    assert multihost.job_devices(["cuda:0", "cuda:0"]) == ["cuda:0", "cuda:0"]
    with pytest.raises(ValueError, match="devices must be"):
        multihost.job_devices(["tpu:0"])


def test_a_failed_job_process_raises(tmp_path):
    """A process of a run_task job that fails makes the job raise."""
    from helen_tpu_torch.parallel import multihost

    with pytest.raises(RuntimeError, match="failed"):
        multihost.run_task("helen_tpu_torch.tools.scaling_bench",
                           {"per_device_batch": 1, "steps": 1, "backend": "cuda"},
                           ["cpu"], JOB_TIMEOUT_S)
