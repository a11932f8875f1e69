"""Worker of the port's multi-process tests (tests/test_torch_multihost.py).

Usage: python tests/torch_multihost_worker.py <mode> <rank> <nprocs> <port> <workdir> [args]

Modes:
  collectives  joins through torchrun's environment (``--distributed``'s
               ``env://``) and checks broadcast_name, allsum_hosts,
               allsum_hosts_exact and allreduce_sum across the processes
  barrier      process 0 waits at a 3 s barrier its peer never reaches and
               must raise; the peer sleeps until the parent kills it
  cli          the port's CLI with ``args``, joined through
               ``--coordinator_address``/``--num_processes``/``--process_id``;
               with ``HELEN_TEST_KILL_AFTER=k`` in its environment, process 1
               flushes its store and SIGKILLs itself after its k-th record
  train        one epoch of the port's Trainer (global batch 8, lr 1e-3,
               seed 7, ``pack``: process 0 builds the one cache) from
               ``workdir/start.npz`` on ``workdir/train``; writes
               its params, scheduler state and a digest of its params after
               every batch to ``workdir/rank<r>.npz`` / ``.json``
"""
import hashlib
import json
import os
import signal
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

torch.set_num_threads(2)


def flat_params(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from flat_params(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v.detach().cpu().numpy()


def digest(tree) -> str:
    h = hashlib.sha256()
    for k, v in sorted(flat_params(tree)):
        h.update(k.encode())
        h.update(np.ascontiguousarray(v).tobytes())
    return h.hexdigest()


def main() -> int:
    mode, rank, nprocs, port, workdir = sys.argv[1:6]
    rank, nprocs = int(rank), int(nprocs)
    args = sys.argv[6:]
    from helen_tpu_torch.parallel import multihost

    if mode == "cli":
        from helen_tpu_torch.cli import main as cli

        kill_after = int(os.environ.get("HELEN_TEST_KILL_AFTER", "0"))
        if kill_after and rank == 1:
            from helen_tpu_torch.io.prediction_store import PredictionStore

            write = PredictionStore.write_prediction
            count = [0]

            def write_then_die(self, *a, **k):
                wrote = write(self, *a, **k)
                count[0] += wrote
                if count[0] >= kill_after:
                    self.flush()
                    os.kill(os.getpid(), signal.SIGKILL)
                return wrote

            PredictionStore.write_prediction = write_then_die
        return cli(["--coordinator_address", f"127.0.0.1:{port}", "--num_processes",
                    str(nprocs), "--process_id", str(rank), *args])

    if mode == "collectives":
        os.environ.update(RANK=str(rank), WORLD_SIZE=str(nprocs), MASTER_ADDR="127.0.0.1",
                          MASTER_PORT=port)
        multihost.initialize(auto=True)
        assert (multihost.process_index(), multihost.process_count()) == (rank, nprocs)
        assert multihost.broadcast_name("predictions_x" if rank == 0 else "") == "predictions_x"
        assert multihost.broadcast_name("é" * 128 if rank == 0 else "") == "é" * 128
        # float32 on the wire, summed in rank order: the same bits everywhere
        loss = multihost.allsum_hosts(np.asarray([0.1 * (rank + 1)], dtype=np.float64))
        assert loss.dtype == np.float32
        want = np.float32(0.1) + np.float32(0.2)
        assert loss[0] == want, (loss, want)
        # counts past 2^24 summed exactly
        big = np.asarray([(1 << 40) + 3 + rank, 7, 0], dtype=np.float64)
        got = multihost.allsum_hosts_exact(big)
        assert got.dtype == np.int64
        assert got.tolist() == [(1 << 41) + 7, 7 * nprocs, 0], got
        t = torch.full((5,), float(rank + 1))
        assert multihost.allreduce_sum(t) is t and t.tolist() == [3.0] * 5
        assert multihost.host_image_shard(11) == ([0, 1, 2, 3, 4] if rank == 0
                                                  else [5, 6, 7, 8, 9, 10])
        assert multihost.host_file_shard(["b", "a", "c"]) == (["a", "c"] if rank == 0
                                                              else ["b"])
        multihost.barrier("collectives-done", timeout_s=60)
        multihost.shutdown()
        print(f"OK {rank}", flush=True)
        return 0

    if mode == "barrier":
        multihost.initialize(f"127.0.0.1:{port}", nprocs, rank)
        if rank == 0:
            t0 = time.monotonic()
            try:
                multihost.barrier("never-met", timeout_s=3.0)
            except TimeoutError as exc:
                assert "never-met" in str(exc), exc
                multihost.shutdown()
                print(f"TIMEOUT_RAISED {time.monotonic() - t0:.1f}", flush=True)
                return 0
            print("BARRIER_PASSED_UNEXPECTEDLY", flush=True)
            return 1
        time.sleep(120)  # the parent kills this process once process 0 has reported
        return 0

    if mode == "train":
        import dataclasses

        from helen_tpu_torch.config import TRAIN
        from helen_tpu_torch.train import train_loop
        from helen_tpu_torch.train.train_loop import Trainer
        from helen_tpu_torch.utils.filesystem import list_image_files

        multihost.initialize(f"127.0.0.1:{port}", nprocs, rank)
        digests = []
        step = train_loop.tbptt_step

        def step_and_digest(params, *a, **k):
            out = step(params, *a, **k)
            digests.append(digest(params))
            return out

        train_loop.tbptt_step = step_and_digest
        files = list_image_files(os.path.join(workdir, "train"))
        trainer = Trainer(files, files,
                          cfg=dataclasses.replace(TRAIN, batch_size=8, learning_rate=1e-3,
                                                  seed=7),
                          model_dir=os.path.join(workdir, "out", "models"),
                          stats_dir=os.path.join(workdir, "out", "stats"), num_workers=2,
                          retrain_model_path=os.path.join(workdir, "start.npz"),
                          device="cpu", pack=True)
        assert (trainer.n_procs, trainer.eff_batch, trainer.eff_local) == (nprocs, 8, 8 // nprocs)
        history = trainer.run(1)
        np.savez(os.path.join(workdir, f"rank{rank}.npz"), **dict(flat_params(trainer.params)))
        with open(os.path.join(workdir, f"rank{rank}.json"), "w") as f:
            json.dump({"digests": digests, "scheduler": trainer.scheduler.state_dict(),
                       "test_loss": history[0].test_loss,
                       "train_loss": history[0].train_loss}, f)
        multihost.barrier("train-done", timeout_s=120)
        multihost.shutdown()
        print(f"OK {rank}", flush=True)
        return 0

    raise SystemExit(f"unknown mode {mode}")


if __name__ == "__main__":
    sys.exit(main())
