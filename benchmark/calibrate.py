"""Readings that the limits of ``correct`` are set from, for one cell, on the
GPU, in one process:

    python benchmark/calibrate.py --workload <cell> --seeds 101-112 \
        --control 3 --faults 3 --seconds 8

For each seed: the cell's set-up, a window of ``--seconds`` (none for
training, whose readings need none) and the comparison, as a run makes
them: the program's sound readings. For the first ``--control`` seeds also
the control's: the reference computed with TF32 operands, put in the
program's place. With ``--faults N``, each fault of :data:`FAULTS` is
planted in the program and read on the first N seeds. One JSON line per
reading, then a summary line: the largest sound reading of each number, the
smallest control and fault readings, and the verdict of the cell's limits
on each control and fault reading (``correct`` has to come out false on
every one). ``limits/<cell>.json`` is set from them. The benchmark's own runs plant nothing.

:func:`planted` is the tests' way in too (``tests/test_gpubench_correct.py``).
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time
from typing import Dict, Iterator

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from benchmark.lib import cells, compare, harness  # noqa: E402


@contextlib.contextmanager
def _patched(owner, name: str, make) -> Iterator[None]:
    original = getattr(owner, name)
    setattr(owner, name, make(original))
    try:
        yield
    finally:
        setattr(owner, name, original)


def _hidden_kept(forward):
    """Each window returns the hidden state it was given."""
    def wrapped(params, x, hidden, *args, **kwargs):
        base, rle, _ = forward(params, x, hidden, *args, **kwargs)
        return base, rle, hidden
    return wrapped


def _half_labelled(consensus_labels):
    """Only the first half of each batch is computed; the rest reads 0."""
    import torch

    def wrapped(params, images, *args, **kwargs):
        half = images.shape[0] // 2
        base, rle = consensus_labels(params, images[:half], *args, **kwargs)
        rest = images.shape[0] - half
        return tuple(torch.cat([t, t.new_zeros((rest,) + t.shape[1:])]) for t in (base, rle))
    return wrapped


def _label_altered(read):
    """One label of every image is changed as it is read back."""
    def wrapped(self, handle):
        base, *rest = read(self, handle)
        base = base.copy()
        rows = range(base.shape[0])
        cols = [r % base.shape[1] for r in rows]
        base[rows, cols] = (base[rows, cols] + 1) % 5
        return (base, *rest)
    return wrapped


def _adam_idle(update):
    """Adam leaves the parameters and its state as they are."""
    def wrapped(self, params, grads, state, lr):
        return None
    return wrapped


def _half_batch(tbptt_step):
    """The losses' means are taken over the first half of the batch's rows."""
    def wrapped(params, adam, opt_state, lr, images, label_base, label_rle, valid, *a, **kw):
        return tbptt_step(params, adam, opt_state, lr, images, label_base, label_rle,
                          valid // 2, *a, **kw)
    return wrapped


def _loss_altered(tbptt_step):
    """The batch's loss sum leaves one of its 19 windows out."""
    def wrapped(*args, **kwargs):
        tot, tb, tr = tbptt_step(*args, **kwargs)
        return tot * (18.0 / 19.0), tb, tr
    return wrapped


def _owners():
    from helen_tpu_torch.infer.consensus import ConsensusStep
    from helen_tpu_torch.models import transducer
    from helen_tpu_torch.train import train_loop

    return transducer, ConsensusStep, train_loop


#: per task, the faults a cell of it can have, as (what is patched, how):
#: a step that returns its state unchanged, half of the batch left out, an
#: answer altered where it is produced (one chip: no exchange to leave out)
FAULTS = {
    "consensus": {"state_unchanged": ("transducer", "forward", _hidden_kept),
                  "half_batch": ("transducer", "consensus_labels", _half_labelled),
                  "answer_altered": ("ConsensusStep", "read", _label_altered)},
    "train": {"state_unchanged": ("train_loop.Adam", "update", _adam_idle),
              "half_batch": ("train_loop", "tbptt_step", _half_batch),
              "answer_altered": ("train_loop", "tbptt_step", _loss_altered)},
}


@contextlib.contextmanager
def planted(task: str, fault: str) -> Iterator[None]:
    """The program with ``fault`` planted underneath the benchmark."""
    transducer, step_cls, train_loop = _owners()
    owners = {"transducer": transducer, "ConsensusStep": step_cls, "train_loop": train_loop,
              "train_loop.Adam": train_loop.Adam}
    owner, name, make = FAULTS[task][fault]
    with _patched(owners[owner], name, make):
        yield


def reading(bench: Dict, cell: str, seed: int, seconds: float, device, control: bool = False,
            traffic_overrides=None, config_overrides=None):
    """The compared numbers of one seed (and the control's), as a run makes them."""
    run = harness.Run(bench, cell, seed, seconds, False, device, traffic_overrides,
                      config_overrides)
    run.control = control
    state = run.task.setup(run)
    if seconds > 0:
        run.task.window(run, state)
    numbers = run.task.check(run, state)
    return numbers, getattr(run, "control_numbers", None), run.info


def _seeds(text: str):
    a, _, b = text.partition("-")
    return list(range(int(a), int(b or a) + 1))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="first-last")
    p.add_argument("--control", type=int, default=3)
    p.add_argument("--faults", type=int, default=0)
    p.add_argument("--seconds", type=float, default=0.0)
    args = p.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("calibrate: no CUDA GPU", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    bench = cells.load_benchmark()
    task = cells.traffic(cells.cell(bench, args.workload)["traffic"])["task"]
    print(f"card: {harness.card_label()}", flush=True)
    sound, low, faults = {}, {}, {}
    limits = cells.limits(args.workload)
    judged = []  # (seed, what was planted, correct by the cell's limits)
    seeds = _seeds(args.seeds)
    for i, seed in enumerate(seeds):
        t0 = time.perf_counter()
        numbers, control, info = reading(bench, args.workload, seed, args.seconds, device,
                                         control=i < args.control)
        print(json.dumps({"seed": seed, "sound": numbers, "control": control, "info": info,
                          "s": time.perf_counter() - t0}), flush=True)
        for k, v in numbers.items():
            sound[k] = max(sound.get(k, v), v)
        for k, v in (control or {}).items():
            low[k] = min(low.get(k, v), v)
        if control is not None:
            judged.append((seed, "control", compare.verdict(control, limits)[0]))
    for fault in FAULTS[task] if args.faults else ():
        for seed in seeds[:args.faults]:
            with planted(task, fault):
                numbers, _, info = reading(bench, args.workload, seed, args.seconds, device)
            print(json.dumps({"seed": seed, "fault": fault, "numbers": numbers}), flush=True)
            judged.append((seed, fault, compare.verdict(numbers, limits)[0]))
            for k, v in numbers.items():
                faults.setdefault(fault, {})[k] = min(faults.get(fault, {}).get(k, v), v)
    print(json.dumps({"cell": args.workload, "seeds": len(seeds), "sound_max": sound,
                      "control_min": low, "fault_min": faults, "limits": limits,
                      "correct_by_limits": judged}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
