"""Multi-process jobs: helen_tpu's parallel.multihost on torch.distributed
(gloo), and the launcher that runs one worker process per local device."""
