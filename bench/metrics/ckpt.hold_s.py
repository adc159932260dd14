"""Seconds the save held the loop: the benchmark's span around
``CheckpointManager.save`` (host copy and submission of the shard writes)."""


def read(run):
    saves = run.spans.of("ckpt.save")
    return saves[0]["t1"] - saves[0]["t0"] if saves else None
