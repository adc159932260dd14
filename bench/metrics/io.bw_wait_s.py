"""Seconds the save's shard-write tasks waited, ready, for storage
bandwidth: the ``bandwidth`` wait state of the runtime's own
``TraceRecorder`` summed over the ``_write_shard_task`` tasks."""


def read(run):
    return run.counters.get("io.bandwidth_wait_s")
