"""The paper's overlap of a save: 1 - (hold + final wait) / (save to commit),
save to commit being the hold plus the manifest's ``save_seconds`` (from the
end of the host copy to the commit)."""


def read(run):
    saves, waits = run.spans.of("ckpt.save"), run.spans.of("ckpt.wait")
    if not saves or "ckpt.save_seconds" not in run.counters:
        return None
    hold = saves[0]["t1"] - saves[0]["t0"]
    wait = waits[0]["t1"] - waits[0]["t0"] if waits else 0.0
    return 1.0 - (hold + wait) / (hold + run.counters["ckpt.save_seconds"])
