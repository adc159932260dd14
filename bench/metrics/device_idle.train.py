"""Share of the traced train steps' region in which no operation ran on the
device."""


def read(run):
    t = run.trace
    if t is None or not t.kernels or not t.marks_named("bench.train_step"):
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
