"""Share of a traced decode step the host spends issuing it: the port's
``model.decode`` range (``repro_torch.spans``: the host's time in
``Model.decode_step``, whose kernels run asynchronously) over the step's
``bench.decode`` mark (the call, the next tokens' argmax and their read
back), the median over the traced steps."""
from bench.lib.program_spans import ranges
from bench.lib.stats import median


def read(run):
    t = run.trace
    if t is None:
        return None
    dec = ranges(t, "model.decode")
    shares = []
    for _, m0, m1 in t.marks_named("bench.decode"):
        inner = [e - s for s, e in dec if m0 <= s and e <= m1]
        if inner:
            shares.append(100.0 * sum(inner) / (m1 - m0))
    return median(shares) if shares else None
