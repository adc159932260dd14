"""Share of its roofline the SSD scan kernel (K2) reached in the traced
prefills: per prefill one scan a layer at (batch, length / chunk, chunk,
heads, head dim, state), its ``ssd_bound`` summed over the layers, over
the device time of the kernels of the scan (names with ``ssd_``: the
16-bit route launches a C.B^T pass and the scan) in that prefill."""
from bench.lib.flops import ssd_bound


def read(run):
    t, c = run.trace, run.c
    if t is None:
        return None
    bound = dev = 0.0
    for m in t.marks_named("bench.prefill"):
        ks = [k for k in t.kernels_in(m) if "ssd_" in k[0]]
        if not ks:
            continue
        b, S = (int(x) for x in m[0].split(":")[1].split("x"))
        d_in = c["expand"] * c["d_model"]
        Q = c["chunk_size"]
        case = (b, S // Q, Q, d_in // c["headdim"], c["headdim"], c["d_state"])
        bound += c["n_layer"] * ssd_bound(case, c["dtype"])[0]
        dev += sum(e - s for _, s, e in ks) / 1e6
    return 100.0 * bound / dev if dev else None
