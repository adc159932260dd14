"""Share of their roofline the routed experts' grouped products reached in
the traced prefills: per prefill of b x S tokens, the bound of one MoE
layer (the larger of 6 T k D F FLOPs at the bf16 peak, exact since nothing
is dropped, and every expert's weights plus each routed row in and out once
at the memory rate; ``bench/models/granitemoehybrid.py``) times the layers,
over the device time of the kernels that carry the products in that prefill
(names with ``GroupedMM``/``grouped`` or CUTLASS's grouped GEMM: those of
``torch._grouped_mm``). None where no such kernel ran."""
from bench.lib.flops import HBM_BYTES_PER_S, PEAK_FLOPS

#: parts of the names of the kernels that carry the grouped products
KERNELS = ("grouped", "Grouped", "GroupProblemShape")


def read(run):
    t, c = run.trace, run.c
    if t is None:
        return None
    from bench.models.granitemoehybrid import moe_gemm_bytes, moe_gemm_flops
    bound = dev = 0.0
    for m in t.marks_named("bench.prefill"):
        ks = [k for k in t.kernels_in(m) if any(s in k[0] for s in KERNELS)]
        if not ks:
            continue
        b, S = (int(x) for x in m[0].split(":")[1].split("x"))
        one = max(moe_gemm_flops(c, b * S) / PEAK_FLOPS[c["dtype"]],
                  moe_gemm_bytes(c, b * S) / HBM_BYTES_PER_S)
        bound += c["num_hidden_layers"] * one
        dev += sum(e - s for _, s, e in ks) / 1e6
    return 100.0 * bound / dev if dev else None
