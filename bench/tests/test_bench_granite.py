"""granite-4.0-h-small's files: the plain reference against the port at a
tiny size on the CPU (one tiny run of the cell's driver), a tiny run whose
served tokens are altered coming out not correct, the counts its metrics
use against hand counts, and the three new readers on hand-built traces."""
import copy
from types import SimpleNamespace

import pytest
import torch

from bench.lib import harness
from bench.lib.flops import HBM_BYTES_PER_S, PEAK_FLOPS, ssd_flops
from bench.lib.trace import DeviceTrace
from bench.models import granitemoehybrid as g

CELL = "granite-4.0-h-small.serve_rag"
_, C, TR = harness.cell_files(CELL)
#: one layer's multiply-adds a token, counted by hand from the published
#: widths: the Mamba2 projections (in 4096 x (2 x 8192 + 2 x 128 + 128), out
#: 8192 x 4096) and its conv (4 x 8448); attention (4096 x 48 x 128 in, 4096 x
#: 4096 out); the MoE (10 experts x 3 x 4096 x 768, shared 3 x 4096 x 1536,
#: router 4096 x 72)
MAMBA, CONV, ATTN = 102_236_160, 33_792, 41_943_040
MOE = 94_371_840 + 18_874_368 + 294_912


def tiny():
    c, tr = copy.deepcopy(C), copy.deepcopy(TR)
    c.update(hidden_size=64, num_attention_heads=4, num_key_value_heads=2, mamba_n_heads=8,
             mamba_d_head=16, mamba_d_state=16, mamba_chunk_size=8, num_local_experts=8,
             num_experts_per_tok=3, intermediate_size=32, shared_intermediate_size=48,
             vocab_size=256, num_hidden_layers=10, attention_multiplier=1 / 16)
    tr.update(batch=3, max_new=4, check_tokens=200,
              prompt_len={"log_uniform": [8, 64], "multiple": 8, "strata": 4})
    return c, tr


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_a_tiny_run_serves_what_the_reference_serves(dtype):
    c, tr = tiny()
    c["dtype"] = dtype
    run = harness.Run(CELL, c, tr, 2**31 + 7, 1.0, False, "cpu")
    harness.execute(run)
    assert run.attempted > 0 and run.finished
    # float32: the same mathematics in another order; bf16: its rounding
    assert run.readings["token_gap"] <= (1e-5 if dtype == "float32" else C["limits"]["token_gap"])


def test_altered_token_is_not_correct(monkeypatch):
    """Every request's next token altered where the decode step produces it
    (the fault ``test_bench_faults.py`` plants in the other serve cells): the
    reference's logit of a served token then lies under its best by more
    than the cell's ``token_gap`` limit, and the run is not correct."""
    from repro_torch.models import Model
    orig = Model.decode_step

    def decode_step(self, params, state, tokens):
        logits, state = orig(self, params, state, tokens)
        logits = logits.clone()
        rows = torch.arange(logits.shape[0])
        alt = (logits.argmax(-1) + 1) % logits.shape[-1]
        logits[rows, alt] = logits.max(-1).values + 1.0
        return logits, state

    c, tr = tiny()
    # the logits of a width of 64 spread ~8x less than at the cell's 4096
    # (the embedding is drawn alike); undivided by 16, ~2x more
    c["logits_scaling"] = 1.0
    for fault in (False, True):
        if fault:
            monkeypatch.setattr(Model, "decode_step", decode_step)
        run = harness.Run(CELL, c, tr, 2**31 + 7, 1.0, False, "cpu")
        harness.execute(run)
        assert run.attempted > 0 and run.failed == 0 and run.finished
        ok, checks = harness.judge(run.readings, c["limits"])
        assert ok != fault, checks


def test_counts_against_hand_counts():
    L = C["num_hidden_layers"]
    assert g.layer_types(C).count("attention") == 2 and L == 20
    assert g.moe_gemm_flops(C, 1000) == 6 * 1000 * 10 * 4096 * 768
    assert g.moe_gemm_bytes(C, 1000) == 2 * (3 * 72 * 4096 * 768 + 2 * 10_000 * 4096)
    S = 256
    want = (18 * 2 * S * (MAMBA + CONV + MOE) + 2 * 2 * S * (ATTN + MOE)
            + 18 * ssd_flops((1, 1, 256, 128, 64, 128)) + 2 * 4 * 128 * 32 * (S * (S + 1) // 2)
            + 2 * 4096 * 100352)
    assert g.prefill_flops(C, 1, S) == want
    step = (18 * 2 * (MAMBA + CONV + MOE + 2 * 128 * 128 * 64) + 2 * 2 * (ATTN + MOE)
            + 2 * 4 * 128 * 32 * 3001 + 2 * 4096 * 100352)
    assert g.decode_flops(C, 2, 3000) == 2 * step


PRE, DEC = "bench.prefill:8x2048", "bench.decode:8"
GROUPED = "void cutlass::device_kernel<GroupProblemShape>"


def trace(moe_ranges=True, grouped=True):
    """A prefill (0-100 us) with two grouped-product kernels of 10 us and one
    other, then two decode steps (100-150, 150-200) whose MoE ranges hold
    three and two launch calls; one launch call inside a decode step lies
    outside the MoE ranges and one inside the prefill's."""
    kernels = [(GROUPED if grouped else "gemm", 10, 20), (GROUPED if grouped else "gemm", 30, 40),
               ("elementwise", 50, 90), ("k", 110, 140), ("k", 160, 190)]
    host = [("cudaLaunchKernel", 11, 12), ("cudaLaunchKernel", 112, 113),
            ("cudaLaunchKernelExC", 114, 115), ("cuLaunchKernel", 116, 117),
            ("cudaLaunchKernel", 130, 131), ("cudaLaunchKernel", 161, 162),
            ("cudaLaunchKernel", 163, 164), ("aten::mm", 115, 116)]
    if moe_ranges:
        host += [("moe.route", 5, 15), ("moe.route", 110, 113), ("moe.experts", 113, 120),
                 ("moe.route", 160, 165)]
    return DeviceTrace(kernels, [(PRE, 0, 100), (DEC, 100, 150), (DEC, 150, 200)], host)


def reader(name):
    return harness.metric_reader(name)


def test_moe_gemm_roofline_reads_the_grouped_kernels():
    got = reader("moe_gemm_roofline")(SimpleNamespace(trace=trace(), c=C))
    T = 8 * 2048
    bound = 20 * max(g.moe_gemm_flops(C, T) / PEAK_FLOPS["bfloat16"],
                     g.moe_gemm_bytes(C, T) / HBM_BYTES_PER_S)
    assert got == pytest.approx(100 * bound / 20e-6)


def test_mfu_serve_hybrid_counts_each_step_at_its_context():
    got = reader("mfu.serve_hybrid")(SimpleNamespace(trace=trace(), c=C))
    flops = g.prefill_flops(C, 8, 2048) + g.decode_flops(C, 8, 2048) \
        + g.decode_flops(C, 8, 2049)
    assert got == pytest.approx(100 * flops / (200e-6 * PEAK_FLOPS["bfloat16"]))


def test_moe_launch_calls_per_decode_step():
    assert reader("moe.launch_calls")(SimpleNamespace(trace=trace())) == pytest.approx(5 / 2)


@pytest.mark.parametrize("name,run", [
    ("moe_gemm_roofline", SimpleNamespace(trace=None, c=C)),
    ("moe_gemm_roofline", SimpleNamespace(trace=trace(grouped=False), c=C)),
    ("mfu.serve_hybrid", SimpleNamespace(trace=None, c=C)),
    ("moe.launch_calls", SimpleNamespace(trace=None)),
    ("moe.launch_calls", SimpleNamespace(trace=trace(moe_ranges=False))),
], ids=["roofline-untraced", "roofline-no-grouped-kernel", "mfu-untraced", "calls-untraced",
        "calls-no-moe-ranges"])
def test_none_without_what_they_read(name, run):
    assert reader(name)(run) is None
