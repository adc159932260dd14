"""The yardstick's counts against hand counts at small shapes."""
import pytest
import torch

from bench.lib import flops


def brute_pairs(S, causal, window):
    q, k = torch.arange(S)[:, None], torch.arange(S)[None, :]
    m = (k <= q) if causal else torch.ones((S, S), dtype=torch.bool)
    if window:
        m = m & (k > q - window)
    return int(m.sum())


@pytest.mark.parametrize("S,causal,window", [(1, True, 0), (7, True, 0), (64, True, 0),
                                             (64, True, 16), (64, False, 0), (33, False, 5),
                                             (10, True, 10), (10, True, 30)])
def test_flash_bound_counts_the_mask(S, causal, window):
    B, H, KV, hd = 2, 4, 2, 8
    t, by = flops.flash_bound((B, S, H, KV, hd, causal, window), "bfloat16")
    work = 4 * hd * brute_pairs(S, causal, window) * B * H
    traffic = B * S * (2 * H + 2 * KV) * hd * 2
    assert t == max(work / 989e12, traffic / 3.35e12)
    assert by == ("operations" if work / 989e12 >= traffic / 3.35e12 else "bytes")


def test_flash_bound_at_the_train_shape():
    # smollm-360m, 8 x 2048: 4 * 64 * (2048 * 2049 / 2) * 8 * 15 FLOPs at 989 TFLOP/s
    t, by = flops.flash_bound((8, 2048, 15, 5, 64, True, 0), "bfloat16")
    assert by == "operations"
    assert t == pytest.approx(4 * 64 * 2098176 * 120 / 989e12, rel=1e-12)


def test_ssd_counts_by_hand():
    b, nc, Q, H, P, N = 1, 1, 2, 1, 1, 1
    # C.B^T on 3 causal pairs (3 FLOP-pairs of N=1), intra 3 pairs x P, inter Q*N*P
    # twice (read-out and state update): 2 * (3 + (3 + 2 * 2)) = 20
    assert flops.ssd_flops((b, nc, Q, H, P, N)) == 20
    t, by = flops.ssd_bound((b, nc, Q, H, P, N), "float32")
    nbytes = 2 * 2 * 4 + 4 * (2 * 2 + 2 * 2 + 1 + 1)
    assert t == max(20 / 67e12, nbytes / 3.35e12) and by == "bytes"


def test_ssd_bound_at_the_serving_shape_is_bound_by_bytes():
    t, by = flops.ssd_bound((4, 4, 256, 80, 64, 128), "bfloat16")
    assert by == "bytes"
    assert t * 1e3 == pytest.approx(0.0302, abs=5e-5)    # chip_smoke's, PERF.md section 6


LLAMA = {"hidden_size": 8, "num_hidden_layers": 2, "num_attention_heads": 2,
         "num_key_value_heads": 1, "intermediate_size": 16, "vocab_size": 10}


def test_llama_flops_by_hand():
    # per token and layer: q 8x8, k 8x4, v 8x4, o 8x8, mlp 3 x 8x16 = 64+32+32+64+384 = 576
    # multiply-adds; logits 8x10 = 80; attention per layer: 2 heads x 2 products x
    # hd 4 x pairs (3 for S=2)
    per_token = 2 * 576 + 80
    attn = 2 * 2 * 2 * 4 * 3 * 2       # layers x heads x products x hd x pairs x 2 FLOPs
    assert flops.llama_forward_flops(LLAMA, 1, 2) == 2 * per_token * 2 + attn
    assert flops.llama_train_flops(LLAMA, 3, 2) == 3 * 3 * (2 * per_token * 2 + attn)


MAMBA = {"d_model": 4, "n_layer": 1, "expand": 2, "headdim": 4, "d_state": 2, "d_conv": 4,
         "chunk_size": 2, "vocab_size": 5}


def test_mamba2_flops_by_hand():
    # d_in 8, H 2: projections 4 x (8 + 8 + 4 + 2) + 8 x 4 = 120 multiply-adds,
    # conv 4 x (8 + 4) = 48
    proj_conv = 2 * (120 + 48)
    scan = flops.ssd_flops((1, 2, 2, 2, 4, 2))
    assert flops.mamba2_prefill_flops(MAMBA, 1, 4) == proj_conv * 4 + scan + 2 * 4 * 5
    # decode: projections, conv and 2 x H x N x P (update and read-out) = 2 x 2 x 2 x 4 = 32
    assert flops.mamba2_decode_flops(MAMBA, 3) == 3 * (2 * (120 + 48 + 32) + 2 * 4 * 5)
