"""Tiny copies of the cells, for runs on the CPU."""
import copy

from bench.lib import harness


def tiny_cell(cell: str, dtype: str = "bfloat16"):
    """(config file, traffic file) of ``cell`` at a size the CPU runs in a
    second: every width and count cut, the kinds of layer and the traffic's
    shape kept."""
    _, c, tr = harness.cell_files(cell)
    c, tr = copy.deepcopy(c), copy.deepcopy(tr)
    c["dtype"] = dtype
    if c["model_type"] == "llama":
        c.update(hidden_size=64, intermediate_size=128, num_hidden_layers=2,
                 num_attention_heads=4, num_key_value_heads=2, vocab_size=256)
        tr.update(batch=4, seq=32)
    else:
        c.update(d_model=64, n_layer=2, d_state=16, headdim=16, chunk_size=8, vocab_size=253)
        tr.update(batch=3, max_new=4, check_tokens=200)
        if "log_uniform" in tr["prompt_len"]:
            tr["prompt_len"] = {"log_uniform": [8, 64], "multiple": 8, "strata": 4}
        else:
            tr["prompt_len"] = {"fixed": 16}
    return c, tr


def cpu_run(cell: str, seed: int = 2**31 + 7, seconds: float = 1.0, **kw):
    c, tr = tiny_cell(cell, **kw)
    run = harness.Run(cell, c, tr, seed, seconds, False, "cpu")
    harness.execute(run)
    return run
