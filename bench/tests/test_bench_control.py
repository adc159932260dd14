"""The lower-precision control (the reference put in the program's place,
every matrix product's operands in fp8) must come out not correct. At the
cells' own sizes on the card, three seeds each; on the CPU at a tiny size
the control of a training cell reads further from the reference than the
bf16 program does."""
import pytest

from bench import calibrate
from bench.lib import harness
from bench.tests.tiny import cpu_run, tiny_cell

CELLS = [w["name"] for w in harness.manifest()["workloads"]]
SEEDS = (3_000_000_101, 3_000_000_102, 3_000_000_103)


def test_train_control_reads_above_the_program_at_tiny_size():
    cell = "smollm-360m.train"
    program = cpu_run(cell).readings
    c, tr = tiny_cell(cell)
    control = calibrate.train_readings(c, tr, 2**31 + 7, "cpu")["control"]
    assert control["loss_gap"] > 3 * program["loss_gap"]
    assert control["grad_gap"] > 3 * program["grad_gap"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct_at_the_cell_size(cell):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("the control runs at the cell's own size, on a CUDA device")
    _, c, tr = harness.cell_files(cell)
    for seed in SEEDS:
        if tr["driver"] == "train":
            readings = calibrate.train_readings(c, tr, seed, "cuda")["control"]
        else:
            readings = calibrate.serve_readings(cell, c, tr, seed, 25.0, "cuda")["control"]
        ok, checks = harness.judge(readings, {k: v for k, v in c["limits"].items()
                                              if k in readings})
        assert not ok, (seed, checks)
