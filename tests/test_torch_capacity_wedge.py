"""The runtime core's capacity-tier wedge, pinned, and the fixed Hypothesis
sample that tier-1 draws, checked.

The port runs the runtime core byte-identical to the reference
(test_torch_runtime_copy.py), so a fault of the reference's core is the
port's too. The cases below run the reference's copy through the property
harness of test_properties.py, on the capacity cluster that found them.
"""
import pytest
from hypothesis_support import HAVE_HYPOTHESIS, settings
from test_properties import (make_capacity_cluster, normalize, run_recipe,
                             run_recipe_failed)

from repro.core import SchedulerError

# Feasible DAGs (rt.lint() is silent on them) that the capacity/eviction
# path wedges on make_capacity_cluster: one I/O task stays ready with
# nothing running, and assert_not_stuck raises SchedulerError at the final
# barrier. The recipes are the minimal examples Hypothesis shrank the
# random-DAG properties to, before normalize; the flag says whether the
# run injects faults (run_recipe_failed, fault seed 110).
WEDGES = {
    # test_capacity_launch_order_deterministic
    "W1": (False, [("C", 0, 1, 0, 0, False)] * 11 +
           [("S", 0, 38, 0, 2, False), ("S", 0, 38, 0, 2, False),
            ("A", 0, 19, 0, 2, False), ("S", 0, 34, 0, 2, False)]),
    # test_failure_invariants_random_dags
    "W2": (True, [("S", 0, 33, 0, 2, False), ("A", 1, 26, 0, 2, False),
                  ("C", 0, 1, 0, 0, False), ("C", 1, 36, 0, 0, False),
                  ("S", 0, 33, 0, 2, False), ("S", 1, 37, 0, 2, False)]),
    # test_capacity_invariants_random_dags
    "W3": (False, [("S", 0, 14, 0, 0, False), ("C", 0, 1, 0, 0, False),
                   ("A", 0, 1, 0, 2, False), ("S", 1, 16, 0, 0, False),
                   ("S", 0, 30, 4, 0, False), ("S", 0, 15, 0, 0, False),
                   ("A", 0, 15, 0, 1, False), ("A", 2, 35, 0, 0, False)]),
}


@pytest.mark.xfail(strict=True, raises=SchedulerError,
                   reason="ROADMAP Queue 3 fault H: the capacity path "
                          "wedges a feasible DAG")
@pytest.mark.parametrize("name", sorted(WEDGES))
def test_capacity_wedge(name):
    """No task lost or stuck on the wedging recipes. Strict: once the core
    drains a recipe, its case fails until the mark is removed."""
    failed, recipe = WEDGES[name]
    recipe = normalize(recipe)
    if failed:
        rt = run_recipe_failed(recipe, make=make_capacity_cluster,
                               seed=110)[0]
    else:
        rt = run_recipe(recipe, make=make_capacity_cluster)[0]
    assert rt.graph.unfinished == 0


def test_hypothesis_sample_fixed(request):
    """Unless a profile is named on the command line, the loaded profile
    (conftest.py at the root) draws a fixed sample and keeps no example
    database."""
    if HAVE_HYPOTHESIS and request.config.getoption(
            "--hypothesis-profile", None) is None:
        assert settings.default.derandomize
        assert settings.default.database is None
