"""The check fails what it has to: the control (the reference in the next
precision below the cell's, in the program's place) and each fault the cell
can have, planted under the timed path, turn ``correct`` false, at a size a
test can hold (the cells' own limits)."""

import pytest
import tiny
import torch

from harness import check as C
from reference import sample as RS

CASES = [
    ("qm9_train", "control"), ("qm9_train", "unchanged"), ("qm9_train", "half_batch"),
    ("geom_sample", "control"), ("geom_sample", "answer"), ("geom_sample", "tail_bf16"),
]


@pytest.mark.parametrize("cell,fault", CASES)
def test_fault_turns_correct_false(cell, fault):
    line = tiny.result(cell, seconds=1.0, fault=fault)
    assert line["correct"] is False, (cell, fault, line["checks"])


@pytest.mark.cuda
def test_control_on_the_card_at_the_cells_size():
    """On a card: the qm9_train control at the cell's own size."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from harness import core

    import run

    s = run.make_spec("qm9_train", tiny.SEED, 1.0, False, fault="control")
    line = run.execute(s, core.cell_metrics(core.benchmark_spec(), "qm9_train"))
    assert line["correct"] is False


def test_a_stage_counts_where_the_reference_is_finite():
    """Rows where the reference leaves float32's range are left out; a run
    that leaves it where the reference does not reads inf."""
    mask = torch.ones(3, 2, 1)
    ref = torch.tensor([[[1.0], [2.0]], [[float("inf")], [0.0]], [[1.0], [1.0]]])
    run = torch.tensor([[[1.0], [2.5]], [[float("inf")], [0.0]], [[float("nan")], [1.0]]])
    num, unit, ok = RS._stage(run, ref, torch.full((3, 2, 1), 0.5), mask)
    assert ok.tolist() == [True, False, True]
    assert num[0] == 0.5 and num[1] == 0 and unit[1] == 0 and num[2] == float("inf")


def test_served_gap_treats_equal_non_finite_values_as_equal():
    x = torch.tensor([[float("nan"), float("inf"), 1.0]])
    t = torch.tensor([0, 1, 2])
    assert C.served_gap(x, x.clone(), t, t) == 0.0
    assert C.served_gap(x, torch.tensor([[0.0, float("inf"), 1.0]]), t, t) == float("inf")
    assert C.served_gap(x, x.clone(), t, t.roll(1)) == 3.0
