"""Whole runs at the tiny size on the CPU: a sound run comes out correct,
and the control and every fault of the timed path come out not correct.
The card's own readings, at the cells' sizes, come from
``bench/control.py``."""
import pytest
import torch

from bench import controls
from bench.tests import tiny

INGEST, SERVE = "smscc-1m.ingest", "smscc-1m.reach-serve"


@pytest.mark.parametrize("cell", [INGEST, SERVE])
@pytest.mark.parametrize("trace", [False, True])
def test_a_sound_run_is_correct(cell, trace):
    result, lines = tiny.run(cell, trace=trace)
    assert result["correct"], result["checks"]
    assert result["failed"] == 0 and result["attempted"] > 0
    assert lines == [f"check {k} 0 limit 0" for k in result["checks"]]
    assert list(result)[-1] == "checks"
    if trace:
        assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert result["metrics"]["setup_s"]["value"] > 0


@pytest.mark.parametrize("cell,name,caught_by", [
    (INGEST, "repair_skipped", "partition_mismatches"),
    (SERVE, "stale_reads", "reach_mismatches"),
    (INGEST, "state_unchanged", "ack_mismatches"),
    (SERVE, "state_unchanged", "ack_mismatches"),
    (INGEST, "half_batch", "ack_mismatches"),
    (SERVE, "half_batch", "ack_mismatches"),
    (INGEST, "ack_altered", "ack_mismatches"),
    (SERVE, "answer_altered", "reach_mismatches"),
])
def test_a_broken_run_is_not_correct(cell, name, caught_by):
    with controls.broken(name):
        result, _ = tiny.run(cell, seed=11)
    assert not result["correct"]
    assert result["checks"][caught_by]["value"] > 0


@pytest.mark.gpu
@pytest.mark.parametrize("cell", [INGEST, SERVE])
def test_the_tiny_cells_on_the_card(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    result, _ = tiny.run(cell, device="cuda")
    assert result["correct"], result["checks"]
    with controls.broken("ack_altered"):
        result, _ = tiny.run(cell, device="cuda")
    assert not result["correct"]
