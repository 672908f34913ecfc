"""``correct`` comes out false when the timed path is broken underneath,
and when the control arithmetic takes the program's place.  The runs
skip the look for a card and run the rest on the CPU at a small size."""

import pytest

from helpers import small_cell


@pytest.fixture(autouse=True)
def few_threads():
    import torch

    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.mark.parametrize("workload", ["drb1-rspoa-exact.short100", "drb1-abpoa.short100"])
def test_sound_run_is_correct(workload):
    from vgbench import run

    out = run.execute(small_cell(workload), 11, 0.5, False, device="cpu", batch=32)
    assert out["correct"] and out["failed"] == 0
    assert list(out)[-1] == "checks"
    assert set(out["metrics"]) == {"reads_per_s", "peak_device_mib", "setup_s"}
    exports = {"export_files_wrong", "export_gfa_differing"}
    assert (exports <= set(out["checks"])) == (workload == "drb1-abpoa.short100")


@pytest.mark.parametrize("workload,fault,check", [
    ("drb1-abpoa.short100", "answer_altered", "chain_rows_differing"),
    ("drb1-abpoa.short100", "half_batch", "reads_missing"),
    ("drb1-abpoa.short100", "export_skipped", "export_files_wrong"),
    ("drb1-abpoa.short100", "export_altered", "export_gfa_differing"),
    ("drb1-abpoa.maponly100", "answer_altered", "chain_rows_differing"),
    ("drb1-abpoa.maponly100", "half_batch", "reads_missing"),
])
def test_fault_is_not_correct(workload, fault, check):
    from vgbench import run

    out = run.execute(small_cell(workload), 12, 0.5, False, device="cpu", fault=fault, batch=32)
    assert not out["correct"]
    assert out["failed"] > 0
    assert out["checks"][check]["value"] > 0


def test_exchange_left_out_is_not_correct():
    from vgbench import run

    out = run.execute(small_cell("drb1-abpoa-t4.short100"), 13, 0.5, False, device="cpu",
                      fault="no_exchange", batch=32)
    assert not out["correct"]
    assert out["checks"]["reads_missing"]["value"] > 0


@pytest.mark.parametrize("workload", ["drb1-abpoa.short100", "drb1-abpoa.maponly100"])
def test_control_is_not_correct(workload):
    """The control at a size a test run holds: the reference in int16,
    the arithmetic one step below the configuration's int32, in the
    program's place.  int16 differs on about one read in a thousand, so
    its run compares the chains of 4,096 reads of a seed on which it
    differs (and aligns 16 of them)."""
    from vgbench import run

    cell = small_cell(workload, backbone_len=22600, chain_sample=4096, max_reads_per_s=4096,
                      alignment_sample=16)
    out = run.execute(cell, 2 ** 31 + 21, 0.3, False, device="cpu", control="int16", batch=4096)
    assert not out["correct"]
    assert out["checks"]["chain_rows_differing"]["value"] > 0
