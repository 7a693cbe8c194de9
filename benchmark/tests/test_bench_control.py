"""The controls, at a size the CPU holds: one precision below what each
configuration states, a run must come out not correct.

For every cell the control is the plain reference put in the program's
place (the Gram's operands rounded to ``precision.control_gram``, the
hyperparameters' statistics and the held-out forward in
``precision.control_float``): the run that judges it must come out not
correct, while the program's own numbers of the same run pass.  At rank 32 the program has such a path of its own, the "bf16"
Gram mode one step below the "split" its configuration states: a run
with it must be refused."""

import time

import pytest
from conftest import TINY
from fmbench import cell, registry

SPEC = registry.load_spec()


def run(workload, **kw):
    return cell.run_cell(workload, 2 ** 31 + 5, 0.5, False,
                         time.perf_counter(), device="cpu", overrides=TINY,
                         **kw)


@pytest.mark.parametrize("workload", [w["name"] for w in SPEC["workloads"]])
def test_reference_one_precision_below_fails_a_limit(workload):
    result, observed = run(workload, control=True)
    program = observed["program_checks"]
    assert all(c["value"] <= c["limit"] for c in program.values()), program
    assert set(result["checks"]) == set(program)
    assert not result["correct"], result["checks"]
    over = {k: c["value"] / c["limit"] for k, c in result["checks"].items()
            if c["limit"]}
    assert max(over.values()) > 1.0, over


def test_program_in_its_bf16_mode_fails_the_rank32_limits():
    result, _ = run("ml10m_r32.chain", force_gram="bf16")
    assert not result["correct"], result["checks"]
