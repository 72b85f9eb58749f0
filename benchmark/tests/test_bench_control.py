"""The comparison that decides ``correct`` fails what it has to: the
control (the reference in TF32, where the configuration states float32
with TF32 off, put in the program's place) and a run whose timed path is
broken underneath, each through the run's own comparison on the CPU at a
tiny size.  The control's readings at the cells' own size are
``benchmark/control.py``'s, on the card."""

import pytest

from benchmark import control
from benchmark import run as bench
from benchmark.harness import cells

WORKLOADS = [w["name"] for w in cells.spec()["workloads"]]


@pytest.mark.parametrize("workload", WORKLOADS)
def test_the_control_fails(workload):
    cell = cells.load(workload)
    for seed in (1, 2**40 + 3, 77):
        res = bench.run(workload, seed, 0.2, False, device="cpu", batch=4,
                        ring=4, wrap=control.tf32_in_place(cell),
                        log=lambda m: None)
        assert not res["correct"], res["checks"]
        assert res["failed"] > 0


def _outputs(y, fn):
    return {k: fn(v) for k, v in y.items()} if isinstance(y, dict) \
        else fn(y)


def state_unchanged(step, prog, xs):
    def f(params, state, x, reset=None):
        _, y = step(params, state, x, reset)
        return state, y
    return f


def half_batch(step, prog, xs):
    def copy_half(v):
        v = v.clone()
        b = v.shape[-2]
        v[..., b // 2:, :] = v[..., : b // 2, :]
        return v

    def f(params, state, x, reset=None):
        state, y = step(params, state, x, reset)
        return state, _outputs(y, copy_half)
    return f


def altered_answer(step, prog, xs):
    def alter(v):
        v = v.clone()
        v[..., 0, -1] += 1e-3 * v.abs().max()
        return v

    def f(params, state, x, reset=None):
        state, y = step(params, state, x, reset)
        return state, _outputs(y, alter)
    return f


@pytest.mark.parametrize("fault", [state_unchanged, half_batch,
                                   altered_answer])
@pytest.mark.parametrize("workload", WORKLOADS)
def test_a_broken_step_is_not_correct(workload, fault):
    res = bench.run(workload, 2**35 + 9, 0.2, False, device="cpu", batch=2,
                    ring=4, wrap=fault, log=lambda m: None)
    assert not res["correct"], res["checks"]
    assert res["failed"] > 0
