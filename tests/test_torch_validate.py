"""The port's model validation (``radiorust_tpu_torch/validate.py``): each
of the 15 models of ``tools/validate_tpu.py``, bound by the same builder in
both packages, on the same numpy inputs, through the JAX package (Pallas in
interpret mode, matmuls at ``highest``) and through the port on CPU
tensors, compared by the port's fingerprint within the model's ``TOL``
(the reference's table).  No batch, chunk length or IR length is cut.
Also the fingerprint itself, and the command line on the CPU."""

import ast
import importlib
import json
import pathlib

import numpy as np
import pytest
import torch

import jax.experimental.pallas as pl
import jax.numpy as jnp

from radiorust_tpu import config
from radiorust_tpu.blocks.base import scan as jscan
from radiorust_tpu.blocks.graph import graph_scan as jgraph_scan
from radiorust_tpu_torch import validate
from radiorust_tpu_torch.validate import (MODELS, TOL, build, fingerprint,
                                          output_leaves, steady_rel)


@pytest.fixture(autouse=True)
def interpret_pallas_highest(monkeypatch):
    orig = pl.pallas_call

    def interp(*a, **kw):
        kw["interpret"] = True
        return orig(*a, **kw)

    monkeypatch.setattr(pl, "pallas_call", interp)
    config.set_matmul_precision("highest")
    yield
    config.set_matmul_precision(None)


def jax_lib(name):
    return importlib.import_module(f"radiorust_tpu.{name}")


def test_the_tolerances_are_the_reference_table():
    tools = pathlib.Path(__file__).resolve().parents[1] / "tools"
    tree = ast.parse((tools / "validate_tpu.py").read_text())
    ref = next(ast.literal_eval(node.value) for node in tree.body
               if isinstance(node, ast.Assign)
               and getattr(node.targets[0], "id", None) == "TOL")
    assert ref == TOL and len(MODELS) == 15


@pytest.mark.parametrize("model", MODELS)
def test_port_model_matches_jax(model):
    case = build(model, 0, jax_lib)
    b = case.bound
    xs = jnp.asarray(case.xs)
    if case.graph:
        _, ys = jgraph_scan(b, b.params, b.init_state(), {"iq": xs})
    else:
        _, ys = jscan(b, b.params, b.init_state(), xs)
    ref = fingerprint(output_leaves(ys, b, case.post))
    got = validate.run(model, torch.device("cpu"))
    assert ref.shape == got.shape == (4, validate.T)
    assert np.all(np.isfinite(got)) and np.all(got[0] > 0)
    np.testing.assert_array_equal(ref[3], got[3])       # the same shapes
    rel = steady_rel(ref, got)
    assert rel < TOL[model], (model, rel)


def test_fingerprint_equal_inputs_give_zero():
    rng = np.random.default_rng(1)
    leaf = (rng.standard_normal((4, 3, 50))
            + 1j * rng.standard_normal((4, 3, 50))).astype(np.complex64)
    a = fingerprint([leaf, leaf.real.copy()])
    assert steady_rel(a, fingerprint([leaf.copy(), leaf.real.copy()])) == 0.0
    assert a[3].tolist() == [300.0] * 4


def test_fingerprint_known_perturbations():
    n = 64
    ones = np.ones((4, 1, n), np.complex64)
    ref = fingerprint([ones])
    # Chunk 0 is warm-up: a change there is not counted.
    warm = ones.copy()
    warm[0] *= 3.0
    assert steady_rel(ref, fingerprint([warm])) == 0.0
    # A gain of 1 + eps on chunk 2: energy off by 2 eps + eps^2, which
    # outweighs the fingerprint's eps |F| / sqrt(E N).
    eps = 1e-3
    gain = ones.copy()
    gain[2] *= 1.0 + eps
    np.testing.assert_allclose(steady_rel(ref, fingerprint([gain])),
                               2 * eps + eps ** 2, rtol=1e-4)
    # One sample of chunk 1 moved by 1j * d: the imaginary fingerprint
    # moves by d against sqrt(E N) = n; the energy by d^2 / n only.
    d = 0.01
    kick = ones.copy()
    kick[1, 0, 5] += 1j * d
    np.testing.assert_allclose(steady_rel(ref, fingerprint([kick])), d / n,
                               rtol=1e-4)


def test_command_line_on_the_cpu(capsys):
    assert validate.main(["am", "isb", "--device", "cpu"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("am: max steady rel 0.000e+00 (OK @ 0.001)")
    assert json.loads(out[-1]) == {"validate": {"am": 0.0, "isb": 0.0}}


def test_command_line_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("needs a host without a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        validate.main(["am"])
