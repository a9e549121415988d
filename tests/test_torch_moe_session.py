"""Elastic LM training of the MoE family in the port's ``ElasticSession``
against the reference's, on the CPU.

``tests/test_torch_lm_session.py``'s harness (its ``reference_run`` /
``port_run``: float32 SMOKE configs, k=2, τ=2, three rounds from the
reference's initial params with its probes injected) on moonshot-smoke
(a dense layer, then two MoE layers with a shared expert) with fused comm
and mixtral-smoke (top-2 of 4 experts, window 32) with sequential comm,
both AdaHessian with dynamic weighting. The loss each worker takes the
gradient and the Hutchinson probe of is the cross-entropy plus 0.01 x the
router aux, through the capacity dispatch under ``vmap(jvp(grad))``.
After every round the records and the state are held to the harness's
rules (diagnostics at rtol 1e-4 / atol 1e-5; state per leaf norm-wise
within 1e-3 and elementwise within rtol 1e-4 plus 2% of the leaf's
scale), and so is the final ``evaluate()``.
"""
import numpy as np
import pytest

from test_torch_lm_session import (DIAG, ROUNDS, _assert_state_close,
                                   _close, port_run, reference_run)
from test_torch_session import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

CASES = {"moonshot-adahessian-fused": ("moonshot-v1-16b-a3b", "adahessian",
                                       "fused"),
         "mixtral-adahessian-sequential": ("mixtral-8x22b", "adahessian",
                                           "sequential")}


@pytest.mark.parametrize("case", sorted(CASES))
def test_moe_lm_rounds_match_reference(case):
    _, _, want_rec, want_state, want_eval = reference_run(*CASES[case])
    got_rec, got_state, got_eval = port_run(*CASES[case])
    assert [r.round for r in got_rec] == list(range(ROUNDS))
    for r, (got, want) in enumerate(zip(got_rec, want_rec)):
        np.testing.assert_array_equal(got.fail, want.fail)
        _close(got.loss, want.loss, f"round {r} loss")
        for key in DIAG:
            _close(getattr(got, key), getattr(want, key),
                   f"round {r} {key}")
        _assert_state_close(got_state[r], want_state[r], f"round {r}")
    assert any(rec.fail.any() for rec in want_rec)
    assert got_eval[1] is None and want_eval[1] is None
    np.testing.assert_allclose(got_eval[0], want_eval[0], rtol=1e-4)
    # the router is a leaf of the trained state, and it moved
    master = got_state[-1]["master"]
    assert not np.allclose(master["moe_layers"]["moe"]["router"],
                           reference_run(*CASES[case])[0]["moe_layers"]
                           ["moe"]["router"])
