"""Per-round trainer state parity of the PyTorch port with the JAX
reference: EASGD, sequential comm (harness and tolerance: ``run_parity`` in
tests/test_torch_session.py)."""
import pytest

from test_torch_session import run_parity


@pytest.mark.parametrize("k", [2, 4])
@pytest.mark.parametrize("scenario", ["iid", "crash_restart"])
def test_state_matches_reference_every_round(scenario, k):
    run_parity("EASGD", k, "sequential", scenario)
