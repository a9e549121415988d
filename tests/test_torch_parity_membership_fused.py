"""Per-round parity of the port's elastic membership with the JAX
reference: DEAHES-O at capacity 6, 4 live slots scaled up to 6 at round
2, crash_restart failures, fused comm (harness and tolerance:
``run_membership_parity`` in tests/test_torch_membership.py)."""
from test_torch_membership import run_membership_parity
from test_torch_session import one_torch_thread  # noqa: F401


def test_membership_rounds_match_reference(one_torch_thread):
    run_membership_parity("fused")
