"""Byzantine ``noise`` corruption with the master's two clamps
(``score_clip`` and ``u_zclip``) against the JAX reference: the
reference's normal draws are injected through the port's ``noise_fn`` seam
(harness: ``run_adversarial`` in tests/test_torch_adversarial.py)."""
import numpy as np
import pytest

from repro_torch.core.dynamic_weight import robust_zscore
from test_torch_adversarial import (ADAHESSIAN, ROUNDS, TAU,
                                    run_adversarial, schedule_for)
from test_torch_session import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.mark.parametrize("comm,score_clip", [("sequential", 3.0),
                                             ("fused", 3.0), ("fused", 0.0),
                                             ("sequential", 4.0)])
def test_noise_with_clamps_matches_reference(comm, score_clip):
    """In fused mode the pool's u feed ``u_zclip``; the sequential scan
    scores one worker at a time and, as in the reference, passes no pool,
    so only ``score_clip`` acts there. With ``score_clip`` off, the noisy
    slot's positive score would earn it the full α: ``u_zclip`` alone
    refuses it. ``score_clip`` 4 in the sequential scan is the
    configuration whose honest acceptance ``chip_smoke.py`` asserts on the
    card (the CLI's byzantine noise run, k=8, τ=4): every score is above
    the clip until the u history has filled, so that case runs one round
    more and holds the port to the reference in a round where every live
    honest slot is accepted and every live corrupt slot refused."""
    k = 4
    ekw = dict(num_workers=k, tau=TAU, alpha=0.1, comm_mode=comm,
               failure_scenario="byzantine", byzantine_frac=0.5,
               byzantine_mode="noise", byzantine_scale=5.0,
               score_clip=score_clip, u_zclip=3.0)
    rounds = ROUNDS + 1 if score_clip == 4.0 else ROUNDS
    sched = schedule_for(ekw, k, rounds=rounds)
    assert sched.has_corruption
    log = []
    _, met = run_adversarial(ekw, ADAHESSIAN, sched, k, rounds=rounds,
                             log=log)
    if score_clip == 4.0:
        def split(r):
            h2 = log[r]["h2"].numpy()
            live = ~sched.fail[r]
            return (h2[live & ~sched.corrupt[r]],
                    h2[live & sched.corrupt[r]])

        assert any(len(honest) and len(bad) and (honest > 0).all()
                   and (bad == 0).all()
                   for honest, bad in map(split, range(rounds)))
    if comm == "fused" and not score_clip:
        z = robust_zscore(met["u"]).numpy()
        h2, score = met["h2"].numpy(), met["score"].numpy()
        refused = (z > 3.0) & ~sched.fail[-1] & (score > 0)
        assert refused.any() and (h2[refused] == 0).all()
        kept = (z <= 3.0) & ~sched.fail[-1] & (score > 0)
        np.testing.assert_allclose(h2[kept], 0.1)
