"""The LM token pipeline of the port against the JAX reference: the
synthetic token stream (``SyntheticTokens``) and the overlap-aware
``TokenWorkerBatcher``. Both are numpy in both packages, so the bar is
bit-identity: the same seeds give the same bytes, round after round, and
after a change of the live pool."""
import numpy as np
import pytest

import repro.configs.base as rcfg
import repro.data.pipeline as rpipe
import repro.data.synthetic as rsyn
import repro_torch.configs.base as tcfg
import repro_torch.data.pipeline as tpipe
import repro_torch.data.synthetic as tsyn
from test_torch_session import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _same(got, want, what):
    assert sorted(got) == sorted(want), what
    for key in want:
        assert got[key].dtype == want[key].dtype, f"{what} {key}"
        assert got[key].tobytes() == want[key].tobytes(), f"{what} {key}"


@pytest.mark.parametrize("seed,vocab,n", [(0, 256, 3000), (3, 4096, 5000),
                                          (12345, 97, 1200)])
def test_synthetic_tokens_byte_identical(seed, vocab, n):
    r = rsyn.SyntheticTokens(vocab=vocab, n_tokens=n, seed=seed)
    t = tsyn.SyntheticTokens(vocab=vocab, n_tokens=n, seed=seed)
    for f in ("succ", "tokens"):
        a, b = getattr(r, f), getattr(t, f)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), f
    # the held-out batch as the sessions draw it (seed + 31)
    _same(t.batch(np.random.default_rng(seed + 31), 4, 16),
          r.batch(np.random.default_rng(seed + 31), 4, 16), "batch")


@pytest.mark.parametrize("k,tau,ratio,seed", [(4, 2, 0.25, 0), (3, 1, 0.0, 5),
                                              (8, 3, 0.125, 7)])
def test_token_batches_byte_identical(k, tau, ratio, seed):
    toks = rsyn.SyntheticTokens(vocab=256, n_tokens=4000, seed=1).tokens
    kw = dict(num_workers=k, tau=tau, overlap_ratio=ratio)
    rb = rpipe.TokenWorkerBatcher(toks, rcfg.ElasticConfig(**kw),
                                  batch_size=3, seq_len=16, seed=seed)
    tb = tpipe.TokenWorkerBatcher(toks, tcfg.ElasticConfig(**kw),
                                  batch_size=3, seq_len=16, seed=seed)
    for r in range(4):
        got = tb.round_batches()
        _same(got, rb.round_batches(), f"round {r}")
        assert got["tokens"].shape == (tau, k, 3, 16)
        # targets are the next token of every window
        np.testing.assert_array_equal(got["tokens"][..., 1:],
                                      got["targets"][..., :-1])


def test_token_batches_follow_an_active_mask_change():
    """Capacity 6, 3 live slots, then slots {0, 2, 4, 5}: the vacant slots
    carry the zero pad and the redealt shards match the reference's."""
    toks = rsyn.SyntheticTokens(vocab=256, n_tokens=4000, seed=2).tokens
    kw = dict(num_workers=3, capacity=6, tau=2, overlap_ratio=0.25)
    rb = rpipe.TokenWorkerBatcher(toks, rcfg.ElasticConfig(**kw),
                                  batch_size=2, seq_len=12, seed=3)
    tb = tpipe.TokenWorkerBatcher(toks, tcfg.ElasticConfig(**kw),
                                  batch_size=2, seq_len=12, seed=3)
    _same(tb.round_batches(), rb.round_batches(), "before")
    mask = np.array([1, 0, 1, 0, 1, 1], bool)
    rb.set_active_mask(mask)
    tb.set_active_mask(mask)
    assert tb.active == rb.active == (0, 2, 4, 5)
    for r in range(3):
        got = tb.round_batches()
        _same(got, rb.round_batches(), f"after, round {r}")
        assert not got["tokens"][:, ~mask].any()
