"""The port's LM data pipeline against the JAX package's: the same
tokens for the same (seed, step), the same loader plugin and batcher."""
import numpy as np
import pytest

from repro.data import SyntheticTokenLoader as JaxLoader
from repro.data import TokenBatcher as JaxBatcher
from repro.data import token_stream as jax_token_stream

from repro_torch.configs import get_config, smoke_batch
from repro_torch.data import SyntheticTokenLoader, TokenBatcher, token_stream
from repro_torch.launch.train import DATA_SEED, make_batches


@pytest.mark.parametrize("vocab,batch,seq,seed,step", [
    (100, 4, 8, 7, 3), (49152, 2, 64, 1234, 0), (257, 8, 16, 0, 19)])
def test_token_stream_equals_reference(vocab, batch, seq, seed, step):
    got = token_stream(vocab, batch, seq, seed=seed, step=step)
    want = jax_token_stream(vocab, batch, seq, seed=seed, step=step)
    for k in ("tokens", "labels"):
        assert got[k].dtype == want[k].dtype == np.int32
        np.testing.assert_array_equal(got[k], want[k])


def test_token_stream_deterministic_and_restart_safe():
    a = token_stream(100, 4, 8, seed=7, step=3)
    np.testing.assert_array_equal(
        a["tokens"], token_stream(100, 4, 8, seed=7, step=3)["tokens"])
    assert not np.array_equal(
        a["tokens"], token_stream(100, 4, 8, seed=7, step=4)["tokens"])
    # labels are next-token shifted with a -1 terminator
    np.testing.assert_array_equal(a["labels"][:, :-1], a["tokens"][:, 1:])
    assert np.all(a["labels"][:, -1] == -1)


def test_loader_plugin_and_batcher_equal_reference():
    kw = dict(vocab=50, samples=12, seq=16, seed=1)
    (ds,) = SyntheticTokenLoader(out_datasets=["tokens"], **kw).load()
    (jds,) = JaxLoader(out_datasets=["tokens"], **kw).load()
    assert ds.shape == jds.shape == (12, 16)
    assert "BATCH" in ds.patterns and ds.metadata["vocab"] == 50
    got = list(TokenBatcher(ds, global_batch=4))
    want = list(JaxBatcher(jds, global_batch=4))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        for k in ("tokens", "labels"):
            np.testing.assert_array_equal(g[k], w[k])
    assert np.all(got[0]["tokens"] < 50)


@pytest.mark.parametrize("arch", ["granite-8b", "llava-next-34b"])
def test_train_batches_are_a_function_of_the_step(arch):
    """``launch.train``'s stream: token_stream for the token families,
    the smoke batch at seed + step for the others."""
    cfg = get_config(arch, smoke=True)
    at = make_batches(cfg, 2, 8, seed=DATA_SEED)
    want = (token_stream(cfg.vocab, 2, 8, seed=DATA_SEED, step=5)
            if cfg.family == "dense"
            else smoke_batch(cfg, batch=2, seq=8, seed=DATA_SEED + 5))
    for k, v in want.items():
        np.testing.assert_array_equal(at(5)[k], v)
