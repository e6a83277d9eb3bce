"""The port's synthetic token pipeline (``repro_torch.data.lm_data``) against
the reference's: every batch bit-equal for each (seed, step, host split),
and the reference's own data tests (``tests/test_checkpoint_data.py``:
determinism, seekability, host sharding) on the port."""

import numpy as np
import pytest

from repro.data import lm_data as J
from repro_torch.data import lm_data as T

CONFIGS = [  # (vocab, seq_len, global_batch, seed, mean_doc_len)
    (1000, 64, 8, 3, 512),
    (256, 16, 4, 0, 512),
    (152064, 256, 16, 0, 512),   # the full-width training phase's stream
    (50, 33, 6, 11, 20),         # short documents: many EOS boundaries
]


def _cfgs(vocab, seq_len, gb, seed, mean):
    kw = dict(vocab_size=vocab, seq_len=seq_len, global_batch=gb, seed=seed,
              mean_doc_len=mean)
    return J.DataConfig(**kw), T.DataConfig(**kw)


def _equal(got: dict, want: dict):
    assert sorted(got) == sorted(want) == ["targets", "tokens"]
    for k in want:
        assert got[k].dtype == want[k].dtype == np.int32
        np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("step", [0, 1, 17, 1000])
@pytest.mark.parametrize("cfg", CONFIGS)
def test_global_batches_bit_equal_to_reference(cfg, step):
    jc, tc = _cfgs(*cfg)
    _equal(T.global_batch_at_step(tc, step), J.global_batch_at_step(jc, step))


@pytest.mark.parametrize("host_id,num_hosts", [(0, 1), (0, 2), (1, 2),
                                               (3, 4), (5, 8)])
@pytest.mark.parametrize("cfg", [c for c in CONFIGS if c[2] % 8 == 0])
def test_host_batches_bit_equal_to_reference(cfg, host_id, num_hosts):
    jc, tc = _cfgs(*cfg)
    for step in (0, 9):
        _equal(T.host_batch_at_step(tc, step, host_id, num_hosts),
               J.host_batch_at_step(jc, step, host_id, num_hosts))


def test_data_deterministic_and_seekable():
    cfg = T.DataConfig(vocab_size=1000, seq_len=64, global_batch=8, seed=3)
    b1 = T.global_batch_at_step(cfg, 17)
    b2 = T.global_batch_at_step(cfg, 17)
    np.testing.assert_array_equal(b1["tokens"], b2["tokens"])
    b3 = T.global_batch_at_step(cfg, 18)
    assert not np.array_equal(b1["tokens"], b3["tokens"])
    # shapes + shifted targets
    assert b1["tokens"].shape == (8, 64)
    assert (b1["tokens"] < 1000).all() and (b1["tokens"] >= 0).all()
    np.testing.assert_array_equal(b1["tokens"][:, 1:], b1["targets"][:, :-1])


def test_data_host_sharding_shapes():
    cfg = T.DataConfig(vocab_size=1000, seq_len=32, global_batch=8)
    h0 = T.host_batch_at_step(cfg, 5, host_id=0, num_hosts=4)
    h1 = T.host_batch_at_step(cfg, 5, host_id=1, num_hosts=4)
    assert h0["tokens"].shape == (2, 32)
    assert not np.array_equal(h0["tokens"], h1["tokens"])  # distinct shards
    np.testing.assert_array_equal(
        h0["tokens"], T.host_batch_at_step(cfg, 5, 0, 4)["tokens"])
    with pytest.raises(ValueError, match="num_hosts"):
        T.host_batch_at_step(cfg, 5, 0, 3)
