"""The mixes' traffic: deterministic by seed, inside its ranges, the same
work on every seed."""

from __future__ import annotations

import numpy as np
import pytest

import bench_small as bs
from benchlib import lengths
from benchlib.knot import knot_features

MIXES = ["knot-bulk", "rag", "reason"]


def specs(mix: dict) -> list:
    return [mix[k] for k in ("rows", "prompt", "output") if k in mix]


@pytest.mark.parametrize("name", MIXES)
def test_sizes_inside_their_ranges_and_fixed_per_mix(name):
    mix = bs.manifest().mix(name)
    for salt, spec in enumerate(specs(mix)):
        a = lengths.fixed_sizes(spec, mix, salt)
        assert len(a) == mix["sequence"]
        assert a.min() >= spec["min"] and a.max() <= spec["max"]
        assert np.array_equal(a, lengths.fixed_sizes(spec, mix, salt))
        if spec["dist"] == "lognormal":
            assert abs(np.median(a) / spec["median"] - 1) < 0.1


@pytest.mark.parametrize("seed", [0, 7, 2**31 + 5, -3])
def test_contents_follow_the_seed_and_sizes_do_not(seed):
    mix = bs.manifest().mix("rag")
    a = lengths.prompt_tokens(seed, 4, 300, 152064)
    assert a == lengths.prompt_tokens(seed, 4, 300, 152064)
    assert a != lengths.prompt_tokens(seed + 1, 4, 300, 152064)
    assert a != lengths.prompt_tokens(seed, 5, 300, 152064)
    assert min(a) >= 3 and max(a) < 152064
    sh = lengths.fixed_shares(mix, 256)
    assert sh.min() > 0 and sh.max() <= 1
    assert np.array_equal(sh, lengths.fixed_shares(mix, 256))
    s64 = seed % lengths.SEED_MOD
    assert np.array_equal(knot_features(64, s64), knot_features(64, s64))
    assert not np.array_equal(knot_features(64, s64),
                              knot_features(64, s64 + 1))


def test_knot_rows_copy_the_programs_generator():
    from repro_torch.data.knot import make_knot_dataset

    for seed in (0, 2**31 + 5):
        x = make_knot_dataset(n_train=300, n_test=0, seed=seed)[0]
        assert np.array_equal(knot_features(300, seed), x)
    x = knot_features(4096, 1)
    assert x.dtype == np.float32 and x.min() >= -1 and x.max() <= 1


def test_a_run_serves_the_mix_with_large_seeds():
    for seed in (5, 2**31 + 9):
        out = bs.run("qwen25-kanffn-rag", seed=seed)
        assert out["correct"] and out["attempted"] > 0, out
        assert out["judged"]["tokens"] > 0
