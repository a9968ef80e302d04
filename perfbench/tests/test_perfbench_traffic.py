"""The traffic generator: draws from the seed, the reservoir of compared
steps, and the mix files."""

import json
import random

import pytest
import torch

from perfbench import traffic

SIZES = dict(max_sqp_iter=2, ns=3, g_ny=1, H=4, Ty=3, beta=2.5)
MIX = traffic.Mix(episode_steps=5, pool_episodes=3, warmup_episodes=0,
                  trace_steps=1, compare_steps=2, compare_first_steps=1)


def draws(seed):
    return traffic.Draws(MIX, SIZES, seed, "cpu", torch.float32).pool


@pytest.mark.parametrize("seed", [0, 7, 2 ** 31 + 11, 3 * 2 ** 40])
def test_same_seed_same_draws(seed):
    a, b = draws(seed), draws(seed)
    assert a.shape == (3, 5, 2, 3, 1, 4, 3)
    assert torch.equal(a, b)
    assert float(a.abs().max()) <= SIZES["beta"]


def test_seeds_give_different_draws():
    pools = [draws(s) for s in (1, 2, 2 ** 31 + 1)]
    for i in range(3):
        for j in range(i + 1, 3):
            assert not torch.equal(pools[i], pools[j])


def test_episodes_cycle_through_the_pool():
    d = traffic.Draws(MIX, SIZES, 5, "cpu", torch.float32)
    assert torch.equal(d.episode(1), d.episode(4))
    assert not torch.equal(d.episode(0), d.episode(1))


def test_reservoir_is_uniform_and_from_the_seed():
    def sample(seed):
        r = traffic.Reservoir(5, random.Random(seed))
        for i in range(1000):
            r.offer(lambda i=i: i)
        return r.items
    assert sample(3) == sample(3)
    assert sample(3) != sample(4)
    assert len(sample(3)) == 5 and max(sample(3)) > 100
    counts = [0] * 10
    for s in range(400):
        for v in sample(s):
            counts[v * 10 // 1000] += 1
    assert min(counts) > 120 and max(counts) < 280     # 200 expected each


@pytest.mark.parametrize("name", ["episodes", "cold_solves", "plans",
                                  "car_episodes", "rollouts"])
def test_mix_files_load(name):
    import os
    from perfbench.cell import HERE, kind_module
    path = os.path.join(HERE, "traffic", f"{name}.json")
    kind = kind_module(traffic.kind_of(path))
    mix = traffic.Mix.load(path, getattr(kind, "MIX_KEYS", ()))
    assert mix.compare_steps >= 1 and mix.trace_steps >= 1
    assert traffic.kind_of(path) == ("rollout" if name == "rollouts"
                                     else "mpc")


def test_a_kinds_own_key_is_required(tmp_path):
    p = tmp_path / "m.json"
    p.write_text(json.dumps({**{k: 1 for k in traffic.KEYS},
                             "kind": "rollout"}))
    with pytest.raises(ValueError, match="missing"):
        traffic.Mix.load(str(p), ("compare_realizations",))


def test_mix_file_with_unknown_key_is_refused(tmp_path):
    p = tmp_path / "bad.json"
    p.write_text(json.dumps({**MIX.__dict__, "rate": 3}))
    with pytest.raises(ValueError, match="unknown"):
        traffic.Mix.load(str(p))
