"""The benchmark's frozen traffic copies give the port's synthetic arrays
today, and the pools they feed vary from step to step.

    python -m pytest -q hosbench/tests
"""

import json
import os

import numpy as np
import pytest
import torch

from hosbench import pool, synthetic
from hosnerf_tpu_torch.data import synthetic as port_synthetic
from hosnerf_tpu_torch.tools import common

BIG_SEED = 3_000_000_019          # past 32 signed bits, as seeds may be


def same(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]),
                                      err_msg=k)


@pytest.mark.parametrize("seed", [0, 7, BIG_SEED])
def test_frozen_copies_give_the_ports_arrays(seed):
    same(synthetic.human_batch(2, 8, seed=seed, grid_size=16),
         port_synthetic.human_batch(2, 8, seed=seed, grid_size=16))
    same(synthetic.composed_batch(1, 16, seed=seed, grid_size=8),
         port_synthetic.composed_batch(1, 16, seed=seed, grid_size=8))
    same(synthetic.scene_ray_batch(64, seed=seed),
         port_synthetic.scene_ray_batch(64, seed=seed))


def test_frozen_jitter_is_the_tools_jitter():
    for i in (0, 1, 17):
        assert torch.equal(torch.rand(5, generator=pool.jitter(i)),
                           torch.rand(5, generator=common.jitter(i)))


def mixes():
    names = sorted(f[:-5] for f in os.listdir(os.path.join(
        pool.HERE, "traffic")) if f.endswith(".json"))
    assert names
    return names


@pytest.mark.parametrize("name", mixes())
def test_every_mix_file_loads(name):
    mix = pool.load_mix(name)
    assert mix["kind"] in ("composed", "rays")
    json.dumps(mix)


def small_composed():
    mix = pool.load_mix("p8")
    mix.update(mix["small"])
    return mix


def test_composed_pool_one_capture_frames_differ():
    mix = small_composed()
    frames = pool.frames(mix, BIG_SEED, grid_size=8)
    assert len(frames) == mix["pool"]
    assert mix["capture"] >= 0
    fixed = ("cnl_gtfms", "motion_weights_priors", "cnl_bbox_min_xyz",
             "cnl_bbox_scale_xyz")
    for a, b in zip(frames, frames[1:]):
        for k in fixed:                       # one skeleton
            np.testing.assert_array_equal(a[k], b[k])
        for k in ("rays_o", "rays_d", "dst_Rs", "dst_posevec",
                  "target_patches", "ray_grid"):
            assert not np.array_equal(a[k], b[k]), k
    skel = synthetic.human_batch(1, 1, seed=mix["capture"], grid_size=8)
    np.testing.assert_array_equal(frames[0]["motion_weights_priors"],
                                  skel["motion_weights_priors"])
    # the keys and shapes of a stage-3 batch
    ref = synthetic.composed_batch(mix["n_patches"], mix["patch_size"],
                                   seed=1, grid_size=8)
    assert sorted(frames[0]) == sorted(ref)
    for k in ref:
        assert np.shape(frames[0][k]) == np.shape(ref[k]), k


def test_pools_repeat_by_seed_one_capture_in_the_seeds_order():
    """The same seed gives the same pool; another seed the same capture's
    batches in another order (every run does the same work)."""
    mix = small_composed()
    a = pool.frames(mix, 5, grid_size=8)
    b = pool.frames(mix, 5, grid_size=8)
    c = pool.frames(mix, 6, grid_size=8)
    for x, y in zip(a, b):
        same(x, y)
    key = lambda f: f["rays_d"].tobytes()
    assert sorted(map(key, a)) == sorted(map(key, c))
    assert list(map(key, a)) != list(map(key, c))


def test_ray_pool_batches_differ_and_mix_both_states():
    mix = pool.load_mix("r4096")
    mix.update(mix["small"])
    batches = pool.frames(mix, BIG_SEED)
    assert len(batches) == mix["pool"]
    for a, b in zip(batches, batches[1:]):
        assert not np.array_equal(a["rays_d"], b["rays_d"])
    for b in batches:
        assert set(np.unique(b["times"])) <= set(mix["times"])
        assert len(np.unique(b["times"])) == 2


def test_step_generators_differ_by_step_and_seed():
    draws = {(s, i): torch.rand(4, generator=pool.step_generator(s, i))
             for s in (1, BIG_SEED) for i in (0, 1)}
    keys = list(draws)
    for a in range(len(keys)):
        for b in range(a + 1, len(keys)):
            assert not torch.equal(draws[keys[a]], draws[keys[b]])
    assert torch.equal(draws[(1, 0)],
                       torch.rand(4, generator=pool.step_generator(1, 0)))
