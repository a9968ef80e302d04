"""The reference against the program's plain route: on the CPU in float64
at a tiny size, the program's steps read as the reference's own."""

import pytest
import torch

from conftest import ROOT, car_root, run_cell, tiny_config


@pytest.mark.parametrize("workload, config, ns, H, seconds", [
    ("pendulum1d_samples.episodes", "pendulum1d_samples", 5, 6, 1.0),
    ("pendulum1d_samples.cold_solves", "pendulum1d_samples", 5, 6, 0.5),
    ("car_samples.plans", "car_samples", 3, 8, 1.0)])  # conftest.car_root
def test_reference_reads_the_plain_route_as_its_own(tmp_path, workload,
                                                    config, ns, H, seconds):
    from perfbench import check
    seen = []
    orig = check.compare_step

    def spy(m, rec):
        r = orig(m, rec)
        seen.append(r)
        return r

    check.compare_step = spy
    try:
        res = run_cell(workload, seconds, config=tiny_config(
            tmp_path, config, ns, H), dtype=torch.float64,
            mix=dict(pool_episodes=2, warmup_episodes=0, compare_steps=3),
            out_dir=str(tmp_path), root=(car_root(tmp_path) if config ==
                                         "car_samples" else ROOT))
    finally:
        check.compare_step = orig
    assert res["correct"] and res["failed"] == 0 and seen
    for r in seen:
        assert r["chain"] == 0
        assert r["gp_gap"] < 1e-9 and r["hall_gap"] < 1e-9
        assert r["hall_out"] < 1e-9 and r["hall_var_gap"] < 1e-9
        assert r["hall_corr_gap"] < 1e-9
        assert r["plan_gap"] < 1e-12 and r["plant_gap"] < 1e-14
        # the program's float64 QP exit (relative KKT 1e-8, the penalties'
        # scale) against the reference's optimum
        assert abs(r["qp_gap_scaled"]) < 1e-6 and r["qp_viol"] < 1e-8
