"""Smoke tests for the matmul-bound benchmark configs 8/9/10: the
--small variants must run end-to-end on CPU, produce sane metrics, name
the device they ran on, and pass their built-in correctness gates. The
full-size variants are measured on the GPU by bench.py."""

import os
import sys

sys.path.insert(
    0, os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)
    )))
)


def test_config8_mxu_logreg_small():
    from benchmarks.run_all import run_config

    r = run_config(8, True, {})
    assert r["metric"] == "nuts_mxu_logreg_chain_leapfrogs_per_s"
    assert r["value"] > 0
    # Posterior mean separates active from inactive coefficients.
    assert r["posterior_sep"] > 0.2
    assert r["device"]["platform"] == "cpu"


def test_config9_bnn_vi_small():
    from benchmarks.run_all import config9_bnn_vi

    r = config9_bnn_vi(True)
    assert r["metric"] == "bnn_vi_mxu_grad_steps_per_s"
    assert r["value"] > 0
    # The variational mean moved off the zero init toward the teacher.
    assert r["mu_moved"] > 0.01


def test_config10_svgd_small():
    from benchmarks.run_all import run_config

    r = run_config(10, True, {})
    assert r["metric"] == "svgd_blr_particle_grad_steps_per_s"
    assert r["value"] > 0
    # 10 small-ensemble steps only roughly approach the posterior; the
    # tight gate lives in the full-size run (post_mean_err ~ 1e-2).
    assert r["post_mean_err"] < 1.0
    assert r["device"] == {"platform": "cpu", "kind": "cpu", "count": 8}


def test_bench_refuses_cpu(capsys):
    """The harness measures on a GPU only: elsewhere it exits non-zero
    and prints no result line."""
    import bench

    assert bench.main() != 0
    assert capsys.readouterr().out == ""


def test_load_baseline_missing_or_corrupt(tmp_path):
    from benchmarks.run_all import load_baseline

    assert load_baseline(str(tmp_path / "absent.json")) == {}
    bad = tmp_path / "bad.json"
    bad.write_text('{"truncated": ')
    assert load_baseline(str(bad)) == {}
    assert load_baseline()["particle_filter_nonlinear_tracking_throughput"] > 0
