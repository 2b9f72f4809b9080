"""``benchmarks/gpu_ab.py`` at ``--small`` sizes on the CPU: each A/B
experiment runs, prints one JSON line per measurement, and its
correctness checks hold (the full sizes are measured on the GPU)."""

import json
import os
import sys

import pytest

sys.path.insert(
    0, os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)
    )))
)


def _run(capsys, *argv):
    from benchmarks import gpu_ab

    assert gpu_ab.main(["--small", *argv]) == 0
    lines = [json.loads(l) for l in capsys.readouterr().out.splitlines()]
    assert lines[0]["platform"] == "cpu"
    return lines[1:]


def test_cdf_variants_agree_and_stay_monotone(capsys):
    out = _run(capsys, "cdf")
    alone = [r for r in out if r["exp"] == "cdf_alone"]
    assert len(alone) == 3
    for r in alone:
        for name, c in r["check"].items():
            assert c["monotone"] and c["last"] == r["n"], (r["weights"], name)
            assert c["max_abs_diff_vs_xla"] <= 1
    (e2e,) = [r for r in out if r["exp"] == "cdf_in_tracking_filter"]
    assert set(e2e["median_s"]) == {"xla", "rows16", "rows32",
                                    "no_resampling"}


@pytest.mark.parametrize("experiment", ["resample", "logmatmul", "hmm"])
def test_experiment_runs_with_its_checks(capsys, experiment):
    out = _run(capsys, experiment)
    assert out and all(r["median_s"] for r in out)
    for r in out:
        if r["exp"] == "resample_alone":
            assert all(r["bitwise_equal_to_repeat"].values())
        if r["exp"] == "log_matmul":
            assert r["max_abs_diff_vs_highest"]["HIGHEST"] == 0.0
        if r["exp"] == "hmm_parallel_precision":
            assert r["errors"]["HIGHEST"]["l1"] < 1e-3
        if r["exp"] == "hmm_filter_selection":
            errs = r["logz_abs_error"]
            assert errs["gather"] == errs["onehot_highest"]


def test_unknown_experiment_and_missing_parent_are_refused(capsys):
    from benchmarks import gpu_ab

    with pytest.raises(SystemExit):
        gpu_ab.main(["--small", "nope"])
    with pytest.raises(SystemExit, match="--parent"):
        gpu_ab.main(["--small", "seed_kernels"])
