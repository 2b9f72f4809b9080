"""chip_smoke.py's phases at small sizes on the CPU, each with its
oracle check, and its refusal to run without a GPU."""

import json

import jax
import pytest

import chip_smoke as cs


def _ok(r):
    assert r["ok"], r
    assert r["error"] <= r["tol"]
    assert json.loads(json.dumps(r)) == r
    return r


def test_quickstart_phase():
    r = _ok(cs.phase_quickstart(trials=64, particles=128))
    assert abs(r["means"][0] - 0.6) < r["tol"] + 1e-9


def test_tracking_phase_fires_resampling():
    r = _ok(cs.phase_tracking(n=1 << 12, steps=16))
    assert 1 <= r["resamples"] <= 16


def test_linear_gaussian_phase_matches_kalman():
    r = _ok(cs.phase_linear_gaussian(n=1 << 14, steps=16))
    assert r["exact"] == pytest.approx(
        cs.kalman_log_marginal(cs.simulate_linear_gaussian(16))
    )


def test_resample_phase_bitwise():
    r = _ok(cs.phase_resample(n=1 << 12, width=8))
    assert r["error"] == 0


def test_hmm_parallel_phase():
    _ok(cs.phase_hmm_parallel(states=16, steps=64))


def test_hmm_filter_phase_both_samplers():
    rs = cs.phase_hmm_filter(states=8, steps=16, n=1 << 12)
    assert [r["phase"] for r in rs] == ["d.hmm_filter_invcdf",
                                       "d.hmm_filter_gumbel"]
    for r in rs:
        _ok(r)


def test_nuts_phase_matches_conjugate_posterior():
    r = _ok(cs.phase_nuts(chains=64, warmup=100, samples=100))
    mean, sd = cs.regression_posterior(
        jax.numpy.linspace(-1.0, 1.0, 128),
        2.0 * jax.numpy.linspace(-1.0, 1.0, 128) - 0.5,
    )
    assert r["exact_mean"] == pytest.approx(mean.tolist())
    assert r["exact_sd"] == pytest.approx(sd.tolist())


def test_multi_phase_on_four_virtual_devices():
    rs = cs.phase_multi(jax.devices()[:4], particles=1 << 12, states=8,
                        steps=256, chains=64, svgd_particles=256)
    assert len(rs) == 5
    for r in rs:
        _ok(r)
        assert r["spans"]


@pytest.mark.parametrize("argv", [[], ["--multi"]])
def test_main_refuses_cpu(argv, capsys):
    assert cs.main(argv) != 0
    out = capsys.readouterr().out
    assert '"ok": true' not in out
