"""Smoke test of genjax_xla's main inference paths on NVIDIA GPUs.

Run from the root of a checkout:

    python chip_smoke.py            # phases a-e on one GPU
    python chip_smoke.py --multi    # the sharded phase alone, on four GPUs

Every phase goes through the public API at the repository's full sizes,
checks its result against an exact or closed-form oracle, and prints one
JSON line with its error, the tolerance and the precision it ran at.
An early line holds the card's name and power limit as ``nvidia-smi``
reports them. The last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.
Without a GPU, or when any phase fails, the script exits non-zero and
prints no such line.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import genjax_xla as g  # noqa: E402
from genjax_xla.utils.profiling import enable_compile_cache  # noqa: E402

#: A float32 matmul on the GPU may run in TF32 unless a precision is
#: asked for; the phases below state what they ran at.
F32 = "float32 elementwise"
F32_HIGHEST = "float32, matmul precision HIGHEST"


def _seconds(fn, *args):
    """Median wall time of three calls of a compiled ``fn`` after one
    warm-up call, each ended by ``block_until_ready``."""
    jax.block_until_ready(fn(*args))
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    return sorted(times)[1]


def _result(phase, error, tol, precision, **extra):
    error = float(error)
    return {"phase": phase, "ok": bool(np.isfinite(error) and error <= tol),
            "error": error, "tol": float(tol), "precision": precision,
            **extra}


# ---------------------------------------------------------------------------
# b. Quickstart: the README path
# ---------------------------------------------------------------------------


def _beta_bernoulli_target(obs):
    """The README quickstart posterior: Beta(2,2) prior, one flip."""
    from genjax_xla.inference import Target

    @g.gen
    def beta_bernoulli(a, b):
        p = g.beta(a, b) @ "p"
        return g.flip(p) @ "v"

    return Target(beta_bernoulli, (2.0, 2.0), g.C["v"].set(obs))


def phase_quickstart(trials: int = 1024, particles: int = 1024) -> dict:
    """Beta-Bernoulli SIR under ``jit`` + ``vmap``: the mean of ``trials``
    posterior draws against the exact Beta(3,2) / Beta(2,3) means."""
    from genjax_xla.inference import ImportanceK

    @jax.jit
    def posterior_mean(key, obs):
        target = _beta_bernoulli_target(obs)
        alg = ImportanceK(target, k_particles=particles)
        keys = jax.random.split(key, trials)
        _, chm = jax.vmap(alg.random_weighted, in_axes=(0, None))(
            keys, target
        )
        return jnp.mean(chm["p"])

    key = jax.random.key(314159)
    got = [float(posterior_mean(key, True)), float(posterior_mean(key, False))]
    error = max(abs(got[0] - 0.6), abs(got[1] - 0.4))
    # Five standard errors of a mean of `trials` exact posterior draws
    # (the Beta(3,2) standard deviation is 0.2).
    tol = 5 * 0.2 / np.sqrt(trials)
    return _result("b.quickstart", error, tol, F32, means=got,
                   seconds=_seconds(posterior_mean, key, True))


# ---------------------------------------------------------------------------
# c. Particle filters and resampling
# ---------------------------------------------------------------------------


def _tracking_filter(n: int):
    """The nonlinear 1-D tracking model (benchmark config 4) as a batched
    filter. The particle state carries a resample counter, so the
    run shows how often adaptive systematic resampling fired."""
    from genjax_xla.inference.pf import particle_filter
    from genjax_xla.inference.smc import resample_tree

    def init(key):
        return (jax.random.normal(key, (n,)), jnp.zeros((n,), jnp.int32)), \
            jnp.zeros((n,))

    def step(key, state, y):
        xs, fired = state
        xs = (0.5 * xs + 25.0 * xs / (1.0 + xs * xs)
              + jnp.sqrt(10.0) * jax.random.normal(key, (n,)))
        lw = jax.scipy.stats.norm.logpdf(y, xs * xs / 20.0, 1.0)
        return (xs, fired), lw

    def resample(key, lw, state):
        xs, fired = resample_tree(key, lw, state, n)
        return xs, fired + 1

    return particle_filter(init, step, n, batched=True, resample_fn=resample)


def phase_tracking(n: int = 1 << 20, steps: int = 32) -> dict:
    """Config 4 at full width: log Z from two seeds must agree within
    the Monte Carlo spread, and resampling must have fired."""
    pf = _tracking_filter(n)
    ys = jax.random.normal(jax.random.key(9), (steps,)) * 5.0

    @jax.jit
    def run(key):
        final, _ = pf(key, ys)
        return final.log_z, final.particles[1][0]

    (lz0, fired), (lz1, _) = run(jax.random.key(0)), run(jax.random.key(1))
    fired = int(fired)
    # Five standard deviations of the seed-to-seed difference: log Z
    # spreads with standard deviation 0.039 at 2^20 particles (twelve
    # seeds at 2^18 on the CPU gave 0.078), shrinking as 1/sqrt(n).
    tol = 5 * np.sqrt(2) * 0.039 * np.sqrt((1 << 20) / n)
    error = abs(float(lz0) - float(lz1)) if fired > 0 else float("inf")
    sec = _seconds(run, jax.random.key(0))
    return _result("c.tracking_filter", error, tol, F32,
                   log_z=float(lz0), resamples=fired, steps=steps,
                   particles=n, seconds=sec,
                   particle_steps_per_s=n * steps / sec)


def simulate_linear_gaussian(steps: int, a=0.9, q=0.5, r=0.3, seed=0):
    rng = np.random.default_rng(seed)
    x, ys = rng.normal(0.0, 1.0), []
    for _ in range(steps):
        ys.append(x + rng.normal(0.0, np.sqrt(r)))
        x = a * x + rng.normal(0.0, np.sqrt(q))
    return np.asarray(ys)


def kalman_log_marginal(ys, a=0.9, q=0.5, r=0.3, mu0=0.0, p0=1.0) -> float:
    """Exact log p(y_1:T) of the 1-D linear-Gaussian model, in float64."""
    ll, mu, p = 0.0, mu0, p0
    for y in ys:
        s = p + r
        ll += -0.5 * (np.log(2 * np.pi * s) + (y - mu) ** 2 / s)
        k = p / s
        mu, p = mu + k * (y - mu), (1 - k) * p
        mu, p = a * mu, a * a * p + q
    return float(ll)


def phase_linear_gaussian(n: int = 1 << 20, steps: int = 32) -> dict:
    """The same batched filter on a linear-Gaussian model: log Z against
    the exact Kalman log-marginal."""
    from genjax_xla.inference.pf import particle_filter

    a, q, r = 0.9, 0.5, 0.3
    ys_np = simulate_linear_gaussian(steps, a, q, r)
    ys = jnp.asarray(ys_np, jnp.float32)

    def init(key):
        x0 = jax.random.normal(key, (n,))
        return x0, jax.scipy.stats.norm.logpdf(ys[0], x0, np.sqrt(r))

    def step(key, xs, y):
        xs = a * xs + np.sqrt(q) * jax.random.normal(key, (n,))
        return xs, jax.scipy.stats.norm.logpdf(y, xs, np.sqrt(r))

    pf = particle_filter(init, step, n, batched=True)
    run = jax.jit(lambda key: pf(key, ys[1:])[0].log_z)
    got = float(run(jax.random.key(2)))
    want = kalman_log_marginal(ys_np, a, q, r)
    # Monte Carlo error of log Z: about 0.6 / sqrt(n) per step of
    # horizon here; five of those over the horizon.
    tol = 5 * 0.6 * np.sqrt(steps / n) + 1e-4 * abs(want)
    return _result("c.linear_gaussian_vs_kalman", abs(got - want), tol, F32,
                   log_z=got, exact=want, particles=n,
                   seconds=_seconds(run, jax.random.key(2)))


def phase_resample(n: int = 1 << 20, width: int = 64) -> dict:
    """``resample_tree`` against ``jnp.repeat`` of the same offspring
    counts, bitwise, for a scalar leaf and an ``(n, width)`` leaf; and
    the time of the CDF pass and of the expansion."""
    from genjax_xla.inference.smc import (
        resample_tree,
        systematic_offspring_counts,
        systematic_offspring_cumulative,
    )

    key = jax.random.key(5)
    lw = 2.0 * jax.random.normal(jax.random.key(6), (n,))
    tree = {"x": jax.random.normal(jax.random.key(7), (n,)),
            "v": jax.random.normal(jax.random.key(8), (n, width))}

    @jax.jit
    def both(key, lw, tree):
        counts = systematic_offspring_counts(key, lw, n)
        want = jax.tree_util.tree_map(
            lambda v: jnp.repeat(v, counts, axis=0, total_repeat_length=n),
            tree,
        )
        return resample_tree(key, lw, tree, n), want

    got, want = both(key, lw, tree)
    mismatches = sum(
        int(np.sum(np.asarray(got[k]) != np.asarray(want[k]))) for k in tree
    )
    cdf = jax.jit(lambda k, w: systematic_offspring_cumulative(k, w, n))
    res_x = jax.jit(lambda k, w, x: resample_tree(k, w, x, n))
    return _result(
        "c.resample_bitwise", mismatches, 0, "exact selection",
        particles=n, width=width,
        cdf_seconds=_seconds(cdf, key, lw),
        resample_scalar_seconds=_seconds(res_x, key, lw, tree["x"]),
        resample_wide_seconds=_seconds(res_x, key, lw, tree["v"]),
    )


# ---------------------------------------------------------------------------
# d. Discrete HMM
# ---------------------------------------------------------------------------


def phase_hmm_parallel(states: int = 256, steps: int = 1024) -> dict:
    """Parallel-prefix forward filtering (``associative_scan`` of
    ``log_matmul``) against the sequential filter: the largest L1
    distance between filtering distributions, and the relative error of
    the log-marginal, whichever is larger."""
    from genjax_xla.inference.exact_testbed import sample_problem
    from genjax_xla.lang.distributions.discrete_hmm import (
        DiscreteHMMConfiguration,
        forward_filter,
        forward_filter_parallel,
    )

    config = DiscreteHMMConfiguration.circulant(states, states)
    obs = sample_problem(jax.random.key(3), config, steps).observations
    seq = jax.jit(lambda o: forward_filter(config, o))
    par = jax.jit(lambda o: forward_filter_parallel(config, o))
    (a_seq, lz_seq), (a_par, lz_par) = seq(obs), par(obs)
    p_seq = jax.nn.softmax(a_seq, axis=-1)
    p_par = jax.nn.softmax(a_par, axis=-1)
    l1 = float(jnp.max(jnp.sum(jnp.abs(p_par - p_seq), axis=-1)))
    rel = abs(float(lz_par) - float(lz_seq)) / abs(float(lz_seq))
    # Float32 round-off of log-values as large as |log Z| (about 7e-6
    # relative at 256 states and 1024 steps, computed exactly on the
    # CPU); a TF32 product would be off by about 1e-3.
    return _result("d.hmm_parallel_vs_sequential", max(l1, rel), 1e-3,
                   F32_HIGHEST, l1=l1, log_marginal_rel_error=rel,
                   states=states, steps=steps,
                   seconds_parallel=_seconds(par, obs),
                   seconds_sequential=_seconds(seq, obs))


def phase_hmm_filter(states: int = 64, steps: int = 64,
                     n: int = 1 << 19) -> list[dict]:
    """``models.hmm_bootstrap_filter`` (benchmark config 3) against the
    exact forward log-marginal, for both transition samplers."""
    from genjax_xla.inference.exact_testbed import sample_problem
    from genjax_xla.lang.distributions.discrete_hmm import (
        DiscreteHMMConfiguration,
        forward_filter,
    )
    from genjax_xla.models import hmm_bootstrap_filter

    config = DiscreteHMMConfiguration.circulant(states, states)
    obs = sample_problem(jax.random.key(3), config, steps).observations
    exact = float(forward_filter(config, obs)[1])
    # Monte Carlo error of log Z, with room for the horizon: 0.1 at
    # config 3's size, growing as 1/sqrt(n) below it.
    tol = 0.1 * np.sqrt((1 << 19) / n) * np.sqrt(steps / 64)
    out = []
    for sampling in ("invcdf", "gumbel"):
        pf = hmm_bootstrap_filter(config, n, sampling=sampling)
        run = jax.jit(lambda key: pf(key, obs)[0].log_z)
        got = float(run(jax.random.key(5)))
        sec = _seconds(run, jax.random.key(5))
        out.append(_result(f"d.hmm_filter_{sampling}", abs(got - exact),
                           tol, "exact selection (gather)", log_z=got,
                           exact=exact, particles=n, seconds=sec,
                           particle_steps_per_s=n * steps / sec))
    return out


# ---------------------------------------------------------------------------
# e. NUTS on the conjugate regression of benchmark config 2
# ---------------------------------------------------------------------------


def _regression_target():
    """Benchmark config 2's regression: N(0, 2) priors on slope and
    intercept, 128 noise-free points observed with known noise 0.2."""
    from genjax_xla.inference import Target

    xs = jnp.linspace(-1.0, 1.0, 128)
    ys = 2.0 * xs - 0.5

    @g.gen
    def reg(xs):
        slope = g.normal(0.0, 2.0) @ "slope"
        icept = g.normal(0.0, 2.0) @ "icept"
        _ = g.mv_normal_diag(slope * xs + icept, 0.2 * jnp.ones_like(xs)) @ "ys"

    return Target(reg, (xs,), g.C["ys"].set(ys)), xs, ys


def _posterior_error(slope, icept, xs, ys):
    """Largest error of the draws' mean and standard deviation against
    the exact posterior, in posterior standard deviations."""
    draws = np.stack([np.asarray(slope, np.float64).ravel(),
                      np.asarray(icept, np.float64).ravel()], -1)
    mean, sd = regression_posterior(xs, ys)
    return max((np.abs(draws.mean(0) - mean) / sd).max(),
               np.abs(draws.std(0) / sd - 1.0).max()), draws, mean, sd


def regression_posterior(xs, ys, prior_sd=2.0, noise_sd=0.2):
    """Exact Gaussian posterior of (slope, icept) in float64."""
    X = np.stack([np.asarray(xs, np.float64), np.ones(len(xs))], axis=1)
    prec = np.eye(2) / prior_sd**2 + X.T @ X / noise_sd**2
    cov = np.linalg.inv(prec)
    mean = cov @ (X.T @ np.asarray(ys, np.float64)) / noise_sd**2
    return mean, np.sqrt(np.diag(cov))


def phase_nuts(chains: int = 2048, warmup: int = 200,
               samples: int = 200) -> dict:
    """``run_nuts`` posterior mean and standard deviation of slope and
    intercept against the closed-form posterior, in posterior standard
    deviations."""
    from genjax_xla.inference import run_nuts

    target, xs, ys = _regression_target()

    @jax.jit
    def run(key):
        chms, _ = run_nuts(target, key, n_chains=chains, num_warmup=warmup,
                           num_samples=samples, max_depth=6)
        return chms["slope"], chms["icept"]

    error, draws, mean, sd = _posterior_error(*run(jax.random.key(0)), xs, ys)
    # 0.1 posterior sd: about ten Monte Carlo standard errors at
    # chains * samples / 10 effective draws.
    tol = 0.1 * np.sqrt(2048 * 200 / (chains * samples))
    return _result("e.nuts_conjugate_regression", error, tol, F32,
                   mean=draws.mean(0).tolist(), exact_mean=mean.tolist(),
                   sd=draws.std(0).tolist(), exact_sd=sd.tolist(),
                   chains=chains, seconds=_seconds(run, jax.random.key(0)))


# ---------------------------------------------------------------------------
# f. Four cards: the sharded paths on 1-D meshes, against one card
# ---------------------------------------------------------------------------


def _mesh(devices, name):
    from genjax_xla.parallel import Mesh

    return Mesh(np.asarray(devices), (name,))


def _spans(tree, n_dev) -> bool:
    """Every array leaf is laid out over ``n_dev`` devices."""
    return all(len(x.sharding.device_set) == n_dev
               for x in jax.tree_util.tree_leaves(tree))


def phase_multi(devices=None, particles: int = 1 << 22, states: int = 64,
                steps: int = 4096, chains: int = 2048,
                svgd_particles: int = 4096) -> list[dict]:
    """The sharded paths on a 1-D mesh over ``devices`` (four cards by
    default), each against the same program on a one-device mesh or
    against its oracle, and each checked to span every device."""
    from genjax_xla.inference import run_nuts
    from genjax_xla.lang.distributions.discrete_hmm import (
        DiscreteHMMConfiguration,
        forward_filter,
    )
    from genjax_xla.inference.exact_testbed import sample_problem
    from genjax_xla.parallel import (
        run_sharded_svgd,
        shardmap_systematic_resample,
        sharded_smc_step,
        time_sharded_filter,
    )

    devices = list(devices if devices is not None else jax.devices()[:4])
    n_dev = len(devices)
    one = devices[:1]
    out = []

    # sharded_smc_step: particles bitwise, log Z to reduction order.
    target = _beta_bernoulli_target(True)

    def smc(devs):
        step = sharded_smc_step(target, particles, _mesh(devs, "particles"),
                                ess_threshold=1.1)
        col, logz = jax.jit(step)(jax.random.key(0))
        return col.get_particles().get_choices()["p"], logz

    (p4, lz4), (p1, lz1) = smc(devices), smc(one)
    mismatches = int(np.sum(np.asarray(p4) != np.asarray(p1)))
    lz_err = abs(float(lz4) - float(lz1))
    out.append(_result(
        "f.sharded_smc_step", mismatches if lz_err <= 1e-5 else np.inf,
        0, F32, log_z_abs_diff=lz_err, log_z=float(lz4),
        particles=particles, spans=_spans(p4, n_dev)))

    # shardmap_systematic_resample (ppermute ring). Its CDF is summed per
    # shard, so boundaries may move against one card's by float32
    # reordering: the particles carry their own index, and the offspring
    # boundaries are compared with resample_tree's on one card.
    from genjax_xla.inference.smc import resample_tree

    lw = 2.0 * jax.random.normal(jax.random.key(1), (particles,))
    idx = jnp.arange(particles, dtype=jnp.float32)
    mesh_p = _mesh(devices, "particles")
    anc4 = jax.jit(lambda k, w, x: shardmap_systematic_resample(
        k, w, x, mesh_p))(jax.random.key(3), lw, idx)
    anc1 = jax.jit(lambda k, w, x: resample_tree(k, w, x, particles))(
        jax.random.key(3), lw, idx)
    a4, a1 = np.asarray(anc4).astype(np.int64), np.asarray(anc1).astype(np.int64)
    shift = np.abs(np.cumsum(np.bincount(a4, minlength=particles))
                   - np.cumsum(np.bincount(a1, minlength=particles))).max()
    valid = bool((np.diff(a4) >= 0).all() and a4.min() >= 0
                 and a4.max() < particles)
    # The scaled CDF reaches n, where a float32 ulp is n * 2^-23 (0.5 at
    # 2^22); summing it per shard moves a boundary by a few ulps at most.
    # Allow four ulps of n in destinations (2 at 2^22), and at least 2.
    out.append(_result(
        "f.ring_systematic_resample", shift if valid else np.inf,
        max(2, 4 * particles * 2**-23), "float32 CDF, exact selection",
        boundary_shift=int(shift), differing=int(np.sum(a4 != a1)),
        particles=particles, spans=_spans(anc4, n_dev)))

    # time_sharded_filter against the sequential forward filter.
    config = DiscreteHMMConfiguration.circulant(states, states)
    obs = sample_problem(jax.random.key(4), config, steps).observations
    mesh_t = _mesh(devices, "time")
    alphas, lz = jax.jit(
        lambda o: time_sharded_filter(config, o, mesh_t))(obs)
    a_seq, lz_seq = jax.jit(lambda o: forward_filter(config, o))(obs)
    l1 = float(jnp.max(jnp.sum(jnp.abs(
        jax.nn.softmax(alphas, -1) - jax.nn.softmax(a_seq, -1)), -1)))
    rel = abs(float(lz) - float(lz_seq)) / abs(float(lz_seq))
    out.append(_result(
        "f.time_sharded_filter", max(l1, rel), 1e-3, F32, l1=l1,
        log_marginal_rel_error=rel, states=states, steps=steps,
        spans=_spans(alphas, n_dev)))

    # run_nuts with the chain axis on the mesh: the conjugate posterior.
    reg_target, xs_r, ys_r = _regression_target()

    def nuts(devs):
        mesh = _mesh(devs, "chains")
        chms, _ = jax.jit(lambda k: run_nuts(
            reg_target, k, n_chains=chains, num_warmup=200, num_samples=200,
            max_depth=6, mesh=mesh))(jax.random.key(5))
        return chms["slope"], chms["icept"]

    (s4, i4), (s1, _) = nuts(devices), nuts(one)
    error = _posterior_error(s4, i4, xs_r, ys_r)[0]
    out.append(_result(
        "f.run_nuts_chain_mesh", error,
        0.1 * np.sqrt(2048 / chains), F32, chains=chains,
        bitwise_vs_one_card=bool(np.array_equal(np.asarray(s4),
                                                np.asarray(s1))),
        spans=_spans((s4, i4), n_dev)))

    # run_sharded_svgd on a Gaussian target: ensemble mean and scale.
    mu = jnp.arange(1.0, 5.0)
    scale = jnp.array([0.5, 1.0, 1.5, 2.0])

    def logp(z):
        return -0.5 * jnp.sum(((z - mu) / scale) ** 2)

    x0 = jax.random.normal(jax.random.key(6), (svgd_particles, 4))

    def svgd(devs):
        mesh = _mesh(devs, "particles")
        return jax.jit(lambda x: run_sharded_svgd(
            logp, x, n_steps=300, step_size=0.1, mesh=mesh))(x0)

    e4, e1 = svgd(devices), svgd(one)
    got = np.asarray(e4, np.float64)
    error = max(np.abs(got.mean(0) - np.asarray(mu)).max(),
                np.abs(got.std(0) / np.asarray(scale) - 1.0).max())
    out.append(_result(
        "f.run_sharded_svgd", error, 0.3, F32, particles=svgd_particles,
        bitwise_vs_one_card=bool(np.array_equal(got, np.asarray(e1))),
        spans=_spans(e4, n_dev)))

    for r in out:
        r["ok"] = r["ok"] and r["spans"]
    return out


# ---------------------------------------------------------------------------
# Driver
# ---------------------------------------------------------------------------


#: Phases a-e after the device check, in order; each returns one result
#: or a list of them.
SINGLE_CARD_PHASES = (phase_quickstart, phase_tracking, phase_linear_gaussian,
                      phase_resample, phase_hmm_parallel, phase_hmm_filter,
                      phase_nuts)


def gpu_name_and_power_limit() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--multi", action="store_true",
                    help="run only the sharded phase, on four GPUs")
    args = ap.parse_args(argv)

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: needs a GPU, JAX found {dev.platform!r}",
              file=sys.stderr)
        return 2
    n_dev = 4 if args.multi else 1
    if len(jax.devices()) < n_dev:
        print(f"chip_smoke: needs {n_dev} GPUs, found {len(jax.devices())}",
              file=sys.stderr)
        return 2
    print(f"# cache: {enable_compile_cache()}", flush=True)
    print(gpu_name_and_power_limit(), flush=True)
    print(json.dumps({"phase": "a.device", "ok": True,
                      "kind": dev.device_kind,
                      "count": len(jax.devices())}), flush=True)

    results = []
    for phase in (phase_multi,) if args.multi else SINGLE_CARD_PHASES:
        out = phase()
        for r in out if isinstance(out, list) else [out]:
            results.append(r)
            print(json.dumps(r), flush=True)
    failed = [r["phase"] for r in results if not r["ok"]]
    if failed:
        print(f"chip_smoke: failed phases: {failed}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices()),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
