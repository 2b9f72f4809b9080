"""The benchmark configs, each printing one JSON line.
``bench.py`` at the repo root runs them all with config 4 (the headline
particle filter) first; this module holds the configs and runs any
subset of them on the default backend.

Usage: python benchmarks/run_all.py [--config N] [--small]
"""

import argparse
import json
import time

import jax
import jax.numpy as jnp


def device_record() -> dict:
    """The device a result was measured on, as JAX reports it."""
    dev = jax.devices()[0]
    return {"platform": dev.platform, "kind": dev.device_kind,
            "count": len(jax.devices())}


def _sync_time(fn, *args, reps: int = 1, return_times: bool = False):
    """Compile and warm up with one call, then time ``reps`` calls, each
    ended by ``block_until_ready``; keep the best. With
    ``return_times``, also return every rep's time so a config can
    report median and spread."""
    jax.block_until_ready(fn(*args))
    best_dt, out = None, None
    times = []
    for _ in range(max(1, reps)):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn(*args))
        dt = time.perf_counter() - t0
        times.append(dt)
        best_dt = dt if best_dt is None else min(best_dt, dt)
    if return_times:
        return out, best_dt, times
    return out, best_dt


def config1_sir(small: bool):
    """Beta-Bernoulli SIR (README quickstart)."""
    import genjax_xla as g
    from genjax_xla.inference import ImportanceK, Target

    @g.gen
    def bb(a, b):
        p = g.beta(a, b) @ "p"
        v = g.flip(p) @ "v"
        return v

    # 1024 trials of 1024 particles, 16 reps folded into one jitted scan.
    k, trials, reps = (1024, 1024, 16) if not small else (64, 8, 2)
    target = Target(bb, (2.0, 2.0), g.C["v"].set(True))
    alg = ImportanceK(target, k_particles=k)

    @jax.jit
    def run(key):
        def body(c, i):
            keys = jax.random.split(jax.random.fold_in(key, i), trials)
            col = jax.vmap(alg.run_smc)(keys)
            return c + col.get_log_marginal_likelihood_estimate().sum(), None

        tot, _ = jax.lax.scan(body, jnp.zeros(()), jnp.arange(reps))
        return tot

    _, dt = _sync_time(run, jax.random.key(0))
    n = k * trials * reps
    return {
        "metric": "sir_beta_bernoulli_throughput",
        "value": round(n / dt, 1),
        "unit": "particles/s",
        "vs_baseline": 1.0,
    }


def config2_nuts(small: bool):
    """Hierarchical regression NUTS effective-samples/s: 2048
    data-parallel chains on a 128-point likelihood, vmapped into one
    program; the identical program defines the CPU baseline."""
    import genjax_xla as g
    from genjax_xla.inference import Target, ess_autocorr, run_nuts

    n_pts = 128
    xs = jnp.linspace(-1.0, 1.0, n_pts)
    ys = 2.0 * xs - 0.5

    @g.gen
    def reg(xs):
        slope = g.normal(0.0, 2.0) @ "slope"
        icept = g.normal(0.0, 2.0) @ "icept"
        _ = g.mv_normal_diag(
            slope * xs + icept, 0.2 * jnp.ones_like(xs)
        ) @ "ys"

    target = Target(reg, (xs,), g.C["ys"].set(ys))
    chains = 2048 if not small else 4
    # 1600 sampling draws amortize the 200-iteration warmup.
    warm, samp = (200, 1600) if not small else (50, 50)

    def run(k):
        chms, infos = run_nuts(
            target, k, n_chains=chains, num_warmup=warm,
            num_samples=samp, max_depth=6,
        )
        return chms["slope"], infos.num_steps

    fn = jax.jit(run)
    on_cpu = jax.devices()[0].platform == "cpu"
    # Median of 5 timed reps plus the spread; ESS is analysis, computed
    # after the clock stops.
    (slopes, num_steps), _best, times = _sync_time(
        fn, jax.random.key(0), reps=1 if (small or on_cpu) else 5,
        return_times=True,
    )
    dt = sorted(times)[len(times) // 2]
    ess = float(ess_autocorr(slopes))
    return {
        "metric": "nuts_hier_regression_ess_per_s",
        "value": round(ess / dt, 1),
        "unit": "eff-samples/s",
        "vs_baseline": 1.0,
        "value_spread": [round(ess / max(times), 1),
                         round(ess / min(times), 1)],
        "n_timed_runs": len(times),
    }


def config3_hmm_smc(small: bool):
    """Discrete HMM logZ via SMC with systematic resampling, vs exact:
    ``models.hmm_bootstrap_filter`` advances the whole 512k-particle
    ensemble at once, with one key per step."""
    from genjax_xla.lang.distributions.discrete_hmm import (
        DiscreteHMMConfiguration, forward_filter,
    )
    from genjax_xla.models import hmm_bootstrap_filter

    S, T = (64, 64) if not small else (8, 16)
    config = DiscreteHMMConfiguration.circulant(S, S)
    # Typical observations (simulated from the model): uniformly random
    # ones are astronomically unlikely under the peaked circulant
    # emissions at large S and degrade any prior-proposal filter.
    from genjax_xla.inference.exact_testbed import sample_problem

    problem = sample_problem(jax.random.key(3), config, T)
    obs = problem.observations
    _, exact = forward_filter(config, obs)

    n = 1 << (19 if not small else 10)
    pf = hmm_bootstrap_filter(config, n)
    on_cpu = jax.devices()[0].platform == "cpu"
    reps = 1 if (small or on_cpu) else 8

    @jax.jit
    def fn(k):
        def body(c, i):
            return c + pf(jax.random.fold_in(k, i), obs)[0].log_z, None

        tot, _ = jax.lax.scan(body, jnp.zeros(()), jnp.arange(reps))
        return tot / reps

    logz, dt = _sync_time(fn, jax.random.key(0))
    dt = dt / reps
    psteps = n * T
    return {
        "metric": "hmm_smc_particle_steps_per_s",
        "value": round(psteps / dt, 1),
        "unit": "particle-steps/s",
        "vs_baseline": 1.0,
        "logz_abs_error": round(abs(float(logz) - float(exact)), 4),
    }


def build_pf(n_particles: int, n_steps: int, state_dtype=jnp.float32):
    """Config 4's filter: bootstrap particle filter on the nonlinear 1-D
    tracking model, the whole filter (propagation, weighting, ESS,
    adaptive systematic resampling) in one ``lax.scan``. Returns
    ``(run(key) -> log Z, particle-steps per run)``."""
    from genjax_xla.inference.pf import particle_filter

    # Batched (array-level) model: one key per step, whole-ensemble ops.
    # ``state_dtype=jnp.bfloat16`` keeps the particle STATE in bf16;
    # log-weights and the dynamics stay f32.
    def init(key):
        return (
            jax.random.normal(key, (n_particles,)).astype(state_dtype),
            jnp.zeros((n_particles,)),
        )

    def step(key, xs, y):
        xf = xs.astype(jnp.float32)
        xs_new = (
            0.5 * xf
            + 25.0 * xf / (1.0 + xf * xf)
            + jnp.sqrt(10.0) * jax.random.normal(key, (n_particles,))
        )
        lw = jax.scipy.stats.norm.logpdf(y, xs_new * xs_new / 20.0, 1.0)
        return xs_new.astype(state_dtype), lw

    pf = particle_filter(init, step, n_particles, batched=True)
    ys = jax.random.normal(jax.random.key(9), (n_steps,)) * 5.0

    def run(key):
        final, _ = pf(key, ys)
        return final.log_z

    return run, n_particles * n_steps


def config4_tracking(small: bool):
    """Nonlinear 1-D tracking particle filter, 2^20 particles x 32
    steps (the headline)."""
    n = 1 << (20 if not small else 12)
    run, work = build_pf(n, 32)
    _, dt = _sync_time(jax.jit(run), jax.random.key(0))
    return {
        "metric": "particle_filter_nonlinear_tracking_throughput",
        "value": round(work / dt, 1),
        "unit": "particle-steps/s",
        "vs_baseline": 1.0,
    }


def config5_vi(small: bool):
    """ADEV VI on a mixture model: ELBO grad steps/s."""
    import genjax_xla as g
    from genjax_xla.inference import Target, marginal, vi

    @g.gen
    def model(v):
        comp = g.flip(0.5) @ "comp"
        mu = g.normal(jnp.where(comp, v, -v), 1.0) @ "mu"
        _ = g.normal(mu, 0.5) @ "y"

    @marginal()
    @g.gen
    def guide(target):
        (v,) = target.args
        b = vi.flip_enum(0.5) @ "comp"
        _ = vi.normal_reparam(jnp.where(b, v, -v), 0.5) @ "mu"

    loss_grad = vi.ELBO(
        guide, lambda v: Target(model, (v,), g.C["y"].set(1.0))
    )
    # A sweep of 64k independent fits (vmapped; the per-entity-model
    # pattern: one small VI fit per cell/user/series), each step
    # averaging an S-sample ELBO gradient. Uses the ADEV vmap batching
    # rules (flip_enum under vmap).
    steps = 100 if not small else 10
    fits = 65536 if not small else 4
    elbo_samples = 8
    # Reps fold into one jitted scan, like configs 1/3/6.
    on_cpu = jax.devices()[0].platform == "cpu"
    reps = 1 if (small or on_cpu) else 8

    def one_rep(key):
        def one_fit(v0, fkey):
            def body(v, i):
                ks = jax.random.split(
                    jax.random.fold_in(fkey, i), elbo_samples
                )
                dvs = jax.vmap(lambda kk: loss_grad(kk, (v,))[0])(ks)
                return v - 1e-3 * dvs.mean(), None

            v, _ = jax.lax.scan(body, v0, jnp.arange(steps))
            return v

        v0s = jnp.linspace(0.2, 0.8, fits)
        return jax.vmap(one_fit)(v0s, jax.random.split(key, fits))

    @jax.jit
    def run(key):
        def body(c, i):
            return c + jnp.sum(one_rep(jax.random.fold_in(key, i))), None

        tot, _ = jax.lax.scan(body, jnp.zeros(()), jnp.arange(reps))
        return tot

    _, _best, times = _sync_time(
        run, jax.random.key(0), reps=1 if (small or on_cpu) else 5,
        return_times=True,
    )
    dt = sorted(times)[len(times) // 2]
    dt = dt / reps
    r = {
        "metric": "adev_vi_mixture_grad_steps_per_s",
        "value": round(fits * steps / dt, 2),
        "unit": "grad-steps/s",
        "vs_baseline": 1.0,
    }
    r["value_spread"] = [
        round(reps * fits * steps / max(times), 2),
        round(reps * fits * steps / min(times), 2),
    ]
    r["n_timed_runs"] = len(times)
    return r


def config6_tempered(small: bool):
    """Tempered SMC with Regenerate rejuvenation (MCMC-within-SMC):
    particle-rung-moves/s on a hierarchical Gaussian target.

    Exercises the trace-level machinery end to end: vmapped importance
    traces, per-rung reweighting, joint (trace, loglik) resampling with
    ensemble-invariant leaf skipping (core/compiler/taint.py), and MH
    rejuvenation via GFI edits. logZ is checked against the
    conjugate closed form."""
    import numpy as np

    import genjax_xla as g
    from genjax_xla.inference import Target
    from genjax_xla.inference.smc_sampler import tempered_smc

    n_obs = 64
    ys = 1.5 + 0.7 * jax.random.normal(jax.random.key(0), (n_obs,))

    @g.gen
    def model(sigma):
        mu = g.normal(0.0, 3.0) @ "mu"
        _ = g.mv_normal_diag(
            mu * jnp.ones(n_obs), sigma * jnp.ones(n_obs)
        ) @ "ys"

    sigma = 0.8
    target = Target(model, (sigma,), g.C["ys"].set(ys))
    P, rungs, moves = (1 << 19, 16, 2) if not small else (256, 4, 1)
    run = tempered_smc(target, P, n_temps=rungs, n_moves=moves)
    # Reps fold into one jitted scan; the committed CPU baseline was
    # measured at 4.
    on_cpu = jax.devices()[0].platform == "cpu"
    reps = (4 if on_cpu else 16) if not small else 1

    @jax.jit
    def fn(k):
        def body(c, i):
            return c + run(jax.random.fold_in(k, i)).log_z, None

        tot, _ = jax.lax.scan(body, jnp.zeros(()), jnp.arange(reps))
        return tot / reps

    logz, dt = _sync_time(fn, jax.random.key(1))
    dt = dt / reps

    # Conjugate closed form: ys | mu ~ N(mu, sigma^2 I), mu ~ N(0, 9).
    y = np.asarray(ys, np.float64)
    s2, t2, n_ = sigma**2, 9.0, float(n_obs)
    post_var = 1.0 / (1.0 / t2 + n_ / s2)
    exact = float(
        -0.5 * n_ * np.log(2 * np.pi * s2)
        - 0.5 * (y**2).sum() / s2
        + 0.5 * (post_var * (y.sum() / s2) ** 2)
        + 0.5 * np.log(post_var / t2)
    )
    prm = P * rungs * moves
    return {
        "metric": "tempered_smc_particle_rung_moves_per_s",
        "value": round(prm / dt, 1),
        "unit": "particle-rung-moves/s",
        "vs_baseline": 1.0,
        "logz_abs_error": round(abs(float(logz) - exact), 4),
    }


def config7_smc2(small: bool):
    """SMC² on an unknown-coefficient LGSSM: sequential joint
    parameter+state inference (a θ-ensemble of inner bootstrap filters
    with PMMH rejuvenation). Unit: inner particle-steps/s
    (N_θ · N_x · T / wall). The evidence estimate is checked against
    exact Kalman quadrature over the parameter grid."""
    from genjax_xla.inference import smc2
    from genjax_xla.models import lgssm_grid_posterior, simulate_lgssm_data

    A_TRUE, Q, R = 0.7, 0.4, 0.4
    T = 50
    ys = simulate_lgssm_data(jax.random.key(11), A_TRUE, Q, R, T)[1]

    n_theta, n_x = (1024, 1024) if not small else (32, 32)
    run = smc2(
        lambda key, a, n: jnp.sqrt(Q) * jax.random.normal(key, (n,)),
        lambda key, a, xs: a * xs
        + jnp.sqrt(Q) * jax.random.normal(key, xs.shape),
        lambda a, xs, y: jax.scipy.stats.norm.logpdf(
            y, xs, jnp.sqrt(R)
        ),
        lambda key: jax.random.uniform(key, minval=-0.95, maxval=0.95),
        lambda a: jnp.where(jnp.abs(a) < 0.95, -jnp.log(1.9), -jnp.inf),
        n_theta=n_theta, n_x=n_x, proposal=0.15,
    )
    fn = jax.jit(lambda k: run(k, ys).log_z)
    logz, dt = _sync_time(fn, jax.random.key(1))

    _, _, exact = lgssm_grid_posterior(
        ys, Q, R, jnp.linspace(-0.949, 0.949, 191)
    )
    exact = float(exact)
    psteps = float(n_theta) * n_x * T
    return {
        "metric": "smc2_inner_particle_steps_per_s",
        "value": round(psteps / dt, 1),
        "unit": "particle-steps/s",
        "vs_baseline": 1.0,
        "logz_abs_error": round(abs(float(logz) - exact), 4),
    }


def config8_mxu_logreg(small: bool):
    """Matmul-bound NUTS: Bayesian logistic regression with a
    (N=8192, D=512) design matrix across 1024 chains. Every leapfrog's
    value-and-grad is two (N, D) matmuls batched over the chain axis
    (XLA fuses them into one (N, D) x (D, chains) contraction each
    way), so the per-while-iteration overhead that bounds config 2
    amortizes into real matrix work.

    Unit: chain-leapfrogs/s = sampling-phase leapfrog count (summed
    over chains and samples) / total wall (warmup of equal length
    included in the denominator — consistent on both backends, so the
    CPU ratio is fair). The host-CPU baseline runs the identical
    per-chain program with a smaller ensemble and fewer samples
    (full-size is hours on host; throughput is per-unit so the ratio
    stays meaningful)."""
    import numpy as np

    import genjax_xla as g
    from genjax_xla.inference import Target, run_nuts

    on_cpu = jax.devices()[0].platform == "cpu"
    N, D = (8192, 512) if not small else (128, 16)
    if small:
        chains, warm, samp = 4, 10, 10
    elif on_cpu:
        chains, warm, samp = 32, 20, 20
    else:
        chains, warm, samp = 1024, 100, 100

    kx = jax.random.key(0)
    X = jax.random.normal(kx, (N, D)) / jnp.sqrt(float(D))
    beta_true = jnp.where(jnp.arange(D) < D // 8, 1.5, 0.0)
    y = jax.random.bernoulli(
        jax.random.key(1), jax.nn.sigmoid(X @ beta_true)
    ).astype(jnp.float32)

    @g.gen
    def logreg(X):
        beta = g.mv_normal_diag(jnp.zeros(D), jnp.ones(D)) @ "beta"
        _ = g.bernoulli(X @ beta) @ "y"

    target = Target(logreg, (X,), g.C["y"].set(y))

    def run(k):
        chms, infos = run_nuts(
            target, k, n_chains=chains, num_warmup=warm,
            num_samples=samp, max_depth=5,
        )
        # Reduce on device: returning the raw (chains, samples, D)
        # draws would time a ~200 MB host transfer, not the sampler.
        return (
            jnp.mean(chms["beta"], axis=(0, 1)),
            jnp.sum(infos.num_steps),
        )

    fn = jax.jit(run)
    (post_mean, num_steps), dt = _sync_time(
        fn, jax.random.key(2), reps=1 if on_cpu else 3
    )
    # Sanity: posterior mean must recover the active coefficients'
    # sign pattern (a cheap correctness gate, not a statistical test).
    post_mean = np.asarray(post_mean)
    active = post_mean[: D // 8].mean()
    inactive = np.abs(post_mean[D // 8:]).mean()
    leapfrogs = float(np.asarray(num_steps))
    return {
        "metric": "nuts_mxu_logreg_chain_leapfrogs_per_s",
        "value": round(leapfrogs / dt, 1),
        "unit": "chain-leapfrogs/s",
        "vs_baseline": 1.0,
        "posterior_sep": round(float(active - inactive), 3),
    }


def config9_bnn_vi(small: bool):
    """Matmul-bound ADEV VI: mean-field Gaussian posterior over the
    weights of a (512 -> 1024 -> 1) tanh network, 8192-point likelihood
    batch. Each ELBO gradient step is pathwise (reparameterized weight
    tensors flow through the model's matmuls), so one step costs ~3x
    the forward pass' 2·B·DIN·DH flops. This is the matmul-heavy
    counterpart of config 5's per-entity scalar sweep.

    Unit: ELBO grad-steps/s (one 1-sample pathwise gradient + Adam
    update per step, all steps folded into one jitted scan). The CPU
    baseline runs the identical program with fewer steps (per-step
    work unchanged)."""
    import numpy as np

    import genjax_xla as g
    from genjax_xla.inference import Target, marginal, vi

    on_cpu = jax.devices()[0].platform == "cpu"
    DIN, DH, B = (512, 1024, 8192) if not small else (8, 16, 64)
    steps = 10 if small else (20 if on_cpu else 500)

    kX = jax.random.key(3)
    X = jax.random.normal(kX, (B, DIN)) / jnp.sqrt(float(DIN))
    W1t = 0.8 * jax.random.normal(jax.random.key(4), (DIN, DH))
    w2t = jax.random.normal(jax.random.key(5), (DH,)) / jnp.sqrt(float(DH))
    y = jnp.tanh(X @ W1t) @ w2t + 0.1 * jax.random.normal(
        jax.random.key(6), (B,)
    )

    @g.gen
    def bnn(params, X):
        W1 = g.normal(jnp.zeros((DIN, DH)), 1.0) @ "W1"
        w2 = g.normal(jnp.zeros(DH), 1.0) @ "w2"
        f = jnp.tanh(X @ W1) @ w2
        _ = g.mv_normal_diag(f, 0.5 * jnp.ones(B)) @ "y"

    @marginal()
    @g.gen
    def guide(target):
        params, _X = target.args
        _ = vi.normal_reparam(
            params["mu1"], jax.nn.softplus(params["rho1"])
        ) @ "W1"
        _ = vi.normal_reparam(
            params["mu2"], jax.nn.softplus(params["rho2"])
        ) @ "w2"

    loss_grad = vi.ELBO(
        guide, lambda p: Target(bnn, (p, X), g.C["y"].set(y))
    )
    params0 = {
        "mu1": jnp.zeros((DIN, DH)),
        "rho1": -2.0 * jnp.ones((DIN, DH)),
        "mu2": jnp.zeros(DH),
        "rho2": -2.0 * jnp.ones(DH),
    }

    @jax.jit
    def fit(params, key):
        zeros = jax.tree_util.tree_map(jnp.zeros_like, params)

        def body(c, i):
            p, m, v = c
            dp = loss_grad(jax.random.fold_in(key, i), (p,))[0]
            m = jax.tree_util.tree_map(
                lambda a, b: 0.9 * a + 0.1 * b, m, dp
            )
            v = jax.tree_util.tree_map(
                lambda a, b: 0.999 * a + 0.001 * b * b, v, dp
            )
            p = jax.tree_util.tree_map(
                lambda x, mm, vv: x - 1e-2 * mm / (jnp.sqrt(vv) + 1e-8),
                p, m, v,
            )
            return (p, m, v), None

        (p, _, _), _ = jax.lax.scan(
            body, (params, zeros, zeros), jnp.arange(steps)
        )
        # Reduce on device, so the timing is of the optimizer and not
        # of a 4.2 MB transfer. The scalar doubles as the sanity gate:
        # the variational mean must move off zero.
        return jnp.mean(jnp.abs(p["mu1"]))

    moved_arr, _best, times = _sync_time(
        fit, params0, jax.random.key(7), reps=1 if on_cpu else 5,
        return_times=True,
    )
    dt = sorted(times)[len(times) // 2]
    moved = float(moved_arr)
    r = {
        "metric": "bnn_vi_mxu_grad_steps_per_s",
        "value": round(steps / dt, 2),
        "unit": "grad-steps/s",
        "vs_baseline": 1.0,
        "mu_moved": round(moved, 4),
    }
    r["value_spread"] = [round(steps / max(times), 2),
                         round(steps / min(times), 2)]
    r["n_timed_runs"] = len(times)
    return r


def config10_svgd(small: bool):
    """SVGD ensemble fit on a Bayesian linear regression with an exact
    conjugate posterior — the Stein family's official number. Every
    update is dense matrix work: the (N, N) kernel from one Gram matmul,
    two (N, N) x (N, D) contractions, and the per-particle score
    gradients as one batched (B, D) x (D, N) pass. Bandwidth from a
    256-row subsample (the full N^2 median sort would dominate).

    Unit: particle-grad-steps/s = n_particles * steps / wall. The CPU
    baseline runs the identical program with fewer steps (per-step work
    unchanged). Correctness gate: ensemble mean within tolerance of the
    closed-form conjugate posterior mean."""
    import numpy as np

    import genjax_xla as g
    from genjax_xla.inference import Target, run_svgd

    on_cpu = jax.devices()[0].platform == "cpu"
    B, D = (1024, 64) if not small else (32, 4)
    if small:
        parts, steps = 32, 10
    elif on_cpu:
        parts, steps = 4096, 20
    else:
        # 600 steps: 300 is marginal for the convergence gate with any
        # bandwidth estimator (exact median: err 0.042 at 300, 0.004 at
        # 600; strided: 0.040 / 0.002).
        parts, steps = 4096, 600

    kx = jax.random.key(10)
    X = jax.random.normal(kx, (B, D)) / jnp.sqrt(float(D))
    w_true = jnp.linspace(-1.0, 1.0, D)
    y = X @ w_true + 0.25 * jax.random.normal(
        jax.random.key(11), (B,)
    )

    @g.gen
    def blr(X):
        w = g.mv_normal_diag(jnp.zeros(D), jnp.ones(D)) @ "w"
        _ = g.mv_normal_diag(X @ w, 0.25 * jnp.ones(B)) @ "y"

    target = Target(blr, (X,), g.C["y"].set(y))

    def run(k):
        ens = run_svgd(target, k, n_particles=parts, n_steps=steps,
                       step_size=0.05, h_rows=256)
        return jnp.mean(ens["w"], axis=0)

    fn = jax.jit(run)
    post_mean, dt = _sync_time(
        fn, jax.random.key(12), reps=1 if on_cpu else 3
    )
    prec = jnp.eye(D) + X.T @ X / 0.0625
    exact = jnp.linalg.solve(prec, X.T @ y / 0.0625)
    err = float(jnp.max(jnp.abs(post_mean - exact)))
    return {
        "metric": "svgd_blr_particle_grad_steps_per_s",
        "value": round(parts * steps / dt, 1),
        "unit": "particle-grad-steps/s",
        "vs_baseline": 1.0,
        "post_mean_err": round(err, 4),
    }


CONFIGS = {
    1: config1_sir,
    2: config2_nuts,
    3: config3_hmm_smc,
    4: config4_tracking,
    5: config5_vi,
    6: config6_tempered,
    7: config7_smc2,
    8: config8_mxu_logreg,
    9: config9_bnn_vi,
    10: config10_svgd,
}


def load_baseline(path: str | None = None) -> dict:
    """``{metric: host-CPU value}`` for the ``vs_baseline`` ratios; empty
    when the file is missing or unreadable (e.g. truncated by an
    interrupted ``--save-baseline``)."""
    import pathlib

    path = path or str(pathlib.Path(__file__).parent / "baseline_cpu.json")
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return {}


def run_config(c: int, small: bool, baseline: dict) -> dict:
    """Run config ``c`` and return its result line, with the device it
    ran on and the ratio to the CPU baseline."""
    r = CONFIGS[c](small)
    base = baseline.get(r["metric"])
    if base:
        r["vs_baseline"] = round(r["value"] / base, 3)
    r["device"] = device_record()
    return r


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", type=int, default=None)
    ap.add_argument("--small", action="store_true")
    ap.add_argument(
        "--save-baseline", metavar="FILE", default=None,
        help="write {metric: value} to FILE (run this on host CPU: "
        "JAX_PLATFORMS=cpu python benchmarks/run_all.py "
        "--save-baseline benchmarks/baseline_cpu.json)",
    )
    ap.add_argument(
        "--baseline", metavar="FILE", default=None,
        help="baseline JSON for vs_baseline ratios (default: "
        "benchmarks/baseline_cpu.json if present)",
    )
    args = ap.parse_args()
    baseline = {} if args.save_baseline else load_baseline(args.baseline)
    targets = [args.config] if args.config else sorted(CONFIGS)
    results = []
    for c in targets:
        r = run_config(c, args.small, baseline)
        results.append(r)
        print(json.dumps(r), flush=True)
    if args.save_baseline:
        # Merge with any existing file so a --config N run refreshes
        # one entry without dropping the others.
        merged = load_baseline(args.save_baseline)
        merged.update({r["metric"]: r["value"] for r in results})
        with open(args.save_baseline, "w") as f:
            json.dump(merged, f, indent=1)


if __name__ == "__main__":
    import pathlib
    import sys

    sys.path.insert(0, str(pathlib.Path(__file__).parents[1]))
    from genjax_xla.utils.profiling import enable_compile_cache

    enable_compile_cache()
    main()
