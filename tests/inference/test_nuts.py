"""NUTS tests: kernel correctness on Gaussians, trace-level NUTS request,
and end-to-end run_nuts with cross-chain warmup on a hierarchical
regression (benchmark config 2)."""

import jax
import jax.numpy as jnp
import numpy as np

import genjax_xla as g
from genjax_xla.inference import Target, mh
from genjax_xla.inference.adaptation import run_nuts, warmup_chains
from genjax_xla.inference.requests.nuts import NUTS, nuts_kernel

KEY = jax.random.key(314159)


class TestKernel:
    def test_gaussian_moments(self):
        def logp(z):
            return -0.5 * jnp.sum((z - 3.0) ** 2 / 4.0)

        def step(z, key):
            z_new, info = nuts_kernel(logp, z, key, 0.5, max_depth=8)
            return z_new, z_new

        _, zs = jax.lax.scan(
            step, jnp.zeros(1), jax.random.split(KEY, 2000)
        )
        zs = np.asarray(zs)[500:]
        assert abs(zs.mean() - 3.0) < 0.15
        assert abs(zs.std() - 2.0) < 0.15

    def test_anisotropic_with_mass(self):
        def logp(z):
            return -0.5 * (z[0] ** 2 / 100.0 + z[1] ** 2)

        inv_mass = jnp.array([100.0, 1.0])

        def step(z, key):
            z_new, _ = nuts_kernel(
                logp, z, key, 0.8, inv_mass=inv_mass, max_depth=6
            )
            return z_new, z_new

        _, zs = jax.lax.scan(
            step, jnp.zeros(2), jax.random.split(KEY, 2000)
        )
        zs = np.asarray(zs)[400:]
        np.testing.assert_allclose(zs.std(0), [10.0, 1.0], rtol=0.15)


class TestWarmup:
    def test_adapts_eps_and_mass(self):
        def logp(z):
            return -0.5 * jnp.sum(z**2 / jnp.array([25.0, 1.0]))

        z0s = jnp.zeros((4, 2))
        zs, eps, inv_mass = jax.jit(
            lambda k: warmup_chains(logp, z0s, k, num_warmup=400)
        )(KEY)
        assert 0.01 < float(eps) < 10.0
        # mass should reflect the variance ratio ~25:1
        ratio = float(inv_mass[0] / inv_mass[1])
        assert 5.0 < ratio < 125.0


class TestTraceRequest:
    def test_nuts_request_posterior(self):
        @g.gen
        def model():
            mu = g.normal(0.0, 1.0) @ "mu"
            _ = g.normal(mu, 0.5) @ "y"

        tr, _ = model.generate(KEY, g.C["y"].set(1.0), ())

        def kernel(key, trace):
            return mh(key, trace, NUTS(g.S.at["mu"], 0.3, 6))

        from genjax_xla.inference import chain

        runner = chain(kernel)
        _, mus = jax.jit(
            lambda k, t: runner(
                k, t, n_steps=800,
                collect=lambda tr: tr.get_choices()["mu"],
            )
        )(jax.random.key(1), tr)
        mus = np.asarray(mus)[200:]
        assert abs(mus.mean() - 0.8) < 0.05
        assert abs(mus.std() - np.sqrt(0.2)) < 0.05


class TestEndToEnd:
    def test_hierarchical_regression(self):
        """Benchmark config 2: hierarchical linear regression, posterior
        slope recovery with cross-chain-adapted NUTS."""
        xs = jnp.linspace(-1.0, 1.0, 20)
        true_slope, true_icept = 2.0, -0.5
        ys_obs = true_slope * xs + true_icept

        @g.gen
        def regression(xs):
            slope = g.normal(0.0, 2.0) @ "slope"
            icept = g.normal(0.0, 2.0) @ "icept"
            # Manual unconstrained parameterization (the constrained
            # route is covered by TestSupportTransforms).
            log_sigma = g.normal(-2.0, 0.5) @ "log_sigma"
            sigma = jnp.exp(log_sigma)
            _ = g.mv_normal_diag(
                slope * xs + icept, sigma * jnp.ones_like(xs)
            ) @ "ys"

        target = Target(regression, (xs,), g.C["ys"].set(ys_obs))
        chms, infos = jax.jit(
            lambda k: run_nuts(
                target, k, n_chains=4, num_warmup=300, num_samples=500,
                max_depth=6,
            )
        )(KEY)
        slopes = np.asarray(chms["slope"])  # (chains, samples)
        icepts = np.asarray(chms["icept"])
        assert abs(slopes.mean() - true_slope) < 0.1
        assert abs(icepts.mean() - true_icept) < 0.1
        # R-hat-ish: chains agree
        assert np.std(slopes.mean(axis=1)) < 0.1


class TestSupportTransforms:
    def test_positive_constrained_sigma(self):
        """NUTS samples a positive-constrained noise scale natively via
        the softplus transform (round-1 required manual log-param)."""
        xs = jnp.linspace(-1.0, 1.0, 25)
        ys = 1.2 * xs + 0.1

        @g.gen
        def model(xs):
            slope = g.normal(0.0, 2.0) @ "slope"
            sigma = g.half_normal(1.0) @ "sigma"
            _ = g.mv_normal_diag(
                slope * xs, sigma * jnp.ones_like(xs)
            ) @ "ys"

        target = Target(model, (xs,), g.C["ys"].set(ys))
        chms, _ = jax.jit(
            lambda k: run_nuts(
                target, k, n_chains=2, num_warmup=250, num_samples=300,
                max_depth=6, transforms={"sigma": "positive"},
            )
        )(KEY)
        sigmas = np.asarray(chms["sigma"])
        slopes = np.asarray(chms["slope"])
        assert np.all(sigmas > 0.0)
        assert abs(slopes.mean() - 1.2) < 0.1
        assert bool(np.isfinite(sigmas).all())

    def test_infer_transforms_from_support_metadata(self):
        """Support metadata on stdlib distributions drives automatic
        bijector selection, through nested @gen addresses."""
        from genjax_xla.inference.transforms import infer_transforms

        @g.gen
        def inner():
            _ = g.beta(2.0, 2.0) @ "p"
            _ = g.normal(0.0, 1.0) @ "loc"

        @g.gen
        def model():
            _ = g.gamma(2.0, 1.0) @ "rate"
            _ = g.uniform(-2.0, 3.0) @ "u"
            _ = g.poisson(4.0) @ "n"          # discrete: skipped
            _ = inner() @ "sub"

        tr = model.simulate(KEY, ())
        t = infer_transforms(tr)
        assert t["rate"] == "positive"
        assert t["u"] == (-2.0, 3.0)
        assert t[("sub", "p")] == (0.0, 1.0)
        assert "n" not in t and ("sub", "loc") not in t

        # exclusion hook (observed sites)
        t2 = infer_transforms(tr, exclude=lambda a: a == "rate")
        assert "rate" not in t2 and "u" in t2

    def test_nested_address_transform_roundtrip(self):
        from genjax_xla.inference.transforms import (
            constrain_choices,
            unconstrain_choices,
        )

        chm = g.C["sub", "p"].set(0.25) | g.C["x"].set(1.0)
        t = {("sub", "p"): (0.0, 1.0)}
        u = unconstrain_choices(chm, t)
        back, fldj = constrain_choices(u, t)
        assert abs(float(back["sub", "p"]) - 0.25) < 1e-6
        assert float(back["x"]) == 1.0
        assert bool(jnp.isfinite(fldj))

    def test_auto_transforms_end_to_end(self):
        """``transforms="auto"`` matches the manual positive-sigma run."""
        xs = jnp.linspace(-1.0, 1.0, 25)
        ys = 1.2 * xs + 0.1

        @g.gen
        def model(xs):
            slope = g.normal(0.0, 2.0) @ "slope"
            sigma = g.half_normal(1.0) @ "sigma"
            _ = g.mv_normal_diag(
                slope * xs, sigma * jnp.ones_like(xs)
            ) @ "ys"

        target = Target(model, (xs,), g.C["ys"].set(ys))
        chms, _ = jax.jit(
            lambda k: run_nuts(
                target, k, n_chains=2, num_warmup=250, num_samples=300,
                max_depth=6, transforms="auto",
            )
        )(KEY)
        sigmas = np.asarray(chms["sigma"])
        assert np.all(sigmas > 0.0)
        assert abs(np.asarray(chms["slope"]).mean() - 1.2) < 0.1

    def test_simplex_bijector_roundtrip_and_jacobian(self):
        from genjax_xla.inference.transforms import simplex

        u = jnp.array([0.3, -0.7, 1.1])
        x = simplex.forward(u)
        assert x.shape == (4,)
        assert abs(float(x.sum()) - 1.0) < 1e-6
        assert np.all(np.asarray(x) > 0)
        u_back = simplex.inverse(x)
        assert np.allclose(np.asarray(u_back), np.asarray(u), atol=1e-5)
        # fldj vs autodiff of the free (first K-1) coordinates
        J = jax.jacfwd(lambda u: simplex.forward(u)[:-1])(u)
        want = float(jnp.linalg.slogdet(J)[1])
        assert abs(float(simplex.fldj(u)) - want) < 1e-5
        # u = 0 maps to the uniform simplex (Stan offset convention)
        assert np.allclose(
            np.asarray(simplex.forward(jnp.zeros(3))), 0.25, atol=1e-6
        )

    def test_nuts_dirichlet_conjugate(self):
        """NUTS over a simplex latent via auto stick-breaking: the
        Dirichlet-categorical posterior mean is (alpha+counts)/sum."""
        alpha = jnp.array([1.0, 2.0, 3.0])
        counts = jnp.array([10.0, 5.0, 5.0])

        # Encode the categorical likelihood exactly with an exact_density
        # observation whose logpdf is the multinomial term.
        lik = g.exact_density(
            lambda key, p: p,
            lambda v, p: jnp.sum(counts * jnp.log(p)),
            "counts_lik",
        )

        @g.gen
        def model2():
            p = g.dirichlet(alpha) @ "p"
            _ = lik(p) @ "obs"

        target = Target(model2, (), g.C["obs"].set(jnp.zeros(3)))
        chms, _ = jax.jit(
            lambda k: run_nuts(
                target, k, n_chains=2, num_warmup=300, num_samples=400,
                max_depth=6, transforms="auto",
            )
        )(KEY)
        ps = np.asarray(chms["p"])          # (chains, samples, 3)
        assert np.allclose(ps.sum(axis=-1), 1.0, atol=1e-5)
        post = (np.asarray(alpha) + np.asarray(counts))
        post = post / post.sum()
        assert np.max(np.abs(ps.mean(axis=(0, 1)) - post)) < 0.03

    def test_auto_transforms_with_mesh_sharded_chains(self):
        """transforms="auto" composes with mesh-sharded chains (the
        chain axis rides the 8-device CPU mesh)."""
        from genjax_xla.parallel import particle_mesh

        xs = jnp.linspace(-1.0, 1.0, 15)
        ys = 0.8 * xs

        @g.gen
        def model(xs):
            slope = g.normal(0.0, 2.0) @ "slope"
            sigma = g.half_normal(1.0) @ "sigma"
            _ = g.mv_normal_diag(
                slope * xs, sigma * jnp.ones_like(xs)
            ) @ "ys"

        mesh = particle_mesh(axis_name="chains")
        target = Target(model, (xs,), g.C["ys"].set(ys))
        chms, _ = jax.jit(
            lambda k: run_nuts(
                target, k, n_chains=8, num_warmup=150, num_samples=100,
                max_depth=5, mesh=mesh, transforms="auto",
            )
        )(KEY)
        sigmas = np.asarray(chms["sigma"])
        assert sigmas.shape == (8, 100)
        assert np.all(sigmas > 0.0)
        assert abs(np.asarray(chms["slope"]).mean() - 0.8) < 0.15

    def test_dimap_site_transforms(self):
        """Dimap wrappers are transparent to support inference."""
        from genjax_xla.inference.transforms import infer_transforms

        @g.gen
        def inner(rate2):
            _ = g.gamma(2.0, rate2 / 2.0) @ "lam"

        wrapped = inner.contramap(lambda r: (2.0 * r,))

        @g.gen
        def model():
            _ = wrapped(1.0) @ "sub"

        tr = model.simulate(KEY, ())
        assert infer_transforms(tr) == {("sub", "lam"): "positive"}

    def test_scan_site_transforms(self):
        """Transforms reach sites inside Scan (Indexed layers are
        transparent): per-step positive latents stay positive and the
        fldj covers every step."""
        from genjax_xla.inference.transforms import (
            constrain_choices,
            infer_transforms,
            positive,
            unconstrain_choices,
        )

        T = 5

        @g.gen
        def step(carry, _):
            s = g.half_normal(1.0) @ "s"
            y = g.normal(carry, s) @ "y"
            return carry, None

        @g.gen
        def model():
            _ = step.scan(n=T)(0.0, None) @ "chain"

        tr = model.simulate(KEY, ())
        t = infer_transforms(tr)
        assert t == {("chain", "s"): "positive"}

        latents = tr.get_choices().filter(~g.S.at["chain", "y"])
        u = unconstrain_choices(latents, t)
        back, fldj = constrain_choices(u, t)
        s_back = np.asarray(back["chain", 2, "s"])
        s_orig = np.asarray(latents["chain", 2, "s"])
        assert np.allclose(s_back, s_orig, atol=1e-5)
        # fldj sums per-step contributions
        u_all = np.asarray([float(u["chain", i, "s"]) for i in range(T)])
        want = sum(float(positive.fldj(jnp.asarray(ui))) for ui in u_all)
        assert abs(float(fldj) - want) < 1e-4

    def test_nuts_auto_transforms_scan_model(self):
        """End-to-end NUTS with auto transforms on a model whose
        positive-scale latent sits inside a Scan."""
        T = 4
        obs = jnp.array([1.0, 1.2, 0.8, 1.1])

        @g.gen
        def step(carry, _):
            s = g.half_normal(1.0) @ "s"
            y = g.normal(0.0, s + 0.1) @ "y"
            return carry, None

        @g.gen
        def model():
            _ = step.scan(n=T)(0.0, None) @ "chain"

        obs_chm = g.ChoiceMap.empty()
        for t_i in range(T):
            obs_chm = obs_chm | g.C["chain", t_i, "y"].set(obs[t_i])

        target = Target(model, (), obs_chm)
        chms, _ = jax.jit(
            lambda k: run_nuts(
                target, k, n_chains=2, num_warmup=200, num_samples=200,
                max_depth=6, transforms="auto",
            )
        )(KEY)
        # Every step readable (catches lane/batch axis aliasing): shape
        # must be (chains, samples) for each of the T step indices.
        for t_i in range(T):
            ss = np.asarray(chms["chain", t_i, "s"])
            assert ss.shape == (2, 200), ss.shape
            assert np.all(ss > 0.0)
            assert bool(np.isfinite(ss).all())

    def test_interval_transform_roundtrip(self):
        from genjax_xla.inference.transforms import (
            constrain_choices,
            interval,
            unconstrain_choices,
        )

        chm = g.C["p"].set(0.3) | g.C["other"].set(5.0)
        t = {"p": (0.0, 1.0)}
        u = unconstrain_choices(chm, t)
        back, fldj = constrain_choices(u, t)
        assert abs(float(back["p"]) - 0.3) < 1e-6
        assert float(back["other"]) == 5.0
        # fldj finite and matches the analytic sigmoid jacobian:
        bij = interval(0.0, 1.0)
        uu = bij.inverse(jnp.asarray(0.3))
        assert abs(float(fldj) - float(bij.fldj(uu))) < 1e-6


class TestNUTSReviewRegressions:
    """Late round-2 self-review fixes."""

    def test_nonfinite_initial_energy_flagged(self):
        """A zero-density start must report accept 0 + diverging (the
        old behavior froze the chain while reporting accept 1.0)."""
        bad = lambda z: jnp.where(
            jnp.any(jnp.abs(z) < 1e9), -jnp.inf, 0.0
        )
        z, info = nuts_kernel(bad, jnp.zeros(3), jax.random.key(0), 0.1)
        assert float(info.accept_prob) == 0.0
        assert bool(info.diverging)
        assert jnp.all(z == 0.0)

    def test_discrete_latent_rejected(self):
        import pytest

        @g.gen
        def disc():
            z = g.bernoulli(logits=0.0) @ "z"
            return g.normal(jnp.where(z, 1.0, -1.0), 1.0) @ "x"

        tgt = Target(disc, (), g.C["x"].set(0.5))
        with pytest.raises(TypeError, match="non-float latent"):
            run_nuts(tgt, jax.random.key(0), n_chains=2,
                     num_warmup=5, num_samples=5)

    def test_zero_warmup_returns_eps0(self):
        from genjax_xla.inference.adaptation import warmup_chains

        logd = lambda z: -0.5 * jnp.sum(z ** 2)
        _, eps, _ = warmup_chains(
            logd, jnp.zeros((2, 3)), jax.random.key(0),
            num_warmup=0, eps0=0.1,
        )
        assert abs(float(eps) - 0.1) < 1e-6


def test_chain_burnin_bitwise_vs_slice():
    """Two-scan burn-in (no stacked outputs during burn-in) is bitwise
    the single-scan collection's tail."""
    from genjax_xla.inference import chain, mh
    from genjax_xla.gfi.requests import Regenerate
    from genjax_xla.gfi.selection import Selection

    @g.gen
    def m():
        return g.normal(0.0, 1.0) @ "x"

    tr = m.simulate(jax.random.key(0), ())
    kern = lambda k, t: mh(k, t, Regenerate(Selection.all()))
    run = chain(kern)
    _, burned = run(jax.random.key(1), tr, n_steps=50, burn_in=20,
                    collect=lambda t: t.get_choices()["x"])
    _, full = run(jax.random.key(1), tr, n_steps=50, burn_in=0,
                  collect=lambda t: t.get_choices()["x"])
    np.testing.assert_array_equal(
        np.asarray(burned), np.asarray(full)[20:]
    )


class TestExplicitIndexConstraints:
    """VERDICT r2 item 7: vmapped models with C[jnp.array([...])]-style
    explicit dynamic-index constraints round-trip through Vmap traces
    and NUTS transforms (reference dynamic-index semantics:
    /root/reference/.../choice_map.py:1453-1531)."""

    def test_partial_lane_constraint_roundtrip(self):
        import numpy as np

        @g.gen
        def model():
            mu = g.normal(0.0, 1.0) @ "mu"
            xs = g.gamma.vmap(in_axes=(0, None))(
                jnp.full(4, 2.0), 2.0
            ) @ "xs"
            _ = g.mv_normal_diag(mu + xs, jnp.ones(4)) @ "y"

        constraint = (
            g.C["y"].set(jnp.ones(4))
            | g.C["xs", jnp.array([1, 3])].set(jnp.array([0.7, 0.9]))
        )
        target = Target(model, (), constraint)
        chms, _ = jax.jit(
            lambda k: run_nuts(
                target, k, n_chains=4, num_warmup=30, num_samples=30,
                max_depth=4, transforms="auto",
            )
        )(jax.random.key(0))
        # Latent lanes: per-lane and vector dynamic-index queries work,
        # values in the gamma support (transform round-trip).
        v = chms["xs", jnp.array([0, 2])]
        val = np.asarray(v.value if hasattr(v, "value") else v)
        assert val.shape == (2, 4, 30)
        assert (val > 0).all()
        lane0 = chms["xs", 0]
        assert bool(np.all(np.asarray(lane0.flag)))
        # Constrained lanes are not latent: masked out.
        lane1 = chms["xs", 1]
        assert not bool(np.any(np.asarray(lane1.flag)))
        assert np.isfinite(np.asarray(chms["mu"])).all()


class TestFixedBudgetKernel:
    """The fixed-budget (single unrolled scan) strategy shares the
    subtree-step and doubling-merge math with the while-loop strategy and
    consumes keys only on active slots — so transitions are bitwise equal
    whenever XLA cannot re-associate the density's float reductions
    (guaranteed here: D=2, every reduction has <= 2 elements, the
    quadratic form is an explicitly associated scalar chain). For general
    densities the two strategies may differ at the ulp level (different
    loop structures fuse reductions differently — the same effect
    ``adaptation._cross_chain_stats`` guards against), which NUTS
    amplifies; equivalence there is distributional, tested at the
    ``run_nuts`` level on posterior moments. ``nuts.py:_run_fixed``."""

    def _logp(self, z):
        # Explicit scalar chain — no >2-element reductions anywhere
        # (the kernel's own dots/sums are over D=2, association-unique).
        a = z[0]
        b = z[1]
        return -(a * a) + -(0.75 * b * b) + 0.3 * a * b

    def test_transition_bitwise_vs_dynamic(self):
        for seed in range(4):
            # eps sweep covers shallow trees, deep trees, and divergences.
            for eps in (0.1, 0.5, 2.5):
                key = jax.random.fold_in(KEY, seed)
                z0 = jax.random.normal(jax.random.fold_in(key, 1), (2,))
                zd, infod = jax.jit(
                    lambda z, k, e=eps: nuts_kernel(
                        self._logp, z, k, e, max_depth=5
                    )
                )(z0, key)
                zf, infof = jax.jit(
                    lambda z, k, e=eps: nuts_kernel(
                        self._logp, z, k, e, max_depth=5,
                        fixed_budget=True, unroll=4,
                    )
                )(z0, key)
                assert np.array_equal(np.asarray(zd), np.asarray(zf))
                for a, b in zip(infod, infof):
                    assert np.array_equal(np.asarray(a), np.asarray(b))

    def test_vmapped_transition_bitwise(self):
        zs = jax.random.normal(jax.random.fold_in(KEY, 7), (16, 2))
        keys = jax.vmap(jax.random.fold_in, (None, 0))(
            KEY, jnp.arange(16)
        )
        zd, infod = jax.jit(jax.vmap(
            lambda z, k: nuts_kernel(self._logp, z, k, 0.4, max_depth=6)
        ))(zs, keys)
        zf, infof = jax.jit(jax.vmap(
            lambda z, k: nuts_kernel(
                self._logp, z, k, 0.4, max_depth=6, fixed_budget=True
            )
        ))(zs, keys)
        assert np.array_equal(np.asarray(zd), np.asarray(zf))
        assert np.array_equal(
            np.asarray(infod.num_steps), np.asarray(infof.num_steps)
        )

    def test_run_nuts_posterior_agreement_vs_dynamic(self):
        # Whole pipeline (init, warmup dual-averaging + mass adaptation,
        # sampling). On a general model the density's reductions can be
        # fused differently under the two loop structures (ulp-level
        # association differences NUTS then amplifies), so equivalence is
        # distributional: both strategies must recover the same posterior
        # moments.
        xs = jnp.linspace(-1.0, 1.0, 12)
        ys = 1.5 * xs + 0.3

        @g.gen
        def reg(xs):
            slope = g.normal(0.0, 2.0) @ "slope"
            icept = g.normal(0.0, 2.0) @ "icept"
            _ = g.mv_normal_diag(
                slope * xs + icept, 0.3 * jnp.ones_like(xs)
            ) @ "ys"

        target = Target(reg, (xs,), g.C["ys"].set(ys))

        def run(fixed):
            return run_nuts(
                target, KEY, n_chains=8, num_warmup=100, num_samples=200,
                max_depth=4, fixed_budget=fixed,
            )

        chms_d, infos_d = jax.jit(lambda: run(False))()
        chms_f, infos_f = jax.jit(lambda: run(True))()
        for addr in ("slope", "icept"):
            sd = np.asarray(chms_d[addr])
            sf = np.asarray(chms_f[addr])
            assert abs(sd.mean() - sf.mean()) < 0.05
            assert abs(sd.std() - sf.std()) < 0.05
        # Identical tree-size distribution in aggregate (same algorithm).
        assert abs(
            float(np.mean(np.asarray(infos_d.num_steps)))
            - float(np.mean(np.asarray(infos_f.num_steps)))
        ) < 1.5
