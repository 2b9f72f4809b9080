"""Sharded-SMC tests on the virtual 8-device CPU mesh (SURVEY §4: the
distributed strategy the reference never needed)."""

import jax
import jax.numpy as jnp
import numpy as np

import genjax_xla as g
from genjax_xla.inference import Target
from genjax_xla.parallel import (
    Mesh,
    particle_mesh,
    sharded_importance,
    sharded_resample,
    sharded_smc_step,
)

KEY = jax.random.key(314159)


@g.gen
def beta_bernoulli(a, b):
    p = g.beta(a, b) @ "p"
    v = g.flip(p) @ "v"
    return v


def make_target():
    return Target(beta_bernoulli, (2.0, 2.0), g.C["v"].set(True))


def test_eight_devices_available():
    assert len(jax.devices()) == 8


def test_sharded_importance_matches_exact_logz():
    mesh = particle_mesh()
    run = jax.jit(sharded_importance(make_target(), 4096, mesh))
    col = run(KEY)
    logz = col.get_log_marginal_likelihood_estimate()
    assert jnp.abs(logz - jnp.log(0.5)) < 2e-2


def test_sharded_layout():
    mesh = particle_mesh()
    run = jax.jit(sharded_importance(make_target(), 1024, mesh))
    col = run(KEY)
    # weights actually sharded over all 8 devices
    assert len(col.get_log_weights().sharding.device_set) == 8


def test_sharded_matches_single_device():
    """Bitwise-deterministic particle weights regardless of mesh layout
    (fold_in-derived keys are layout-independent)."""
    mesh8 = particle_mesh()
    mesh1 = Mesh(np.asarray(jax.devices()[:1]), ("particles",))
    w8 = jax.jit(sharded_importance(make_target(), 256, mesh8))(
        KEY
    ).get_log_weights()
    w1 = jax.jit(sharded_importance(make_target(), 256, mesh1))(
        KEY
    ).get_log_weights()
    np.testing.assert_array_equal(np.asarray(w8), np.asarray(w1))


def test_sharded_resample_preserves_logz_and_equalizes():
    mesh = particle_mesh()
    col = jax.jit(sharded_importance(make_target(), 512, mesh))(KEY)

    @jax.jit
    def res(col, key):
        return sharded_resample(col, key, mesh)

    out = res(col, jax.random.key(7))
    assert jnp.allclose(
        out.get_log_marginal_likelihood_estimate(),
        col.get_log_marginal_likelihood_estimate(),
        atol=1e-5,
    )
    assert jnp.allclose(out.effective_sample_size(), 512.0)


def test_sharded_smc_step_2d_mesh():
    devs = np.asarray(jax.devices()).reshape(2, 4)
    mesh = Mesh(devs, ("hosts", "chips"))
    step = sharded_smc_step(
        make_target(), 64, mesh, axis_name=("hosts", "chips")
    )
    col, logz = jax.jit(step)(KEY)
    assert col.num_particles() == 64
    assert bool(jnp.isfinite(logz))


def test_sharded_particle_filter():
    from genjax_xla.parallel import sharded_particle_filter

    mesh = particle_mesh()

    def init(key):
        return jax.random.normal(key), jnp.zeros(())

    def step(key, x, y):
        x_new = 0.9 * x + 0.3 * jax.random.normal(key)
        return x_new, jax.scipy.stats.norm.logpdf(y, x_new, 0.5)

    ys = jnp.asarray([0.1, -0.2, 0.3, 0.0])
    pf = sharded_particle_filter(init, step, 4096, mesh)
    final, _ = jax.jit(lambda k: pf(k, ys))(KEY)
    assert bool(jnp.isfinite(final.log_z))
    assert len(final.log_weights.sharding.device_set) == 8
    # Layout independence: same logZ on a 1-device mesh.
    mesh1 = Mesh(np.asarray(jax.devices()[:1]), ("particles",))
    pf1 = sharded_particle_filter(init, step, 4096, mesh1)
    final1, _ = jax.jit(lambda k: pf1(k, ys))(KEY)
    assert float(final.log_z) == float(final1.log_z)


def test_batched_particle_filter_matches_perkey_structure():
    from genjax_xla.inference.pf import particle_filter

    n = 2048

    def b_init(key):
        return jax.random.normal(key, (n,)), jnp.zeros((n,))

    def b_step(key, xs, y):
        xs_new = 0.9 * xs + 0.3 * jax.random.normal(key, (n,))
        return xs_new, jax.scipy.stats.norm.logpdf(y, xs_new, 0.5)

    ys = jnp.asarray([0.1, -0.2, 0.3])
    pf = particle_filter(b_init, b_step, n, batched=True)
    final, _ = jax.jit(lambda k: pf(k, ys))(KEY)
    assert final.particles.shape == (n,)
    assert bool(jnp.isfinite(final.log_z))


def test_sharded_nuts_chains():
    from genjax_xla.inference import Target, run_nuts
    from genjax_xla.parallel import Mesh

    mesh = Mesh(np.asarray(jax.devices()), ("chains",))

    @g.gen
    def model():
        mu = g.normal(0.0, 1.0) @ "mu"
        _ = g.normal(mu, 0.5) @ "y"

    target = Target(model, (), g.C["y"].set(1.0))
    chms, infos = jax.jit(
        lambda k: run_nuts(target, k, n_chains=8, num_warmup=100,
                           num_samples=100, max_depth=5, mesh=mesh)
    )(KEY)
    mus = chms["mu"]
    assert mus.shape == (8, 100)
    assert len(mus.sharding.device_set) == 8
    assert abs(float(mus.mean()) - 0.8) < 0.1


def test_host_device_mesh():
    from genjax_xla.parallel import host_device_mesh

    mesh = host_device_mesh()
    assert mesh.devices.size == 8
    assert mesh.axis_names == ("hosts", "chips")
