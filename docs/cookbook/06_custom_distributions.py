"""Cookbook 6 — Custom distributions.

Any (sampler, log-density) pair becomes a first-class distribution with
`exact_density`: usable at `@ "addr"` sites, scored exactly in assess/
importance/edit, and (with a `support` spec) automatically transformed
for gradient-based inference. Parity with the reference cookbook's
`custom_distribution.ipynb` (reference
`docs/cookbook/inactive/expressivity/`); implementation
`lang/distributions/distribution.py` (reference `distribution.py:436`).
"""

import jax
import jax.numpy as jnp

import genjax_xla as g

key = jax.random.key(0)

# -- a Kumaraswamy(a, b) distribution, absent from the stdlib ------------
# sampler: inverse-CDF of U(0,1); logpdf: closed form. Both are plain
# JAX code — jit/vmap/grad all work.


def _kuma_sample(key, a, b):
    u = jax.random.uniform(key, ())
    return (1.0 - (1.0 - u) ** (1.0 / b)) ** (1.0 / a)


def _kuma_logpdf(x, a, b):
    return (
        jnp.log(a) + jnp.log(b)
        + (a - 1.0) * jnp.log(x)
        + (b - 1.0) * jnp.log1p(-(x ** a))
    )


# `support="unit_interval"` tells gradient samplers (NUTS with
# transforms="auto") to run in logit space automatically.
kumaraswamy = g.exact_density(
    _kuma_sample, _kuma_logpdf, name="kumaraswamy",
    support="unit_interval",
)

# Sanity: density integrates to 1 (trapezoid on a grid).
xs = jnp.linspace(1e-4, 1 - 1e-4, 4001)
dens = jnp.exp(jax.vmap(lambda x: _kuma_logpdf(x, 2.0, 3.0))(xs))
mass = jnp.trapezoid(dens, xs)
assert abs(float(mass) - 1.0) < 1e-3
print("∫ pdf =", float(mass))

# -- use it in a model like any stdlib distribution ----------------------
@g.gen
def coin_model():
    p = kumaraswamy(2.0, 3.0) @ "p"     # prior on the coin's bias
    heads = g.binomial(20.0, p) @ "heads"
    return heads


tr = coin_model.simulate(key, ())
print("prior draw p =", float(tr.get_choices()["p"]))

# Posterior over p given 17 heads out of 20, by importance sampling:
obs = g.C["heads"].set(17.0)
keys = jax.random.split(key, 4096)
trs, ws = jax.jit(jax.vmap(lambda k: coin_model.generate(k, obs, ())))(keys)
w = jnp.exp(ws - jax.scipy.special.logsumexp(ws))
post_mean = jnp.sum(w * trs.get_choices()["p"])
print("E[p | 17/20 heads] ≈", float(post_mean))
assert 0.6 < float(post_mean) < 0.95

# -- stochastic densities ------------------------------------------------
# When the density itself is intractable but unbiasedly *estimable*
# (marginals of bigger models), use `.marginal()` — see cookbook 08.
# exact_density is the right tool whenever you can write log p(x) down.
print("ok")
