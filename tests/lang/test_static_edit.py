"""Fine-grained incremental edits (lang/static_edit.py): correctness vs
the coarse handler path (bitwise), and the asymptotic re-scoring win the
reference gets from its Diff interpreter (VERDICT round-1 item 6)."""

import jax
import jax.numpy as jnp
import pytest

import genjax_xla as g
from genjax_xla.gfi.choice_map import ChoiceMap
from genjax_xla.gfi.requests import Regenerate, Update
from genjax_xla.lang import static as static_mod


S = 20


@g.gen
def chain():
    x = g.normal(0.0, 1.0) @ "x0"
    for i in range(1, S):
        x = g.normal(x, 1.0) @ f"x{i}"
    return x


@g.gen
def hierarchical():
    mu = g.normal(0.0, 1.0) @ "mu"
    a = g.normal(mu, 1.0) @ "a"
    b = g.normal(mu, 1.0) @ "b"
    c = g.normal(0.0, 1.0) @ "c"  # independent of everything
    return a + b + c


def _both_paths(fn, *args):
    static_mod.FINE_GRAINED_EDITS = True
    try:
        fine = fn(*args)
    finally:
        static_mod.FINE_GRAINED_EDITS = True
    static_mod.FINE_GRAINED_EDITS = False
    try:
        coarse = fn(*args)
    finally:
        static_mod.FINE_GRAINED_EDITS = True
    return fine, coarse


class TestEquivalence:
    def test_regenerate_bitwise_equal(self):
        key = jax.random.key(0)
        tr = chain.simulate(key, ())

        def do(k):
            new_tr, w, _rd, _bwd = tr.edit(k, Regenerate(g.S.at["x5"]))
            return new_tr.get_choices()["x7"], w, new_tr.get_score()

        fine, coarse = _both_paths(do, jax.random.key(1))
        for a, b in zip(fine, coarse):
            assert jnp.array_equal(a, b), (a, b)

    def test_update_weight_and_discard_equal(self):
        key = jax.random.key(0)
        tr = chain.simulate(key, ())
        c = ChoiceMap.kw(x3=1.25)

        def do(k):
            new_tr, w, _rd, bwd = tr.edit(k, Update(c))
            return (new_tr.get_score(), w,
                    bwd.constraint["x3"], new_tr.get_choices()["x3"])

        fine, coarse = _both_paths(do, jax.random.key(1))
        for a, b in zip(fine, coarse):
            assert jnp.array_equal(a, b)

    def test_update_weight_identity(self):
        # w = new_score - old_score when only constrained sites move and
        # args are unchanged (SMCP3 Update identity).
        key = jax.random.key(0)
        tr = hierarchical.simulate(key, ())
        new_tr, w, _rd, _ = tr.edit(jax.random.key(1),
                                    Update(ChoiceMap.kw(mu=0.7)))
        assert jnp.allclose(w, new_tr.get_score() - tr.get_score(),
                            atol=1e-5)

    def test_concrete_control_flow_falls_back(self):
        @g.gen
        def branchy(flag):
            if flag > 0:  # concrete Python branch: staging impossible
                x = g.normal(0.0, 1.0) @ "x"
            else:
                x = g.normal(5.0, 1.0) @ "x"
            return x

        tr = branchy.simulate(jax.random.key(0), (1,))
        new_tr, w, _rd, _ = tr.edit(jax.random.key(1),
                                    Update(ChoiceMap.kw(x=0.3)))
        assert jnp.allclose(new_tr.get_choices()["x"], 0.3)
        assert jnp.allclose(w, new_tr.get_score() - tr.get_score(),
                            atol=1e-5)


def _count_eqns(jaxpr):
    n = len(jaxpr.eqns)
    for eqn in jaxpr.eqns:
        for v in eqn.params.values():
            if hasattr(v, "jaxpr"):
                n += _count_eqns(v.jaxpr)
    return n


def _count_logpdf_ops(make_fn):
    """Count normal-logpdf evaluations (square ops) in the traced edit.
    ``make_fn`` is a thunk returning a FRESH closure — jax.make_jaxpr
    shares jit's tracing cache keyed on function identity, so re-tracing
    the same function object after a mode flip returns the stale jaxpr."""
    jaxpr = jax.make_jaxpr(make_fn())(jax.random.key(1))
    return sum(
        1 for e in jaxpr.jaxpr.eqns if e.primitive.name == "square"
    )


class TestAsymptotics:
    def test_midchain_regenerate_rescores_o1_sites(self):
        tr = chain.simulate(jax.random.key(0), ())

        def make_edit_mid():
            def edit_mid(k):
                new_tr, w, _rd, _ = tr.edit(k, Regenerate(g.S.at["x10"]))
                return new_tr.get_score(), w

            return edit_mid

        static_mod.FINE_GRAINED_EDITS = True
        fine_ops = _count_logpdf_ops(make_edit_mid)
        static_mod.FINE_GRAINED_EDITS = False
        try:
            coarse_ops = _count_logpdf_ops(make_edit_mid)
        finally:
            static_mod.FINE_GRAINED_EDITS = True
        # Coarse re-scores every downstream site (x10..x19, 2 squares per
        # normal logpdf); fine re-scores only the regenerated site and its
        # single dependent.
        assert coarse_ops >= 16, coarse_ops
        assert fine_ops <= 5, fine_ops

    def test_independent_site_update_rescores_one(self):
        tr = hierarchical.simulate(jax.random.key(0), ())

        def make():
            def edit_c(k):
                new_tr, w, _rd, _ = tr.edit(k, Update(ChoiceMap.kw(c=0.1)))
                return new_tr.get_score(), w

            return edit_c

        fine_ops = _count_logpdf_ops(make)
        assert fine_ops <= 3, fine_ops

    def test_root_update_rescores_dependents_not_independents(self):
        tr = hierarchical.simulate(jax.random.key(0), ())

        def make():
            def edit_mu(k):
                new_tr, w, _rd, _ = tr.edit(k, Update(ChoiceMap.kw(mu=0.2)))
                return new_tr.get_score(), w

            return edit_mu

        fine_ops = _count_logpdf_ops(make)
        # mu + a + b re-scored (2 squares each); c untouched.
        assert fine_ops <= 7, fine_ops


class TestMHSweepPosterior:
    def test_mh_sweep_chain_posterior(self):
        """A full MH sweep via fine-grained Regenerate edits preserves the
        chain posterior (smoke: mean of x0 given observed tail)."""
        @g.gen
        def cmodel():
            x0 = g.normal(0.0, 1.0) @ "x0"
            x1 = g.normal(x0, 0.5) @ "x1"
            _y = g.normal(x1, 0.5) @ "y"

        target_chm = ChoiceMap.kw(y=1.0)
        tr, _ = cmodel.generate(jax.random.key(0), target_chm, ())

        def sweep(tr, key):
            for i, addr in enumerate(["x0", "x1"]):
                k1, k2, key = jax.random.split(jax.random.fold_in(key, i), 3)
                new_tr, w, _rd, _ = tr.edit(k1, Regenerate(g.S.at[addr]))
                accept = jnp.log(jax.random.uniform(k2, ())) < w
                tr = jax.tree_util.tree_map(
                    lambda a, b: jnp.where(accept, a, b), new_tr, tr
                )
            return tr

        @jax.jit
        def run(key):
            def body(tr, k):
                tr = sweep(tr, k)
                return tr, tr.get_choices()["x0"]

            _, xs = jax.lax.scan(body, tr, jax.random.split(key, 3000))
            return xs

        xs = run(jax.random.key(7))
        # Posterior of x0 | y=1: linear-Gaussian; precision algebra:
        # x0 ~ N(0,1), x1|x0 ~ N(x0,.25), y|x1 ~ N(x1,.25)
        # => cov(x0,y)=1, var(y)=1.5 => E[x0|y=1] = 1/1.5
        assert abs(float(jnp.mean(xs[1000:])) - 1.0 / 1.5) < 0.08


class TestEditReviewRegressions:
    """Late round-2 self-review fixes for the edit machinery."""

    def test_constant_retval_editable(self):
        from genjax_xla.core.compiler.interpreters.incremental import Diff
        from genjax_xla.gfi.requests import Regenerate
        from genjax_xla.gfi.selection import Selection

        @g.gen
        def f(mu):
            x = g.normal(mu, 1.0) @ "x"
            return (x, 3.0)

        tr = f.simulate(jax.random.key(0), (0.5,))
        new_tr, w, _, _ = tr.edit(
            jax.random.key(1), Regenerate(Selection.at["x"]),
            Diff.no_change((0.5,)),
        )
        assert jnp.isfinite(new_tr.get_score())
        assert new_tr.get_retval()[1] == 3.0

    def test_string_arg_body_falls_back_to_coarse(self):
        from genjax_xla.core.compiler.interpreters.incremental import Diff
        from genjax_xla.gfi.requests import Regenerate
        from genjax_xla.gfi.selection import Selection

        @g.gen
        def m(mode, mu):
            if mode == "wide":
                return g.normal(mu, 10.0) @ "x"
            return g.normal(mu, 0.1) @ "x"

        tr = m.simulate(jax.random.key(0), ("wide", 0.5))
        new_tr, _, _, _ = tr.edit(
            jax.random.key(1), Regenerate(Selection.all()),
            Diff.no_change(("wide", 0.5)),
        )
        assert jnp.isfinite(new_tr.get_score())
