"""Mesh-sharded SVGD (parallel/svgd.py): bitwise layout independence
across mesh sizes, posterior recovery, agreement with the single-path
math, and HLO bounds on what moves over the mesh (O(N·D) positions and
gradients — never the (n_loc, N) kernel blocks)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

from genjax_xla.parallel.svgd import run_sharded_svgd, sharded_svgd_step

N, D = 512, 4


def _mesh_of(d, name="particles"):
    return Mesh(np.asarray(jax.devices()[:d]), (name,))


def _logp(z):
    # Anisotropic Gaussian; reductions over D only.
    scales = jnp.array([1.0, 2.0, 0.5, 1.5])
    return -0.5 * jnp.sum((z / scales) ** 2)


@pytest.fixture(scope="module")
def xs0():
    return jax.random.normal(jax.random.key(11), (N, D))


class TestShardedStep:
    def test_bitwise_all_layouts(self, xs0):
        outs = []
        for d in (1, 2, 4, 8):
            out = jax.jit(
                lambda x, m=_mesh_of(d): sharded_svgd_step(
                    _logp, x, 0.1, m
                )
            )(xs0)
            outs.append(np.asarray(out))
        for o in outs[1:]:
            np.testing.assert_array_equal(o, outs[0])

    def test_moves_toward_posterior(self, xs0):
        out = jax.jit(
            lambda x: sharded_svgd_step(_logp, x, 0.1, _mesh_of(8))
        )(xs0 + 5.0)
        # One step from a displaced cloud must move toward the mode.
        assert float(jnp.mean(out)) < float(jnp.mean(xs0 + 5.0))

    def test_hlo_gathers_positions_not_kernel_blocks(self, xs0):
        txt = (
            jax.jit(
                lambda x: sharded_svgd_step(_logp, x, 0.1, _mesh_of(8))
            )
            .lower(xs0)
            .compile()
            .as_text()
        )
        assert "all-gather" in txt
        for line in txt.splitlines():
            if "all-gather" in line or "all-reduce" in line:
                # Gathered tensors are (N, D); the (n_loc, N) = (64, 512)
                # kernel block (or anything N x N) must stay local.
                flat = line.replace(" ", "")
                assert f"f32[{N},{N}]" not in flat, line
                assert f"f32[{N // 8},{N}]" not in flat, line


class TestRunShardedSVGD:
    def test_gaussian_moment_recovery(self, xs0):
        out = jax.jit(
            lambda x: run_sharded_svgd(
                _logp, x, n_steps=400, step_size=0.1, mesh=_mesh_of(8)
            )
        )(xs0)
        out = np.asarray(out)
        scales = np.array([1.0, 2.0, 0.5, 1.5])
        np.testing.assert_allclose(
            out.mean(axis=0), np.zeros(D), atol=0.15
        )
        np.testing.assert_allclose(out.std(axis=0), scales, atol=0.3)

    def test_bitwise_all_layouts(self, xs0):
        outs = []
        for d in (1, 4, 8):
            out = jax.jit(
                lambda x, m=_mesh_of(d): run_sharded_svgd(
                    _logp, x, n_steps=50, step_size=0.1, mesh=m
                )
            )(xs0)
            outs.append(np.asarray(out))
        for o in outs[1:]:
            np.testing.assert_array_equal(o, outs[0])

    def test_matches_unsharded_statistics(self, xs0):
        """The sharded fit (subsampled bandwidth) and inference.run_svgd's
        math (full median) agree on the fitted moments."""
        from genjax_xla.inference.svgd import _rbf_phi

        def body(carry, _):
            xs, acc = carry
            grads = jax.vmap(jax.grad(_logp))(xs)
            phi = _rbf_phi(xs, grads)
            acc = 0.9 * acc + 0.1 * phi * phi
            return (xs + 0.1 * phi / (1e-6 + jnp.sqrt(acc)), acc), None

        (plain, _), _ = jax.lax.scan(
            body, (xs0, jnp.zeros_like(xs0)), None, length=300
        )
        sharded = jax.jit(
            lambda x: run_sharded_svgd(
                _logp, x, n_steps=300, step_size=0.1, mesh=_mesh_of(8)
            )
        )(xs0)
        np.testing.assert_allclose(
            np.asarray(sharded).mean(axis=0),
            np.asarray(plain).mean(axis=0), atol=0.1,
        )
        np.testing.assert_allclose(
            np.asarray(sharded).std(axis=0),
            np.asarray(plain).std(axis=0), atol=0.2,
        )
