"""Placement of the persistent compile cache: the directory named by
``JAX_COMPILATION_CACHE_DIR`` when it is set, a fixed directory inside
the checkout otherwise."""

import pathlib

import jax
import pytest

from genjax_xla.utils import profiling
from genjax_xla.utils.profiling import compile_cache_dir, enable_compile_cache

REPO = pathlib.Path(__file__).resolve().parents[2]


@pytest.fixture
def restore_cache_config():
    old = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", old)


def test_env_var_names_the_directory(tmp_path):
    env = {"JAX_COMPILATION_CACHE_DIR": str(tmp_path)}
    assert compile_cache_dir(env) == str(tmp_path)


def test_unset_env_uses_fixed_path_in_checkout():
    path = pathlib.Path(compile_cache_dir({}))
    assert path == REPO / ".jax_cache"
    assert path == profiling.DEFAULT_CACHE_DIR
    # Fixed: no process id or time in it, so every run finds it again.
    assert compile_cache_dir({}) == compile_cache_dir({})


def test_enable_with_env_set_touches_no_config(tmp_path,
                                               restore_cache_config):
    jax.config.update("jax_compilation_cache_dir", None)
    env = {"JAX_COMPILATION_CACHE_DIR": str(tmp_path)}
    assert enable_compile_cache(env) == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir is None


def test_enable_with_env_unset_sets_checkout_path(restore_cache_config):
    assert enable_compile_cache({}) == str(REPO / ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == str(REPO / ".jax_cache")
