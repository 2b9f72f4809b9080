"""API-reference generator: walks the public ``genjax_xla`` namespaces
and emits a Markdown reference per module into ``docs/api/`` plus a
self-contained rendered HTML site at ``docs/site/api.html``.

The reference ships an mkdocs site with mkdocstrings-generated API pages
(``/root/reference/mkdocs.yml:54-59``); this is the dependency-free
analogue (no mkdocs in the image): run ``python docs/gen_api.py`` after
API changes; output is committed so the rendered reference ships with
the repo. ``tests/docs/test_gen_api.py`` regenerates and checks key
symbols are present.
"""

from __future__ import annotations

import html
import importlib
import inspect
import os
import re
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

MODULES = [
    ("genjax_xla", "Top-level facade: @gen, distributions, C/S builders"),
    ("genjax_xla.core.pytree", "Pytree substrate"),
    ("genjax_xla.core.compiler.staging", "Staging / jaxpr utilities"),
    ("genjax_xla.gfi.gfn", "Generative-function interface (GFI)"),
    ("genjax_xla.gfi.choice_map", "ChoiceMap algebra"),
    ("genjax_xla.gfi.selection", "Selection algebra"),
    ("genjax_xla.gfi.mask", "Mask (existence uncertainty)"),
    ("genjax_xla.gfi.requests", "Edit requests"),
    ("genjax_xla.lang.static", "@gen static DSL"),
    ("genjax_xla.lang.distributions.stdlib", "Distribution library"),
    ("genjax_xla.lang.combinators.vmap", "Vmap combinator"),
    ("genjax_xla.lang.combinators.scan", "Scan combinator"),
    ("genjax_xla.lang.combinators.switch", "Switch combinator"),
    ("genjax_xla.inference.sp", "Targets / stochastic probability"),
    ("genjax_xla.inference.smc", "SMC / resampling"),
    ("genjax_xla.inference.pf", "Particle filtering"),
    ("genjax_xla.inference.smc2", "SMC² (joint param+state)"),
    ("genjax_xla.inference.mcmc", "MCMC drivers"),
    ("genjax_xla.inference.adaptation", "NUTS warmup adaptation"),
    ("genjax_xla.inference.vi", "Variational inference"),
    ("genjax_xla.inference.transforms", "Support transforms"),
    ("genjax_xla.adev.core", "ADEV core"),
    ("genjax_xla.adev.primitives", "ADEV gradient strategies"),
    ("genjax_xla.parallel.mesh", "Device meshes"),
    ("genjax_xla.parallel.collectives", "Explicit collectives"),
    ("genjax_xla.parallel.smc", "Sharded SMC"),
    ("genjax_xla.parallel.pf", "Sharded particle filter"),
    ("genjax_xla.parallel.seq", "Sequence parallelism (time sharding)"),
    ("genjax_xla.parallel.svgd", "Mesh-sharded SVGD"),
    ("genjax_xla.ops.logmatmul", "Log-space matrix product"),
    ("genjax_xla.ops.mxu", "bf16-operand contraction (f32 accumulation)"),
    ("genjax_xla.utils.checkpoint", "Checkpointing"),
    ("genjax_xla.utils.failure", "Failure detection / elastic recovery"),
    ("genjax_xla.utils.diagnostics_doc", None),  # placeholder, skipped
    ("genjax_xla.inference.svgd", "Stein variational gradient descent"),
    ("genjax_xla.inference.requests.ess", "Elliptical slice sampling"),
    ("genjax_xla.inference.predictive", "Posterior predictive sampling"),
    ("genjax_xla.inference.enumerative", "Exact enumerative posteriors"),
    ("genjax_xla.inference.diagnostics", "Convergence diagnostics"),
    ("genjax_xla.models", "Model families with exact oracles"),
    ("genjax_xla.models.slds", "Switching LDS + Rao-Blackwellized PF"),
    ("genjax_xla.compat", "Reference-migration shims"),
]


def _public_members(mod):
    names = getattr(mod, "__all__", None)
    if names is None:
        names = [n for n in vars(mod) if not n.startswith("_")]
    out = []
    for n in names:
        obj = getattr(mod, n, None)
        if obj is None:
            continue
        if inspect.ismodule(obj):
            continue
        defined_in = getattr(obj, "__module__", mod.__name__)
        if defined_in and not str(defined_in).startswith("genjax_xla"):
            # Re-exported third-party (jax etc.): list name only.
            out.append((n, obj, False))
        else:
            out.append((n, obj, True))
    return out


def _signature(obj) -> str:
    try:
        sig = str(inspect.signature(obj))
    except (TypeError, ValueError):
        return ""
    # Default values that repr with a memory address (functions, bound
    # objects) would churn the generated pages on every run.
    return re.sub(r" at 0x[0-9a-f]+", "", sig)


def _doc(obj) -> str:
    d = inspect.getdoc(obj)
    return d or ""


def module_markdown(modname: str, blurb: str) -> str:
    mod = importlib.import_module(modname)
    lines = [f"# `{modname}`", ""]
    if blurb:
        lines += [f"*{blurb}*", ""]
    mdoc = _doc(mod)
    if mdoc:
        lines += [mdoc, ""]
    for name, obj, own in _public_members(mod):
        if not own:
            lines += [f"## `{name}`", "", "(re-export)", ""]
            continue
        if inspect.isclass(obj):
            lines += [f"## class `{name}`", ""]
            d = _doc(obj)
            if d:
                lines += [d, ""]
            for mname, meth in inspect.getmembers(obj):
                if mname.startswith("_") or not (
                    inspect.isfunction(meth) or inspect.ismethod(meth)
                ):
                    continue
                if meth.__qualname__.split(".")[0] != name:
                    continue  # inherited
                sig = _signature(meth)
                lines += [f"### `{name}.{mname}{sig}`", ""]
                d = _doc(meth)
                if d:
                    lines += [d, ""]
        elif inspect.isfunction(obj):
            lines += [f"## `{name}{_signature(obj)}`", ""]
            d = _doc(obj)
            if d:
                lines += [d, ""]
        else:
            lines += [f"## `{name}`", "",
                      f"`{type(obj).__name__}` instance.", ""]
            d = _doc(obj) if not isinstance(obj, (int, float, str)) else ""
            if d and d != _doc(type(obj)):
                lines += [d, ""]
    return "\n".join(lines)


def _md_to_html(md: str) -> str:
    """Tiny renderer: headers, inline code, paragraphs (enough for the
    generated reference; no external markdown dep in the image)."""
    out = []
    for block in md.split("\n\n"):
        b = block.strip()
        if not b:
            continue
        esc = html.escape(b)
        # inline code
        parts = esc.split("`")
        rendered = ""
        for i, p in enumerate(parts):
            rendered += f"<code>{p}</code>" if i % 2 else p
        if b.startswith("### "):
            out.append(f"<h3>{rendered[4:]}</h3>")
        elif b.startswith("## "):
            out.append(f"<h2>{rendered[3:]}</h2>")
        elif b.startswith("# "):
            out.append(f"<h1>{rendered[2:]}</h1>")
        else:
            out.append(f"<p>{rendered.replace(chr(10), '<br/>')}</p>")
    return "\n".join(out)


STYLE = """
body { font-family: system-ui, sans-serif; max-width: 60rem;
       margin: 2rem auto; padding: 0 1rem; line-height: 1.5;
       color: #1a1a1a; }
code { background: #f3f4f6; padding: 0.1em 0.3em; border-radius: 4px;
       font-size: 0.92em; }
h1 { border-bottom: 2px solid #ddd; padding-bottom: 0.3rem; }
h2 { margin-top: 2rem; border-bottom: 1px solid #eee; }
h3 { margin-top: 1.2rem; color: #333; }
nav a { margin-right: 0.8rem; }
"""


def main() -> None:
    api_dir = os.path.join(ROOT, "docs", "api")
    site_dir = os.path.join(ROOT, "docs", "site")
    os.makedirs(api_dir, exist_ok=True)
    os.makedirs(site_dir, exist_ok=True)

    index = ["# genjax_xla API reference", "",
             "Generated by `python docs/gen_api.py`.", ""]
    html_sections = []
    for modname, blurb in MODULES:
        if blurb is None:
            continue
        try:
            md = module_markdown(modname, blurb)
        except ImportError:
            continue
        slug = modname.replace(".", "_")
        with open(os.path.join(api_dir, f"{slug}.md"), "w") as f:
            f.write(md + "\n")
        index.append(f"- [`{modname}`]({slug}.md) — {blurb}")
        html_sections.append(
            f'<section id="{slug}">{_md_to_html(md)}</section>'
        )

    with open(os.path.join(api_dir, "index.md"), "w") as f:
        f.write("\n".join(index) + "\n")

    nav = " ".join(
        f'<a href="#{m.replace(".", "_")}">{m.split(".")[-1]}</a>'
        for m, b in MODULES if b is not None
    )
    page = (
        "<!doctype html><html><head><meta charset='utf-8'>"
        "<title>genjax_xla API reference</title>"
        f"<style>{STYLE}</style></head><body>"
        f"<h1>genjax_xla API reference</h1><nav>{nav}</nav>"
        + "\n".join(html_sections)
        + "</body></html>"
    )
    with open(os.path.join(site_dir, "api.html"), "w") as f:
        f.write(page)
    print(f"wrote {len(html_sections)} module pages -> docs/api/, "
          "docs/site/api.html")


if __name__ == "__main__":
    main()
