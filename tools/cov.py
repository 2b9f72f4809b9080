"""Vendored line-coverage tool (the image ships no pytest-cov/coverage).

Uses CPython 3.12's ``sys.monitoring`` (PEP 669): LINE events are armed
for code objects whose filename lives under ``genjax_xla/`` and each
line is DISABLEd after its first hit, so steady-state overhead is near
zero. Executable lines are derived per file by compiling the source and
walking every nested code object's ``co_lines()`` — the same universe
coverage.py uses (minus its arc analysis).

Usage::

    python tools/cov.py [pytest args...]     # default: tests/ -q -n0
    python tools/cov.py --json out.json tests/ -q

Prints a per-file table + a TOTAL line, and writes ``coverage.json``.
The reference gates at 45 % (reference ``pyproject.toml:100``,
``noxfile.py:79-93``); we record the number in PARITY.md and enforce a
floor via ``--fail-under``.
"""

from __future__ import annotations

import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "genjax_xla")

TOOL = sys.monitoring.COVERAGE_ID


def _executable_lines(path: str) -> set[int]:
    """All line numbers carrying bytecode in ``path`` (nested defs too)."""
    with open(path, "r") as f:
        src = f.read()
    try:
        top = compile(src, path, "exec")
    except SyntaxError:
        return set()
    lines: set[int] = set()
    stack = [top]
    while stack:
        code = stack.pop()
        for _, _, ln in code.co_lines():
            if ln is not None and ln > 0:
                lines.add(ln)
        for const in code.co_consts:
            if isinstance(const, type(top)):
                stack.append(const)
    return lines


def collect(pytest_args: list[str]) -> tuple[dict[str, set[int]], int]:
    hits: dict[str, set[int]] = {}

    def on_line(code, lineno):
        fn = code.co_filename
        if fn.startswith(PKG):
            hits.setdefault(fn, set()).add(lineno)
        # DISABLE is per-(code, line): each location fires exactly once,
        # so steady-state overhead is ~zero either way.
        return sys.monitoring.DISABLE

    sys.monitoring.use_tool_id(TOOL, "genjax_xla-cov")
    sys.monitoring.register_callback(
        TOOL, sys.monitoring.events.LINE, on_line
    )
    sys.monitoring.set_events(TOOL, sys.monitoring.events.LINE)
    try:
        import pytest

        rc = pytest.main(pytest_args)
    finally:
        sys.monitoring.set_events(TOOL, 0)
        sys.monitoring.free_tool_id(TOOL)
    return hits, int(rc)


def report(hits: dict[str, set[int]], json_out: str) -> float:
    rows = []
    tot_exec = tot_hit = 0
    for dirpath, _dirs, files in os.walk(PKG):
        for f in sorted(files):
            if not f.endswith(".py"):
                continue
            path = os.path.join(dirpath, f)
            execu = _executable_lines(path)
            if not execu:
                continue
            hit = hits.get(path, set()) & execu
            tot_exec += len(execu)
            tot_hit += len(hit)
            rows.append(
                (os.path.relpath(path, ROOT), len(execu), len(hit))
            )
    rows.sort()
    width = max(len(r[0]) for r in rows) + 2
    print(f"\n{'file'.ljust(width)}  lines   hit    %")
    out = {}
    for name, ne, nh in rows:
        pct = 100.0 * nh / ne
        out[name] = {"lines": ne, "hit": nh, "pct": round(pct, 1)}
        print(f"{name.ljust(width)}  {ne:5d} {nh:5d}  {pct:5.1f}")
    total_pct = 100.0 * tot_hit / max(tot_exec, 1)
    print(f"{'TOTAL'.ljust(width)}  {tot_exec:5d} {tot_hit:5d}  {total_pct:5.1f}")
    out["TOTAL"] = {
        "lines": tot_exec, "hit": tot_hit, "pct": round(total_pct, 1)
    }
    with open(json_out, "w") as f:
        json.dump(out, f, indent=1)
    return total_pct


def main() -> int:
    args = sys.argv[1:]
    json_out = "coverage.json"
    fail_under = 0.0
    if "--json" in args:
        i = args.index("--json")
        json_out = args[i + 1]
        del args[i : i + 2]
    if "--fail-under" in args:
        i = args.index("--fail-under")
        fail_under = float(args[i + 1])
        del args[i : i + 2]
    if not args:
        args = ["tests/", "-q", "-p", "no:cacheprovider"]
    hits, rc = collect(args)
    pct = report(hits, json_out)
    if rc != 0:
        return rc
    if pct < fail_under:
        print(f"FAIL: coverage {pct:.1f}% < --fail-under {fail_under}")
        return 2
    return 0


if __name__ == "__main__":
    sys.exit(main())
