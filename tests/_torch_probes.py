"""The reference's design probes (its root `scripts/*.py`) run at a small
size, for the tests that hold the port's probes to them.

The reference's scripts keep everything inside `main()` and read the bench's
size from `bench.py` at import, so each is compiled from its file with
`ast`, less its `import bench`, its `jax.config` lines (the persistent
cache, the platform switch), its `sys.path` edit and its `__main__` guard,
and run in a namespace whose `bench` is a stub: a small H x W and surfel
count, and the real `street_scene_bundle`.  Its standard output is
returned.  The scripts are not edited."""

from __future__ import annotations

import ast
import contextlib
import io
import sys
import types
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def _kept(node: ast.stmt) -> bool:
    src = ast.unparse(node)
    if isinstance(node, (ast.Import, ast.ImportFrom)):
        return not any(a.name == "bench" for a in node.names)
    if isinstance(node, ast.If):
        return "__name__" not in src and "jax.config" not in src
    return "jax.config.update" not in src and "sys.path" not in src


def _without(node: ast.stmt, names) -> ast.stmt | None:
    """node less its bindings of `names` (an import's aliases, a function
    or an assignment of one of them), or None if nothing is left."""
    if isinstance(node, (ast.Import, ast.ImportFrom)):
        kept = [a for a in node.names
                if (a.asname or a.name.split(".")[0]) not in names]
        if not kept:
            return None
        node.names = kept
        return node
    if isinstance(node, ast.FunctionDef) and node.name in names:
        return None
    if isinstance(node, ast.Assign) and all(
            isinstance(t, ast.Name) and t.id in names
            for t in node.targets):
        return None
    return node


def reference_bench():
    """The reference's `bench.py`, its import-time `jax.config` settings
    (a persistent compilation cache under /tmp) undone, so that the rest
    of the test process keeps the cache settings it had."""
    import jax

    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    keys = ("jax_compilation_cache_dir",
            "jax_persistent_cache_min_compile_time_secs")
    saved = {k: getattr(jax.config, k) for k in keys}
    try:
        import bench
    finally:
        for k, v in saved.items():
            jax.config.update(k, v)
    return bench


def reference_probe(script: str, h: int, w: int, n: int, scene=None,
                    pre: dict | None = None, **overrides) -> str:
    """Standard output of `scripts/<script>`'s main() at h x w rays and n
    surfels (`script` may name a path from there, as "../bench.py"); the
    stub `bench` holds the bench's knobs (`_TILE_H`, ...) as `bench.py`
    reads them; `scene` (n, seed -> jax SurfelBundle) stands in for the
    bench's soup where given; `overrides` replace module globals after the
    module's own statements ran (e.g. a stub timer).  `pre` are globals in
    place before they run, each name's own bindings (its import, def or
    assignment) taken out of the script: for scripts whose top level does
    the work, and for names that top level uses (a stub `jax`).  A script
    with no main() has run once its top level has."""
    bench = reference_bench()
    pre = pre or {}
    path = ROOT / "scripts" / script
    tree = ast.parse(path.read_text())
    body = [_without(n_, pre) for n_ in tree.body if _kept(n_)]
    module = ast.Module(body=[n_ for n_ in body if n_ is not None],
                        type_ignores=[])
    stub = types.SimpleNamespace(
        H=h, W=w, N_SURFELS=n,
        street_scene_bundle=scene or bench.street_scene_bundle,
        **{k: getattr(bench, k) for k in vars(bench)
           if k.startswith("_") and k[1:].isupper()})
    ns = {"__name__": f"reference_{path.stem}", "bench": stub, **pre}
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        exec(compile(module, str(path), "exec"), ns)
        ns.update(overrides)
        if "main" in ns:
            ns["main"]()
    return out.getvalue()


def numbers(line: str) -> list[float]:
    """Every number in a printed line, in order."""
    import re

    return [float(x) for x in
            re.findall(r"-?\d+(?:\.\d+)?(?:e[-+]?\d+)?", line)]
