"""Run every ```python block of the repo's ``docs/*.md`` through the port.

    python -m repro_torch.tools.check_docs [--device cuda|cpu]

The port of ``tools/check_docs.py``. The docs are written against the JAX
package and are read in place, unchanged; each block is carried to the
port by a rewrite of its syntax tree (``ast``, then ``ast.unparse``) and
run in a namespace of its own, inside a temporary directory that is
removed afterwards (``tempfile`` hands out paths under it). The rewrite
map:

- ``import repro`` / ``import repro.x`` / ``from repro.x import ...`` ->
  the same under ``repro_torch``, and the name ``repro`` -> ``repro_torch``;
- every ``RemixDBConfig(...)`` call gets ``device=<--device>``;
- a config is added to the calls that create a store with the default
  config: ``RemixDB()``, ``RemixDB.open(root)`` and ``Cluster(root, ...)``
  without ``config=``, as ``RemixDBConfig(device=<--device>)``;
- names imported from ``repro`` under an alias are followed.

A block the map cannot carry (it imports ``jax``, or passes a config or its
fields through ``*args`` / ``**kwargs``, or already names a ``device``) is
reported as ``FAIL`` with the reason; nothing is skipped. The tool prints
``N/M doc snippets passed`` and exits 1 on any failure. ``--device``
defaults to the card; there is no fallback to the CPU.
"""
from __future__ import annotations

import argparse
import ast
import pathlib
import re
import sys
import tempfile
import traceback

FENCE = re.compile(r"^```python\s*$(.*?)^```\s*$", re.M | re.S)
DOCS = pathlib.Path(__file__).resolve().parents[3] / "docs"
# the store's config class as the rewrite names it where a block had none
CONFIG_NAME = "_docs_RemixDBConfig"
# (callee, position of its config argument)
CONFIG_TAKERS = {"RemixDB": 0, "RemixDB.open": 1, "Cluster": 2}


def blocks(md: str):
    """``(line, code)`` of each ```python block; ``line`` is the block's
    first line of code, 1-based."""
    for m in FENCE.finditer(md):
        yield md[: m.start()].count("\n") + 2, m.group(1)


class Uncarried(Exception):
    """A block the rewrite map cannot carry to the port."""


def _port_module(name: str) -> str:
    return "repro_torch" + name[len("repro"):]


def _is_repro(name: str) -> bool:
    return name == "repro" or name.startswith("repro.")


class _Carry(ast.NodeTransformer):
    def __init__(self, device: str):
        self.device = device
        self.aliases: dict[str, str] = {}  # local name -> reference name
        self.added_config = False

    def visit_Import(self, node):
        for a in node.names:
            if a.name.split(".")[0] == "jax":
                raise Uncarried(f"imports {a.name}: the port has no JAX")
            if _is_repro(a.name):
                a.name = _port_module(a.name)
        return node

    def visit_Name(self, node):
        # ``import repro.x`` binds ``repro``; the carried import binds
        # ``repro_torch``
        if node.id == "repro":
            node.id = "repro_torch"
        return node

    def visit_ImportFrom(self, node):
        mod = node.module or ""
        if mod.split(".")[0] == "jax":
            raise Uncarried(f"imports from {mod}: the port has no JAX")
        if node.level == 0 and _is_repro(mod):
            node.module = _port_module(mod)
            for a in node.names:
                self.aliases[a.asname or a.name] = a.name
        return node

    def _callee(self, func) -> str | None:
        """``RemixDBConfig`` / ``RemixDB`` / ``RemixDB.open`` / ``Cluster``
        for a call of one of them (by name, alias or attribute)."""
        if isinstance(func, ast.Name):
            return self.aliases.get(func.id, func.id)
        if isinstance(func, ast.Attribute):
            if func.attr == "open":
                inner = self._callee(func.value)
                return "RemixDB.open" if inner == "RemixDB" else None
            return func.attr
        return None

    def _config(self) -> ast.Call:
        self.added_config = True
        return ast.Call(ast.Name(CONFIG_NAME, ast.Load()), [],
                        [ast.keyword("device", ast.Constant(self.device))])

    def visit_Call(self, node):
        self.generic_visit(node)
        callee = self._callee(node.func)
        starred = (any(isinstance(a, ast.Starred) for a in node.args)
                   or any(k.arg is None for k in node.keywords))
        if callee == "RemixDBConfig":
            if starred:
                raise Uncarried("RemixDBConfig(**...): cannot tell whether it sets device")
            if any(k.arg == "device" for k in node.keywords):
                raise Uncarried("RemixDBConfig(device=...): the reference has no such field")
            node.keywords.append(ast.keyword("device", ast.Constant(self.device)))
        elif callee in CONFIG_TAKERS:
            if starred:
                raise Uncarried(f"{callee}(*...): cannot tell whether it passes a config")
            pos = CONFIG_TAKERS[callee]
            if len(node.args) <= pos and not any(k.arg == "config" for k in node.keywords):
                node.keywords.append(ast.keyword("config", self._config()))
        return node


def carry(code: str, device: str) -> str:
    """The block ``code`` rewritten for the port on ``device``; raises
    :class:`Uncarried` with the reason where the map cannot carry it."""
    tree = ast.parse(code)
    t = _Carry(device)
    tree = t.visit(tree)
    if t.added_config:
        tree.body.insert(0, ast.ImportFrom(
            "repro_torch.db.store",
            [ast.alias("RemixDBConfig", CONFIG_NAME)], 0))
    return ast.unparse(ast.fix_missing_locations(tree))


def run_block(code: str, label: str, device: str) -> str | None:
    """Carry and run one block; ``None`` when it passed, else the reason
    it failed (the traceback, or why it could not be carried)."""
    try:
        carried = carry(code, device)
    except Uncarried as e:
        return f"cannot carry: {e}"
    old = tempfile.tempdir
    with tempfile.TemporaryDirectory(ignore_cleanup_errors=True) as tmp:
        tempfile.tempdir = tmp
        try:
            exec(compile(carried, label, "exec"), {"__name__": "__docs__"})
        except Exception:
            return traceback.format_exc()
        finally:
            tempfile.tempdir = old
    return None


def collect(docs: pathlib.Path) -> list[tuple[str, str]]:
    """``(label, code)`` of every block, labelled ``docs/X.md:line``."""
    out = []
    for doc in sorted(docs.glob("*.md")):
        for line, code in blocks(doc.read_text()):
            out.append((f"{docs.name}/{doc.name}:{line}", code))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device the stores run on (default: the card)")
    args = ap.parse_args(argv)
    found = collect(DOCS)
    failures = 0
    for label, code in found:
        reason = run_block(code, label, args.device)
        if reason is None:
            print(f"ok   {label}")
        else:
            failures += 1
            print(f"FAIL {label}: {reason}")
    print(f"{len(found) - failures}/{len(found)} doc snippets passed")
    return 1 if failures or not found else 0


if __name__ == "__main__":
    sys.exit(main())
