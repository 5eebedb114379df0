"""Every public top-level name of the JAX package is reachable in the port.

For each ``src/repro/**/*.py`` the reference module is parsed with ``ast``
(nothing of it is imported, so JAX is not needed) and its public names are
collected: what it defines (functions, classes, assigned names, ``__all__``)
and what it imports from ``repro`` or ``jax`` by name. Names that import a
module of the reference (``from repro.core import keys as CK``) are
internal aliases and not counted. Each name must be an attribute of the
port's counterpart module (``repro`` -> ``repro_torch``); a function or
class of the reference must be callable there too. The only exceptions are
in ``EXEMPT``, each with its reason.
"""
import ast
import importlib
import pathlib

import pytest

pytest.importorskip("torch")

SRC = pathlib.Path(__file__).resolve().parent.parent / "src"
REF = SRC / "repro"

_JAX_SHARDING = "a JAX sharding type; the port places tensors with torch.distributed"
_HLO = "HLO-only: the port lowers to no HLO (its dry run counts on fake process groups)"
_PALLAS = "the Pallas module; the port's kernels are CUDA C++ in repro_torch/csrc"
_KERNEL_MODULE = ("kept as a module so its wrapper's launch count stays reachable "
                  "(the wrapper is the module's attribute of the same name)")

EXEMPT = {
    ("db.sharded", "Mesh"): _JAX_SHARDING,
    ("db.sharded", "NamedSharding"): _JAX_SHARDING,
    ("db.sharded", "P"): _JAX_SHARDING,
    ("models.sharding", "Mesh"): _JAX_SHARDING,
    ("models.sharding", "NamedSharding"): _JAX_SHARDING,
    ("models.sharding", "P"): _JAX_SHARDING,
    ("launch.train", "NamedSharding"): _JAX_SHARDING,
    ("launch.train", "P"): _JAX_SHARDING,
    ("launch.dryrun", "NamedSharding"): _JAX_SHARDING,
    ("launch.dryrun", "P"): _JAX_SHARDING,
    ("launch.dryrun", "COLLECTIVE_RE"): _HLO,
    ("launch.dryrun", "SHAPE_RE"): _HLO,
    ("launch.dryrun", "DTYPE_BYTES"): _HLO,
    ("launch.dryrun", "HLO_DIR"): _HLO,
    ("launch.dryrun", "collective_bytes"): _HLO,
    ("launch.roofline", "LINK_BW"): ("a TPU ICI link's rate; the port's roofline uses "
                                     "the H100's links (NVLINK_BW, IB_BW)"),
    ("models.model", "REMAT_POLICY"): ("a jax.checkpoint policy; the port checkpoints "
                                       "each layer whole with torch.utils.checkpoint"),
    ("kernels.anchor_search", "pl"): _PALLAS,
    ("kernels.selector_decode", "pl"): _PALLAS,
    ("kernels", "anchor_search"): _KERNEL_MODULE,
    ("kernels", "selector_decode"): _KERNEL_MODULE,
}


def _module_path(dotted: str) -> pathlib.Path | None:
    """Source file of a reference module ``repro.a.b``, if it is one."""
    base = SRC.joinpath(*dotted.split("."))
    for p in (base.with_suffix(".py"), base / "__init__.py"):
        if p.is_file():
            return p
    return None


def _defined(tree: ast.Module) -> dict[str, bool]:
    """Names a module defines at top level -> whether each is a def/class."""
    out = {}
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            out[node.name] = True
        elif isinstance(node, ast.Assign):
            for t in node.targets:
                for n in [t] if isinstance(t, ast.Name) else getattr(t, "elts", []):
                    if isinstance(n, ast.Name):
                        out.setdefault(n.id, False)
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
            out.setdefault(node.target.id, False)
    return out


def _is_callable_in(dotted: str, name: str) -> bool:
    path = _module_path(dotted)
    return path is not None and _defined(ast.parse(path.read_text())).get(name, False)


def public_names(path: pathlib.Path) -> dict[str, bool]:
    """Public names of one reference module -> whether each is a function
    or class there (as far as the source shows)."""
    tree = ast.parse(path.read_text())
    names = _defined(tree)
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == "__all__" for t in node.targets):
            for e in node.value.elts:
                names.setdefault(e.value, False)
        if not (isinstance(node, ast.ImportFrom) and node.module and node.level == 0):
            continue
        root = node.module.split(".")[0]
        if root not in ("repro", "jax"):
            continue
        for a in node.names:
            if root == "repro" and _module_path(f"{node.module}.{a.name}"):
                continue  # a module alias
            callable_ = root == "repro" and _is_callable_in(node.module, a.name)
            names[a.asname or a.name] = names.get(a.asname or a.name, False) or callable_
    return {n: c for n, c in names.items() if not n.startswith("_")}


def _short(path: pathlib.Path) -> str:
    parts = list(path.relative_to(REF).with_suffix("").parts)
    return ".".join(parts[:-1] if parts[-1] == "__init__" else parts)


MODULES = sorted(_short(p) for p in REF.rglob("*.py"))


def _carried(port, name: str, is_callable: bool) -> bool:
    return hasattr(port, name) and (not is_callable or callable(getattr(port, name)))


def test_every_reference_module_is_listed():
    assert len(MODULES) > 50 and {"db.store", "kernels", "obs"} <= set(MODULES)


def test_exemptions_name_real_gaps():
    """An exemption names a public name of the reference that the port
    does not carry; it is dropped once the port carries it."""
    for (mod, name), reason in EXEMPT.items():
        assert reason
        names = public_names(_module_path(f"repro.{mod}"))
        assert name in names, (mod, name)
        port = importlib.import_module(f"repro_torch.{mod}")
        assert not _carried(port, name, names[name]), (mod, name)


@pytest.mark.parametrize("mod", MODULES)
def test_public_names_reachable(mod):
    port = importlib.import_module(f"repro_torch.{mod}")
    missing = [name for name, is_callable
               in sorted(public_names(_module_path(f"repro.{mod}")).items())
               if (mod, name) not in EXEMPT and not _carried(port, name, is_callable)]
    assert not missing, f"repro_torch.{mod} lacks (or has no callable) {missing}"
