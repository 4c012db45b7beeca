"""Layer 3: repo-specific AST rules over ``runtime/``, ``models/`` and
``obs/`` (the counterpart of ``repro/analysis/ast_lint.py``).

Works on source text only (no imports, no execution):

* **AST001** — host-transfer calls (``.item()``, ``.cpu()``,
  ``.tolist()``, ``.numpy()``, ``.synchronize()`` — that is
  ``torch.cuda.synchronize``, ``Event.synchronize`` and
  ``Stream.synchronize`` —, ``np.asarray``/``np.array``) or HOST RNG
  calls (``np.random.*``, the stdlib ``random`` module) inside a
  *hot-path body*: any function statically reachable from the work-unit
  bodies (contracts.HOT_PATH_ROOTS) through a conservative call graph
  (module-level calls, imported-module calls — imports inside
  functions too —, ``self.`` method calls).  A work unit's body is
  captured into one CUDA graph: a host read inside it either fails the
  capture or freezes a value, and a host draw bakes one sample into
  every replay, where the contract requires the device-side threefry
  keyed by (seed, position) (models/sampling.py).
* **AST002** — ``@`` / ``matmul`` / ``mm`` / ``bmm`` / ``einsum`` /
  ``dot`` / ``linear`` (and the other contraction routines) inside the
  parity-critical attention bodies (contracts.PARITY_BODIES), which
  must phrase scores and PV as explicit multiply + ``sum``.
* **AST003** — a body given to ``WorkUnit`` (a bound method passed to
  its constructor, directly or through a method of the class that
  builds units) reading mutable server state through ``self.<attr>``,
  where mutable means "rebound outside ``__init__``" — the captured
  graph holds the object the body read at capture, so a later rebind
  (``self.pos = ...``) is never seen by a replay (the seed
  ``SlotServer`` frozen-``self.pos`` bug class).  Writes into a tensor
  held by an attribute are in place and stay visible; they are not
  rebinds.
"""

from __future__ import annotations

import ast
import dataclasses
import os
from typing import Dict, Iterable, List, Optional, Set, Tuple

from repro_torch.analysis import contracts
from repro_torch.analysis.report import Finding, Report

# attr names whose call is a host transfer or a host synchronization
_TRANSFER_METHODS = {"item", "cpu", "tolist", "numpy", "synchronize"}
# numpy constructors that force device->host materialization
_NUMPY_TRANSFERS = {"asarray", "array", "frombuffer", "copyto", "save"}
# contraction entry points forbidden in parity-critical bodies
_DOT_CALLS = {"matmul", "mm", "bmm", "einsum", "dot", "linear",
              "tensordot", "vdot", "inner", "addmm", "baddbmm"}
# the work-unit class whose constructor takes a body
_UNIT_CLASS = "WorkUnit"


@dataclasses.dataclass
class ModuleInfo:
    name: str                                   # dotted module name
    path: str                                   # filesystem path
    tree: ast.Module
    mod_aliases: Dict[str, str]                 # local alias -> module
    func_imports: Dict[str, Tuple[str, str]]    # name -> (module, func)
    functions: Dict[str, ast.AST]               # qualname -> def node
    classes: Dict[str, ast.ClassDef]


def _module_name(path: str, repo_root: str) -> str:
    rel = os.path.relpath(os.path.abspath(path),
                          os.path.join(os.path.abspath(repo_root), "src"))
    if not rel.startswith(".."):
        return rel[:-3].replace(os.sep, ".")
    return os.path.splitext(os.path.basename(path))[0]


def parse_module(path: str, repo_root: str = ".") -> ModuleInfo:
    with open(path, "r") as fh:
        tree = ast.parse(fh.read(), filename=path)
    mod_aliases: Dict[str, str] = {}
    func_imports: Dict[str, Tuple[str, str]] = {}
    functions: Dict[str, ast.AST] = {}
    classes: Dict[str, ast.ClassDef] = {}
    # imports anywhere in the module: the port imports some modules
    # inside the functions that use them
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                mod_aliases[a.asname or a.name.split(".")[0]] = a.name
        elif isinstance(node, ast.ImportFrom) and node.module \
                and node.level == 0:
            for a in node.names:
                local = a.asname or a.name
                # `from pkg import mod` and `from pkg.mod import fn`
                # are indistinguishable statically; record both views
                # and let resolution try module-first.
                mod_aliases[local] = f"{node.module}.{a.name}"
                func_imports[local] = (node.module, a.name)
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            functions[node.name] = node
        elif isinstance(node, ast.ClassDef):
            classes[node.name] = node
            for item in node.body:
                if isinstance(item, (ast.FunctionDef,
                                     ast.AsyncFunctionDef)):
                    functions[f"{node.name}.{item.name}"] = item
    return ModuleInfo(_module_name(path, repo_root), path, tree,
                      mod_aliases, func_imports, functions, classes)


def _iter_calls(node: ast.AST) -> Iterable[ast.Call]:
    for n in ast.walk(node):
        if isinstance(n, ast.Call):
            yield n


def _resolve_call(call: ast.Call, mod: ModuleInfo, cls: Optional[str],
                  modules: Dict[str, ModuleInfo]
                  ) -> Optional[Tuple[str, str]]:
    """(module_name, qualname) of the call target, or None."""
    f = call.func
    if isinstance(f, ast.Name):
        if f.id in mod.func_imports:
            m, fn = mod.func_imports[f.id]
            if m in modules and fn in modules[m].functions:
                return m, fn
        if f.id in mod.functions:
            return mod.name, f.id
        return None
    if isinstance(f, ast.Attribute) and isinstance(f.value, ast.Name):
        base, attr = f.value.id, f.attr
        if base == "self" and cls is not None:
            q = f"{cls}.{attr}"
            if q in mod.functions:
                return mod.name, q
            return None
        target = mod.mod_aliases.get(base)
        if target and target in modules \
                and attr in modules[target].functions:
            return target, attr
    return None


def _reachable(roots: List[Tuple[str, str]],
               modules: Dict[str, ModuleInfo]
               ) -> Set[Tuple[str, str]]:
    seen: Set[Tuple[str, str]] = set()
    frontier = [r for r in roots
                if r[0] in modules and r[1] in modules[r[0]].functions]
    while frontier:
        m, q = frontier.pop()
        if (m, q) in seen:
            continue
        seen.add((m, q))
        mod = modules[m]
        cls = q.split(".")[0] if "." in q else None
        for call in _iter_calls(mod.functions[q]):
            tgt = _resolve_call(call, mod, cls, modules)
            if tgt is not None and tgt not in seen:
                frontier.append(tgt)
    return seen


def _numpy_aliases(mod: ModuleInfo) -> Set[str]:
    return {a for a, m in mod.mod_aliases.items() if m == "numpy"}


def _check_transfers(mod: ModuleInfo, qual: str, node: ast.AST,
                     report: Report) -> None:
    np_al = _numpy_aliases(mod)
    for call in _iter_calls(node):
        f = call.func
        if not isinstance(f, ast.Attribute):
            continue
        hit = None
        if f.attr in _TRANSFER_METHODS:
            hit = f".{f.attr}()"
        elif isinstance(f.value, ast.Name):
            if f.value.id in np_al and f.attr in _NUMPY_TRANSFERS:
                hit = f"{f.value.id}.{f.attr}()"
            elif mod.mod_aliases.get(f.value.id) == "random":
                hit = f"{f.value.id}.{f.attr}() [host RNG]"
        elif isinstance(f.value, ast.Attribute) \
                and isinstance(f.value.value, ast.Name) \
                and f.value.value.id in np_al \
                and f.value.attr == "random":
            # np.random.<anything>: host RNG in a work unit — sampling
            # must go through the device-side threefry keyed by
            # (seed, position)
            hit = f"{f.value.value.id}.random.{f.attr}() [host RNG]"
        if hit:
            report.add(Finding(
                "AST001",
                f"{hit} inside hot-path body {mod.name}.{qual} "
                f"(transfer-free serving contract)",
                path=mod.path, line=call.lineno,
                detail={"function": qual, "call": hit}))


def _check_parity_body(mod: ModuleInfo, qual: str, node: ast.AST,
                       report: Report) -> None:
    for n in ast.walk(node):
        if isinstance(n, ast.BinOp) and isinstance(n.op, ast.MatMult):
            report.add(Finding(
                "AST002",
                f"matmul operator in parity-critical body "
                f"{mod.name}.{qual}; scores/PV must stay explicit "
                f"multiply+sum",
                path=mod.path, line=n.lineno,
                detail={"function": qual, "op": "@"}))
        elif isinstance(n, ast.Call) \
                and isinstance(n.func, ast.Attribute) \
                and n.func.attr in _DOT_CALLS:
            report.add(Finding(
                "AST002",
                f"{n.func.attr}() in parity-critical body "
                f"{mod.name}.{qual}; scores/PV must stay explicit "
                f"multiply+sum",
                path=mod.path, line=n.lineno,
                detail={"function": qual, "op": n.func.attr}))


def _methods(cls_node: ast.ClassDef) -> Dict[str, ast.AST]:
    return {item.name: item for item in cls_node.body
            if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef))}


def _mutable_attrs(cls_node: ast.ClassDef) -> Set[str]:
    """Attributes rebound through ``self.<attr> = ...`` (or ``+=``, or as
    part of a tuple target) outside __init__."""
    out: Set[str] = set()
    for name, item in _methods(cls_node).items():
        if name == "__init__":
            continue
        for n in ast.walk(item):
            targets = []
            if isinstance(n, ast.Assign):
                targets = n.targets
            elif isinstance(n, (ast.AugAssign, ast.AnnAssign)):
                targets = [n.target]
            while targets:
                t = targets.pop()
                if isinstance(t, (ast.Tuple, ast.List)):
                    targets.extend(t.elts)
                elif isinstance(t, ast.Starred):
                    targets.append(t.value)
                elif isinstance(t, ast.Attribute) \
                        and isinstance(t.value, ast.Name) \
                        and t.value.id == "self":
                    out.add(t.attr)
    return out


def _self_reads(node: ast.AST, attrs: Set[str]
                ) -> List[Tuple[str, int]]:
    hits = []
    for n in ast.walk(node):
        if isinstance(n, ast.Attribute) and isinstance(n.ctx, ast.Load) \
                and isinstance(n.value, ast.Name) \
                and n.value.id == "self" and n.attr in attrs:
            hits.append((n.attr, n.lineno))
    return hits


def _is_unit_ctor(call: ast.Call) -> bool:
    f = call.func
    return ((isinstance(f, ast.Name) and f.id == _UNIT_CLASS)
            or (isinstance(f, ast.Attribute) and f.attr == _UNIT_CLASS))


def _method_refs(node: ast.AST, methods: Set[str]) -> List[Tuple[str, int]]:
    """Bound methods ``self.<m>`` referenced as values (not called)."""
    called = {id(c.func) for c in _iter_calls(node)}
    return [(n.attr, n.lineno) for n in ast.walk(node)
            if isinstance(n, ast.Attribute) and isinstance(n.ctx, ast.Load)
            and isinstance(n.value, ast.Name) and n.value.id == "self"
            and n.attr in methods and id(n) not in called]


def unit_bodies(cls_node: ast.ClassDef) -> Dict[str, int]:
    """The class's work-unit bodies: bound methods referenced as values
    inside a method that constructs a ``WorkUnit``, or passed to a call
    of such a method.  {method name: line of the reference}."""
    methods = _methods(cls_node)
    factories = {name for name, item in methods.items()
                 if any(_is_unit_ctor(c) for c in _iter_calls(item))}
    bodies: Dict[str, int] = {}
    for name, item in methods.items():
        if name in factories:
            for m, line in _method_refs(item, set(methods)):
                bodies.setdefault(m, line)
        for call in _iter_calls(item):
            f = call.func
            if isinstance(f, ast.Attribute) and isinstance(f.value, ast.Name) \
                    and f.value.id == "self" and f.attr in factories:
                for arg in list(call.args) + [k.value for k in call.keywords]:
                    for m, line in _method_refs(arg, set(methods)):
                        bodies.setdefault(m, line)
    return bodies


def _check_unit_captures(mod: ModuleInfo, report: Report) -> None:
    for cls_name, cls_node in mod.classes.items():
        mutable = _mutable_attrs(cls_node)
        if not mutable:
            continue
        for body, ref_line in sorted(unit_bodies(cls_node).items()):
            # the method plus everything reachable through self.
            seen: Set[str] = set()
            stack = [body]
            while stack:
                meth = stack.pop()
                q = f"{cls_name}.{meth}"
                if meth in seen or q not in mod.functions:
                    continue
                seen.add(meth)
                node = mod.functions[q]
                for c in _iter_calls(node):
                    if isinstance(c.func, ast.Attribute) \
                            and isinstance(c.func.value, ast.Name) \
                            and c.func.value.id == "self":
                        stack.append(c.func.attr)
                for attr, line in _self_reads(node, mutable):
                    report.add(Finding(
                        "AST003",
                        f"work-unit body {mod.name}.{cls_name}.{body} "
                        f"reads mutable server state self.{attr} (in "
                        f"{meth}); its CUDA graph holds the object read "
                        f"at capture — pass it as an operand instead",
                        path=mod.path, line=line,
                        detail={"class": cls_name, "body": body,
                                "function": meth, "attr": attr,
                                "unit_line": ref_line}))


def collect_paths(repo_root: str = ".") -> List[str]:
    paths: List[str] = []
    for pkg in contracts.AST_SCAN_PACKAGES:
        base = os.path.join(repo_root, pkg)
        for dirpath, _, files in sorted(os.walk(base)):
            for f in sorted(files):
                if f.endswith(".py"):
                    paths.append(os.path.join(dirpath, f))
    for suffix in contracts.PARITY_BODIES:
        p = os.path.join(repo_root, "src", "repro_torch", suffix)
        if p not in paths and os.path.exists(p):
            paths.append(p)
    return paths


def run(report: Report, *, paths: Optional[List[str]] = None,
        repo_root: str = ".",
        roots: Optional[List[Tuple[str, str]]] = None,
        parity_bodies: Optional[Dict[str, Set[str]]] = None) -> None:
    """Lint `paths` (default: the contracts' scan scope under
    `repo_root`).  Raises if a root of `roots` is not among them."""
    paths = collect_paths(repo_root) if paths is None else paths
    roots = contracts.HOT_PATH_ROOTS if roots is None else roots
    parity = (contracts.PARITY_BODIES if parity_bodies is None
              else parity_bodies)
    modules: Dict[str, ModuleInfo] = {}
    for p in paths:
        info = parse_module(p, repo_root)
        modules[info.name] = info

    missing = [r for r in roots
               if r[0] not in modules or r[1] not in modules[r[0]].functions]
    if missing:
        # a scan from the wrong root would find nothing and pass
        raise FileNotFoundError(
            f"hot-path roots {missing} not found in the {len(paths)} "
            f"file(s) scanned under {os.path.abspath(repo_root)!r}")
    hot = _reachable(list(roots), modules)
    for m, q in sorted(hot):
        _check_transfers(modules[m], q, modules[m].functions[q], report)
    report.extras.setdefault("ast_hot_functions", len(hot))

    for mod in modules.values():
        for suffix, fns in parity.items():
            if not mod.path.replace(os.sep, "/").endswith(suffix):
                continue
            for fn in sorted(fns):
                if fn in mod.functions:
                    _check_parity_body(mod, fn, mod.functions[fn],
                                       report)
        _check_unit_captures(mod, report)
