"""Whole-program concurrency analysis.

A copy of ``learningorchestra_tpu/analysis/wholeprogram.py``: the port imports
nothing of the JAX package.

The per-module checker (:mod:`.concurrency`) stops at file boundaries,
but the hazards that matter — engine ↔ leases ↔ compile-cache ↔ fleet —
span modules: a ``ReplicaSet`` method holding its own lock calls into
the ``DeviceLeaser``, which takes the lease condition, which the engine
watchdog also reaches from under the engine lock.  This pass composes
every module's lock model into ONE global lock-order graph by resolving
lock identities and call chains across modules, then checks three
whole-program rules:

``lock-order-global``
    A cycle in the global graph whose locks live in more than one
    module (single-module cycles are the per-module checker's
    jurisdiction).  Cross-module resolution covers: imported module
    functions (including package ``__init__`` re-exports), class
    constructors assigned to ``self.<attr>`` / module globals / local
    variables, and singleton accessors (``get_registry()``-style
    functions whose return resolves to a class instance).

``blocking-call-under-lock``
    A call that can block indefinitely — ``join()``/``wait()``/
    ``Future.result()``/queue ``get()`` without a timeout,
    ``time.sleep``, ``urlopen`` without a timeout, socket ops,
    ``subprocess`` waits — made while holding a lock (directly, or
    inside a ``*_locked`` helper whose every call site holds one).
    This is the exact shape of an unbounded drain hang: every other
    contender of that lock stalls behind the blocked holder.

``lock-name-mismatch``
    A ``concurrency_rt.make_lock/make_rlock/make_condition`` name
    argument that does not equal the lock's static identity
    (``Class.attr`` for instance locks, ``module.var`` for module
    globals).  The runtime witness records edges under these names;
    a mismatch would silently decouple the observed graph from the
    static one and blind the ``witness-unmatched-edge`` gate.

Known model limits (documented, deliberate): identity is TYPE-level
(two instances of one class share a lock name — per-instance ordering
like router fan-out across sibling batchers is out of scope), class
names are assumed unique package-wide, and attribute types come from
constructor-call assignments (an attribute wired later by another
component is invisible).
"""

from __future__ import annotations

import ast
import dataclasses
import re
from pathlib import Path

from .concurrency import (
    _INIT_EXEMPT,
    _ModuleScan,
    _RT_FACTORIES,
    _find_cycle,
    _is_foreign,
    _lock_context_exempt,
)
from .findings import Finding

#: Python-level names that never resolve to package callables — skips
#: pointless table probes for the dominant call shapes.
_BUILTINS = frozenset((
    "len", "range", "print", "sorted", "enumerate", "zip", "min",
    "max", "sum", "abs", "round", "isinstance", "issubclass", "getattr",
    "setattr", "hasattr", "repr", "str", "int", "float", "bool",
    "list", "dict", "set", "tuple", "frozenset", "type", "iter",
    "next", "map", "filter", "any", "all", "open", "vars", "id",
    "super", "format", "hash", "callable", "delattr", "divmod",
))


def _modbase(path: str) -> str:
    p = Path(path)
    return p.parent.name if p.stem == "__init__" else p.stem


@dataclasses.dataclass
class GlobalLockGraph:
    """The composed whole-program lock model."""

    #: every global lock name ("Class.attr" / "module.var")
    names: set
    #: name -> {name}: acquisition-order edges
    edges: dict
    #: (a, b) -> (path, line) sample site
    edge_sites: dict
    #: name -> defining module path
    lock_module: dict

    @property
    def edge_pairs(self) -> set:
        return {
            (a, b) for a, outs in self.edges.items() for b in outs
        }


class _Program:
    """Cross-module symbol/type resolution over the parsed package."""

    def __init__(self, package_root: Path, trees: dict):
        self.root = Path(package_root)
        self.pkgname = self.root.name
        self.scans: dict[str, _ModuleScan] = {}
        self.trees = dict(trees)
        self.by_dotted: dict[str, str] = {}  # dotted -> path
        self.dotted_of: dict[str, str] = {}  # path -> dotted
        for path, tree in trees.items():
            self.scans[path] = _ModuleScan(path, tree)
            rel = Path(path).relative_to(self.root)
            parts = list(rel.with_suffix("").parts)
            if parts and parts[-1] == "__init__":
                parts = parts[:-1]
            dotted = ".".join(parts)
            self.by_dotted[dotted] = path
            self.dotted_of[path] = dotted
        # local import name -> ("mod", dotted) | ("sym", dotted, name)
        self.imports: dict[str, dict] = {
            path: self._collect_imports(path) for path in trees
        }
        # classname -> (path, _ClassInfo); first definition wins.
        self.classes: dict[str, tuple] = {}
        for path, scan in self.scans.items():
            for cls in scan.classes.values():
                self.classes.setdefault(cls.name, (path, cls))
        self.self_attr_types = self._collect_self_attr_types()
        self.module_instance_types = {
            path: self._instance_types(path)
            for path in trees
        }
        self.method_ret = self._collect_method_returns()
        self.ret_class = self._collect_return_classes()
        self._local_type_cache: dict = {}

    # -- imports ---------------------------------------------------------

    def _collect_imports(self, path: str) -> dict:
        table: dict = {}
        dotted = self.dotted_of[path]
        pkg_parts = dotted.split(".") if dotted else []
        if Path(path).stem != "__init__" and pkg_parts:
            pkg_parts = pkg_parts[:-1]
        for node in ast.walk(self.trees[path]):
            if isinstance(node, ast.Import):
                for alias in node.names:
                    target = self._strip_pkg(alias.name)
                    if target is None:
                        continue
                    local = alias.asname or alias.name.split(".")[0]
                    if alias.asname is None and "." in alias.name:
                        # ``import pkg.a.b`` binds ``pkg`` — the root
                        # package; attribute chains through it are out
                        # of model.
                        continue
                    if target in self.by_dotted:
                        table[local] = ("mod", target)
            elif isinstance(node, ast.ImportFrom):
                base = self._from_base(node, pkg_parts)
                if base is None:
                    continue
                for alias in node.names:
                    local = alias.asname or alias.name
                    sub = (
                        f"{base}.{alias.name}" if base else alias.name
                    )
                    if sub in self.by_dotted:
                        table[local] = ("mod", sub)
                    elif base in self.by_dotted or base == "":
                        table[local] = ("sym", base, alias.name)
        return table

    def _strip_pkg(self, dotted: str) -> str | None:
        if dotted == self.pkgname:
            return ""
        prefix = self.pkgname + "."
        if dotted.startswith(prefix):
            return dotted[len(prefix):]
        return None

    def _from_base(self, node: ast.ImportFrom, pkg_parts) -> str | None:
        if node.level == 0:
            return self._strip_pkg(node.module or "")
        parts = list(pkg_parts)
        for _ in range(node.level - 1):
            if not parts:
                return None
            parts.pop()
        if node.module:
            parts += node.module.split(".")
        return ".".join(parts)

    def resolve_symbol(self, dotted: str, name: str, depth: int = 0):
        """→ ("class", classname) | ("func", dotted, name) |
        ("mod", dotted) | None, following ``__init__`` re-exports."""
        if depth > 4:
            return None
        path = self.by_dotted.get(dotted)
        if path is None:
            return None
        scan = self.scans[path]
        if name in scan.classes:
            return ("class", name)
        if name in scan.module_units:
            return ("func", dotted, name)
        entry = self.imports[path].get(name)
        if entry is None:
            return None
        if entry[0] == "mod":
            return ("mod", entry[1])
        return self.resolve_symbol(entry[1], entry[2], depth + 1)

    # -- instance typing -------------------------------------------------

    def _constructor_class(self, path: str, call: ast.expr,
                           local_funcs: bool = False) -> str | None:
        """``ClassName(...)`` / ``mod.ClassName(...)`` → class name."""
        if not isinstance(call, ast.Call):
            return None
        fn = call.func
        scan = self.scans[path]
        if isinstance(fn, ast.Name):
            if fn.id in scan.classes:
                return fn.id
            entry = self.resolve_symbol(
                self.dotted_of[path], fn.id
            )
            if entry and entry[0] == "class":
                return entry[1]
        elif isinstance(fn, ast.Attribute) and isinstance(
            fn.value, ast.Name
        ):
            entry = self.imports[path].get(fn.value.id)
            if entry and entry[0] == "mod":
                target = self.resolve_symbol(entry[1], fn.attr)
                if target and target[0] == "class":
                    return target[1]
        return None

    def _annotation_class(self, ann) -> str | None:
        if isinstance(ann, ast.Name) and ann.id in self.classes:
            return ann.id
        if isinstance(ann, ast.Constant) and isinstance(
            ann.value, str
        ) and ann.value.strip("\"'") in self.classes:
            return ann.value.strip("\"'")
        if isinstance(ann, ast.Attribute) and ann.attr in self.classes:
            return ann.attr
        return None

    def _param_types(self, fn_node) -> dict:
        """Annotated parameters → class names (``registry:
        MetricsRegistry`` in ``_Metric.__init__``)."""
        types: dict = {}
        args = getattr(fn_node, "args", None)
        if args is None:
            return types
        for arg in (
            list(args.posonlyargs) + list(args.args)
            + list(args.kwonlyargs)
        ):
            cls = self._annotation_class(arg.annotation)
            if cls:
                types[arg.arg] = cls
        return types

    def _collect_self_attr_types(self) -> dict:
        out: dict = {}
        for path, scan in self.scans.items():
            for cls in scan.classes.values():
                types: dict = {}
                for unit in cls.units.values():
                    params = self._param_types(unit.node)
                    for node in ast.walk(unit.node):
                        if not isinstance(node, ast.Assign):
                            continue
                        made = self._constructor_class(
                            path, node.value
                        )
                        if made is None and isinstance(
                            node.value, ast.Name
                        ):
                            # ``self.registry = registry`` with an
                            # annotated parameter.
                            made = params.get(node.value.id)
                        if made is None:
                            continue
                        for tgt in node.targets:
                            if (
                                isinstance(tgt, ast.Attribute)
                                and isinstance(tgt.value, ast.Name)
                                and tgt.value.id == "self"
                            ):
                                types[tgt.attr] = made
                out.setdefault(cls.name, {}).update(types)
        return out

    def _collect_method_returns(self) -> dict:
        """(classname, method) -> classname from return annotations
        (``DocumentStore._get(...) -> _Collection``)."""
        out: dict = {}
        for _path, scan in self.scans.items():
            for cls in scan.classes.values():
                for name, unit in cls.units.items():
                    made = self._annotation_class(
                        getattr(unit.node, "returns", None)
                    )
                    if made:
                        out[(cls.name, name)] = made
        return out

    def _instance_types(self, path: str) -> dict:
        """name -> classname for ``x = ClassName(...)`` assignments
        anywhere in the module (module globals AND function locals —
        type-level overapproximation, same-name reuse merges)."""
        tree = self.trees[path]
        types: dict = {}
        for node in ast.walk(tree):
            if not isinstance(node, ast.Assign):
                continue
            made = self._constructor_class(path, node.value)
            if made is None:
                continue
            for tgt in node.targets:
                if isinstance(tgt, ast.Name):
                    types[tgt.id] = made
        return types

    def _collect_return_classes(self) -> dict:
        """(dotted, funcname) -> classname for functions returning a
        known class instance (annotation, ``return <global-instance>``
        or ``return ClassName(...)``) — the ``get_registry()``
        singleton-accessor idiom."""
        out: dict = {}
        for path, scan in self.scans.items():
            dotted = self.dotted_of[path]
            inst = self.module_instance_types[path]
            for name, unit in scan.module_units.items():
                node = unit.node
                cls = None
                returns = getattr(node, "returns", None)
                if isinstance(returns, ast.Name) and (
                    returns.id in self.classes
                ):
                    cls = returns.id
                elif isinstance(returns, ast.Constant) and isinstance(
                    returns.value, str
                ) and returns.value in self.classes:
                    cls = returns.value
                if cls is None:
                    for sub in ast.walk(node):
                        if not isinstance(sub, ast.Return):
                            continue
                        if isinstance(sub.value, ast.Name):
                            cls = inst.get(sub.value.id)
                        else:
                            cls = self._constructor_class(
                                path, sub.value
                            )
                        if cls:
                            break
                if cls:
                    out[(dotted, name)] = cls
        return out

    # -- per-unit local typing -------------------------------------------

    def local_types(self, path: str, cls_name: str | None,
                    unit) -> dict:
        """var -> classname inside one callable: annotated params,
        constructor calls, typed accessor returns (``coll =
        self._get(...)``), and self-attr aliases (``reg =
        self.registry``)."""
        key = (path, cls_name, unit.name)
        cached = self._local_type_cache.get(key)
        if cached is not None:
            return cached
        types = self._param_types(unit.node)
        dotted = self.dotted_of[path]
        for node in ast.walk(unit.node):
            if not isinstance(node, ast.Assign):
                continue
            made = self._constructor_class(path, node.value)
            value = node.value
            if made is None and isinstance(value, ast.Call):
                fn = value.func
                if (
                    isinstance(fn, ast.Attribute)
                    and isinstance(fn.value, ast.Name)
                    and fn.value.id == "self"
                    and cls_name is not None
                ):
                    made = self.method_ret.get((cls_name, fn.attr))
                elif isinstance(fn, ast.Name):
                    made = self.ret_class.get((dotted, fn.id))
                    if made is None:
                        entry = self.imports[path].get(fn.id)
                        if entry and entry[0] == "sym":
                            resolved = self.resolve_symbol(
                                entry[1], entry[2]
                            )
                            if resolved and resolved[0] == "func":
                                made = self.ret_class.get(
                                    (resolved[1], resolved[2])
                                )
                elif isinstance(fn, ast.Attribute) and isinstance(
                    fn.value, ast.Name
                ):
                    # ``reg = obs_metrics.get_registry()`` — an
                    # imported module's typed accessor.
                    entry = self.imports[path].get(fn.value.id)
                    if entry and entry[0] == "mod":
                        made = self.ret_class.get(
                            (entry[1], fn.attr)
                        )
            if made is None and isinstance(value, ast.Attribute) and (
                isinstance(value.value, ast.Name)
                and value.value.id == "self"
                and cls_name is not None
            ):
                made = self.self_attr_types.get(
                    cls_name, {}
                ).get(value.attr)
            if made is None:
                continue
            for tgt in node.targets:
                if isinstance(tgt, ast.Name):
                    types[tgt.id] = made
        self._local_type_cache[key] = types
        return types

    # -- lock-identity resolution ----------------------------------------

    def resolve_lock(self, scan: _ModuleScan, path: str,
                     cls_name: str | None, unit, key) -> str | None:
        """A per-module lock key (incl. foreign receivers) → global
        name, or None when the receiver's type is unresolvable."""
        owner, rest = key
        if owner == "<foreign>":
            var, attr = rest.split(".", 1)
            target = self.local_types(path, cls_name, unit).get(var)
        elif owner == "<foreignself>":
            attr2, attr = rest.split(".", 1)
            target = self.self_attr_types.get(
                cls_name or "", {}
            ).get(attr2)
        else:
            return _gname(scan, key)
        if target is None:
            return None
        entry = self.classes.get(target)
        if entry is None or attr not in entry[1].locks:
            return None
        return f"{target}.{attr}"

    # -- call-target resolution ------------------------------------------

    def resolve_call(self, path: str, cls_name: str | None,
                     kind: str, ref: str, method: str | None,
                     unit=None):
        """An ext_call record → callable node id
        ``(path, classname|None, unitname)`` or None."""
        dotted = self.dotted_of[path]
        if kind == "selfattr" and cls_name is not None:
            target_cls = self.self_attr_types.get(
                cls_name, {}
            ).get(ref)
            return self._class_method(target_cls, method)
        if kind == "name":
            if unit is not None:
                local = self.local_types(
                    path, cls_name, unit
                ).get(ref)
                if local is not None:
                    return self._class_method(local, method)
            entry = self.imports[path].get(ref)
            if entry is not None:
                if entry[0] == "mod":
                    mod_path = self.by_dotted.get(entry[1])
                    if mod_path and method in self.scans[
                        mod_path
                    ].module_units:
                        return (mod_path, None, method)
                    resolved = self.resolve_symbol(entry[1], method)
                    if resolved and resolved[0] == "func":
                        fpath = self.by_dotted.get(resolved[1])
                        if fpath and resolved[2] in self.scans[
                            fpath
                        ].module_units:
                            return (fpath, None, resolved[2])
                    return None
                resolved = self.resolve_symbol(entry[1], entry[2])
                if resolved and resolved[0] == "class":
                    return self._class_method(resolved[1], method)
                return None
            made = self.module_instance_types[path].get(ref)
            if made:
                return self._class_method(made, method)
            if ref in self.scans[path].classes:
                return self._class_method(ref, method)
            return None
        if kind == "callresult":
            target = None
            if ref in self.scans[path].module_units:
                target = self.ret_class.get((dotted, ref))
            else:
                entry = self.imports[path].get(ref)
                if entry and entry[0] == "sym":
                    resolved = self.resolve_symbol(
                        entry[1], entry[2]
                    )
                    if resolved and resolved[0] == "func":
                        target = self.ret_class.get(
                            (resolved[1], resolved[2])
                        )
            return self._class_method(target, method)
        if kind == "bare":
            if ref in _BUILTINS:
                return None
            if ref in self.scans[path].module_units:
                return (path, None, ref)
            entry = self.imports[path].get(ref)
            if entry and entry[0] == "sym":
                resolved = self.resolve_symbol(entry[1], entry[2])
                if resolved is None:
                    return None
                if resolved[0] == "func":
                    fpath = self.by_dotted.get(resolved[1])
                    if fpath and resolved[2] in self.scans[
                        fpath
                    ].module_units:
                        return (fpath, None, resolved[2])
                if resolved[0] == "class":
                    return self._class_method(
                        resolved[1], "__init__"
                    )
            if ref in self.scans[path].classes:
                return self._class_method(ref, "__init__")
        return None

    def _class_method(self, cls_name: str | None,
                      method: str | None):
        if cls_name is None or method is None:
            return None
        entry = self.classes.get(cls_name)
        if entry is None:
            return None
        path, info = entry
        if method in info.units:
            return (path, cls_name, method)
        return None


# -- global graph ------------------------------------------------------------


def _gname(scan: _ModuleScan, key) -> str:
    owner, attr = key
    if owner == "<module>":
        return f"{_modbase(scan.path)}.{attr}"
    return f"{owner}.{attr}"


def _build_graph(program: _Program) -> GlobalLockGraph:
    names: set = set()
    lock_module: dict = {}
    edges: dict = {}
    edge_sites: dict = {}

    # Lock inventory.
    for path, scan in program.scans.items():
        for var in scan.module_locks:
            name = _gname(scan, ("<module>", var))
            names.add(name)
            lock_module.setdefault(name, path)
        for cls in scan.classes.values():
            for attr in cls.locks:
                name = f"{cls.name}.{attr}"
                names.add(name)
                lock_module.setdefault(name, path)

    # Callable nodes + per-node direct acquires and call targets.
    nodes: dict = {}  # id -> (scan, cls|None, unit)
    for path, scan in program.scans.items():
        for name, unit in scan.module_units.items():
            nodes[(path, None, name)] = (scan, None, unit)
        for cls in scan.classes.values():
            for name, unit in cls.units.items():
                nodes[(path, cls.name, name)] = (scan, cls, unit)

    call_edges: dict = {nid: set() for nid in nodes}
    for nid, (scan, cls, unit) in nodes.items():
        path = nid[0]
        for _held, callee, _line in unit.self_calls:
            if cls is not None:
                for uname in cls.units:
                    if uname.split(".")[0] == callee:
                        call_edges[nid].add(
                            (path, cls.name, uname)
                        )
        for _held, kind, ref, method, _line in unit.ext_calls:
            target = program.resolve_call(
                path, cls.name if cls else None, kind, ref,
                method, unit=unit,
            )
            if target is not None and target in nodes:
                call_edges[nid].add(target)

    def lockname(nid, key) -> str | None:
        scan, cls, unit = nodes[nid]
        return program.resolve_lock(
            scan, nid[0], cls.name if cls else None, unit, key
        )

    # Transitive lock closure per callable (unresolvable foreign
    # receivers drop out — under-approximation the runtime witness
    # cross-check exists to catch).
    closure: dict = {}
    for nid, (scan, cls, unit) in nodes.items():
        mine = set()
        for key in unit.acquires:
            name = lockname(nid, key)
            if name is not None:
                mine.add(name)
        closure[nid] = mine
    changed = True
    while changed:
        changed = False
        for nid, callees in call_edges.items():
            mine = closure[nid]
            for callee in callees:
                extra = closure.get(callee)
                if extra and not extra <= mine:
                    mine |= extra
                    changed = True

    def add_edge(a: str | None, b: str | None, path: str,
                 line: int) -> None:
        if a is None or b is None or a == b:
            return
        edges.setdefault(a, set()).add(b)
        edge_sites.setdefault((a, b), (path, line))

    # Edge generation: direct nesting + held-across-call composition.
    for nid, (scan, cls, unit) in nodes.items():
        path = nid[0]
        for key, line, held in unit.acq_sites:
            for h in held:
                add_edge(
                    lockname(nid, h), lockname(nid, key), path, line
                )
        for held, callee, line in unit.self_calls:
            if not held or cls is None:
                continue
            for uname in cls.units:
                if uname.split(".")[0] != callee:
                    continue
                for lock in closure[(path, cls.name, uname)]:
                    for h in held:
                        add_edge(
                            lockname(nid, h), lock, path, line
                        )
        for held, kind, ref, method, line in unit.ext_calls:
            if not held:
                continue
            target = program.resolve_call(
                path, cls.name if cls else None, kind, ref,
                method, unit=unit,
            )
            if target is None or target not in closure:
                continue
            for lock in closure[target]:
                for h in held:
                    add_edge(lockname(nid, h), lock, path, line)

    return GlobalLockGraph(
        names=names, edges=edges, edge_sites=edge_sites,
        lock_module=lock_module,
    )


# -- rules -------------------------------------------------------------------


def _cycle_findings(graph: GlobalLockGraph) -> list:
    findings: list = []
    edges = {a: set(bs) for a, bs in graph.edges.items()}
    for _ in range(64):  # bounded: one edge removed per iteration
        cycle = _find_cycle(edges)
        if cycle is None:
            break
        pairs = list(zip(cycle, cycle[1:]))
        modules = {
            graph.lock_module.get(n) for n in cycle[:-1]
        }
        if len(modules) > 1:
            path, line = graph.edge_sites.get(
                pairs[0], ("<wholeprogram>", 1)
            )
            order = " -> ".join(cycle)
            findings.append(Finding(
                path, line, "lock-order-global",
                "cross-module lock-order cycle "
                f"({order}); each module is individually "
                "consistent but their composition can deadlock",
            ))
        a, b = pairs[0]
        edges.get(a, set()).discard(b)
    return findings


_QUEUEISH_RE = re.compile(r"(queue|^q$|_q$)", re.IGNORECASE)
_SOCKISH_RE = re.compile(r"(sock|conn)", re.IGNORECASE)
_FUTUREISH_RE = re.compile(r"(future|fut$)", re.IGNORECASE)


def _blocking_reason(name, n_args, kws, rkey, rname, held) -> str | None:
    """→ human reason when this call shape can block indefinitely."""
    has_timeout = "timeout" in kws
    if name == "sleep" and (rname is None or rname == "time"):
        return "time.sleep() stalls every contender of the held lock"
    if name == "join" and n_args == 0 and not has_timeout:
        return "join() without a timeout"
    if name == "wait" and n_args == 0 and not has_timeout:
        if rkey is not None and rkey in held:
            return None  # waiting on the held condition releases it
        return "wait() without a timeout"
    if (
        name == "get" and not has_timeout and n_args == 0
        and rname and _QUEUEISH_RE.search(rname)
    ):
        # Zero positional args: a dict-style ``.get(key)`` lookup on a
        # queue-named mapping is not the blocking ``Queue.get()``.
        return "queue get() without a timeout"
    if (
        name == "result" and n_args == 0 and not has_timeout
        and rname and _FUTUREISH_RE.search(rname)
    ):
        return "Future.result() without a timeout"
    if name == "urlopen" and not has_timeout and n_args < 3:
        return "urlopen() without a timeout"
    if (
        name in ("recv", "accept", "connect")
        and rname and _SOCKISH_RE.search(rname)
    ):
        return f"socket {name}() can block on the network"
    if (
        name in ("check_output", "check_call", "communicate")
        and not has_timeout
    ):
        return f"subprocess {name}() without a timeout"
    return None


def _blocking_findings(program: _Program) -> list:
    findings: list = []
    for path, scan in program.scans.items():
        scopes = [(None, scan.module_units)] + [
            (cls, cls.units) for cls in scan.classes.values()
        ]
        for cls, units in scopes:
            exempt = _lock_context_exempt(cls) if cls else set()
            for unit in units.values():
                base = unit.name.split(".")[0]
                ambient = (
                    unit.name in exempt
                    and base not in _INIT_EXEMPT
                    and cls is not None and cls.locks
                )
                for (held, name, n_args, kws, rkey, rname,
                     line) in unit.blocking_calls:
                    if not held and not ambient:
                        continue
                    reason = _blocking_reason(
                        name, n_args, kws, rkey, rname, held
                    )
                    if reason is None:
                        continue
                    held_names = [
                        program.resolve_lock(
                            scan, path,
                            cls.name if cls else None, unit, h,
                        ) or h[1]
                        for h in held
                    ] or [
                        f"{cls.name}.<caller-held "
                        f"{'/'.join(sorted(cls.locks))}>"
                    ]
                    findings.append(Finding(
                        path, line, "blocking-call-under-lock",
                        f"{unit.name} holds "
                        f"{', '.join(held_names)} across a blocking "
                        f"call: {reason} — every contender stalls "
                        "behind it (the unbounded-drain hang shape)",
                    ))
    return findings


def _lock_name_findings(program: _Program) -> list:
    findings: list = []
    for path, tree in program.trees.items():
        modbase = _modbase(path)

        class _Visitor(ast.NodeVisitor):
            def __init__(self):
                self.cls_stack: list = []
                self.fn_depth = 0

            def visit_ClassDef(self, node):
                self.cls_stack.append(node.name)
                self.generic_visit(node)
                self.cls_stack.pop()

            def _visit_fn(self, node):
                self.fn_depth += 1
                self.generic_visit(node)
                self.fn_depth -= 1

            visit_FunctionDef = _visit_fn
            visit_AsyncFunctionDef = _visit_fn

            def visit_Assign(self, node):
                given = _rt_factory_arg(node.value)
                if given is not None:
                    for tgt in node.targets:
                        expected = self._expected(tgt)
                        if expected and given != expected:
                            findings.append(Finding(
                                path, node.lineno,
                                "lock-name-mismatch",
                                f"witness lock named {given!r} but "
                                f"its static identity is "
                                f"{expected!r} — observed edges "
                                "would not line up with the "
                                "whole-program graph",
                            ))
                self.generic_visit(node)

            def _expected(self, tgt) -> str | None:
                if (
                    isinstance(tgt, ast.Attribute)
                    and isinstance(tgt.value, ast.Name)
                    and tgt.value.id == "self"
                    and self.cls_stack
                ):
                    return f"{self.cls_stack[-1]}.{tgt.attr}"
                if isinstance(tgt, ast.Name):
                    if self.fn_depth:
                        return None  # local variable — unmodeled
                    if self.cls_stack:
                        return f"{self.cls_stack[-1]}.{tgt.id}"
                    return f"{modbase}.{tgt.id}"
                return None

        _Visitor().visit(tree)
    return findings


def _rt_factory_arg(node: ast.expr) -> str | None:
    if not isinstance(node, ast.Call):
        return None
    fn = node.func
    name = (
        fn.attr if isinstance(fn, ast.Attribute)
        else fn.id if isinstance(fn, ast.Name) else None
    )
    if name in _RT_FACTORIES and node.args and isinstance(
        node.args[0], ast.Constant
    ) and isinstance(node.args[0].value, str):
        return node.args[0].value
    return None


# -- entry points ------------------------------------------------------------


def analyze_wholeprogram(
    package_root: str | Path, trees: dict
) -> tuple:
    """→ (findings, :class:`GlobalLockGraph`) over ``trees``
    (path → parsed module, as produced by the runner)."""
    program = _Program(Path(package_root), trees)
    graph = _build_graph(program)
    findings: list = []
    findings += _cycle_findings(graph)
    findings += _blocking_findings(program)
    findings += _lock_name_findings(program)
    return findings, graph


def global_graph(package_root: str | Path) -> GlobalLockGraph:
    """Parse ``package_root`` and build the global lock graph — the
    witness cross-check's static side (tests and the CLI use this
    without re-running the full rule set)."""
    package_root = Path(package_root)
    trees: dict = {}
    for path in sorted(package_root.rglob("*.py")):
        if "__pycache__" in path.parts:
            continue
        try:
            trees[str(path)] = ast.parse(path.read_text())
        except (OSError, SyntaxError):
            continue
    return _build_graph(_Program(package_root, trees))
