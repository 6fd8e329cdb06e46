"""Lock-discipline & shared-state checker.

A copy of ``learningorchestra_tpu/analysis/concurrency.py``: the port imports
nothing of the JAX package.

Models the repo's concurrency idioms — ``threading.Lock/RLock/
Condition`` attributes acquired with ``with self._lock:``, module-level
registry locks, daemon threads spawned via ``threading.Thread(
target=self._loop)`` — and enforces two invariants statically:

``lock-order``
    Within one module, the union of every method's lock-acquisition
    nestings (direct ``with`` nesting plus self-call propagation:
    holding A while calling ``self.m()`` which acquires B is an A→B
    edge) must form a DAG.  A cycle is deadlock potential: two threads
    entering the cycle from different methods can each hold the lock
    the other needs.

``lock-self-deadlock``
    Acquiring a non-reentrant ``threading.Lock`` that is already held
    on the same path (lexically nested ``with``, or a self-call whose
    callee re-acquires) deadlocks unconditionally the moment the path
    executes.

``unlocked-shared-write``
    An instance attribute written under a lock in one method and
    written bare in another is shared mutable state with inconsistent
    locking — exactly the torn-state class of bug the job engine /
    autoscaler / batcher daemons can hit.  Private helpers whose every
    intraclass call site holds a lock are exempt (the caller provides
    the critical section); ``__init__``-family methods are exempt
    (no concurrent alias exists yet); thread-target methods never are.
"""

from __future__ import annotations

import ast
import dataclasses

from .findings import Finding

_LOCK_FACTORIES = {"Lock", "RLock", "Condition"}
#: The witnessed factories (concurrency_rt): first-party locks are
#: constructed through these, carrying their static identity as the
#: name argument (the whole-program pass checks the congruence).
_RT_FACTORIES = {
    "make_lock": "Lock",
    "make_rlock": "RLock",
    "make_condition": "Condition",
}
_REENTRANT = {"RLock"}
_INIT_EXEMPT = {
    "__init__", "__new__", "__post_init__", "__init_subclass__",
    "__set_name__",
}


def _lock_factory_name(node: ast.expr) -> str | None:
    """``threading.Lock()`` / ``Lock()`` / ``make_lock("...")`` →
    ``"Lock"`` (else None)."""
    if not isinstance(node, ast.Call):
        return None
    fn = node.func
    name = (
        fn.attr if isinstance(fn, ast.Attribute)
        else fn.id if isinstance(fn, ast.Name) else None
    )
    if name in _RT_FACTORIES and node.args:
        return _RT_FACTORIES[name]
    if node.args or node.keywords:
        return None
    if name in _LOCK_FACTORIES:
        return name
    return None


def _foreign_key(expr: ast.expr):
    """``coll.lock`` / ``self.registry.lock`` → a foreign-lock key
    (("<foreign>", "var.attr") / ("<foreignself>", "attr2.attr")), or
    None.  Per-module rules treat these as opaque held context; the
    whole-program pass resolves the receiver's type."""
    if not isinstance(expr, ast.Attribute):
        return None
    attr = expr.attr
    if not ("lock" in attr.lower() or attr in ("_cv", "_cond")):
        return None
    base = expr.value
    if isinstance(base, ast.Name) and base.id != "self":
        return ("<foreign>", f"{base.id}.{attr}")
    if (
        isinstance(base, ast.Attribute)
        and isinstance(base.value, ast.Name)
        and base.value.id == "self"
    ):
        return ("<foreignself>", f"{base.attr}.{attr}")
    return None


def _is_foreign(key) -> bool:
    return key[0] in ("<foreign>", "<foreignself>")


@dataclasses.dataclass
class _Unit:
    """One analyzed callable: a method, module function, or nested def
    (a closure runs on its own stack — held locks don't flow in)."""

    name: str
    node: ast.AST
    cls: str | None
    acquires: set = dataclasses.field(default_factory=set)
    # (held_frozenset, callee_method_name, line)
    self_calls: list = dataclasses.field(default_factory=list)
    # (attr, line, held_frozenset)
    writes: list = dataclasses.field(default_factory=list)
    # lock_key -> [(line, held_before)]
    acq_sites: list = dataclasses.field(default_factory=list)
    # Cross-object calls, for the whole-program pass
    # (analysis/wholeprogram.py):
    # (held_tuple, kind, ref, method, line) with kind in
    # {"selfattr", "name", "callresult", "bare"}.
    ext_calls: list = dataclasses.field(default_factory=list)
    # Potentially-blocking calls made while holding locks:
    # (held_tuple, fn_name, n_args, kw_names, receiver_lock_key,
    #  receiver_name, line).
    blocking_calls: list = dataclasses.field(default_factory=list)


class _ClassInfo:
    def __init__(self, name: str):
        self.name = name
        self.locks: dict[str, str] = {}  # attr -> factory
        self.units: dict[str, _Unit] = {}
        self.thread_targets: set[str] = set()


class _ModuleScan:
    def __init__(self, path: str, tree: ast.Module):
        self.path = path
        self.module_locks: dict[str, str] = {}
        self.classes: dict[str, _ClassInfo] = {}
        self.module_units: dict[str, _Unit] = {}
        self._collect(tree)

    # -- collection ------------------------------------------------------

    def _collect(self, tree: ast.Module) -> None:
        for node in tree.body:
            if isinstance(node, ast.Assign):
                factory = _lock_factory_name(node.value)
                if factory:
                    for tgt in node.targets:
                        if isinstance(tgt, ast.Name):
                            self.module_locks[tgt.id] = factory
            elif isinstance(node, ast.ClassDef):
                self._collect_class(node)
            elif isinstance(
                node, (ast.FunctionDef, ast.AsyncFunctionDef)
            ):
                unit = _Unit(node.name, node, None)
                self.module_units[node.name] = unit
        # Lock attrs must be known before walking bodies, so walk in a
        # second pass.
        for cls in self.classes.values():
            for unit in list(cls.units.values()):
                _BodyWalker(self, cls, unit).walk()
        for unit in list(self.module_units.values()):
            _BodyWalker(self, None, unit).walk()

    def _collect_class(self, node: ast.ClassDef) -> None:
        info = _ClassInfo(node.name)
        for item in node.body:
            if isinstance(item, ast.Assign):
                factory = _lock_factory_name(item.value)
                if factory:
                    for tgt in item.targets:
                        if isinstance(tgt, ast.Name):
                            info.locks[tgt.id] = factory
            elif isinstance(
                item, (ast.FunctionDef, ast.AsyncFunctionDef)
            ):
                info.units[item.name] = _Unit(
                    item.name, item, node.name
                )
                # self.X = threading.Lock() assignments anywhere.
                for sub in ast.walk(item):
                    if isinstance(sub, ast.Assign):
                        factory = _lock_factory_name(sub.value)
                        if factory:
                            for tgt in sub.targets:
                                if (
                                    isinstance(tgt, ast.Attribute)
                                    and isinstance(
                                        tgt.value, ast.Name
                                    )
                                    and tgt.value.id == "self"
                                ):
                                    info.locks[tgt.attr] = factory
        self.classes[node.name] = info

    # -- lock identity ---------------------------------------------------

    def lock_key(self, cls: _ClassInfo | None, expr: ast.expr):
        """``self._lock`` / module ``_LOCK`` → a stable key, or None."""
        if (
            cls is not None
            and isinstance(expr, ast.Attribute)
            and isinstance(expr.value, ast.Name)
            and expr.value.id == "self"
            and expr.attr in cls.locks
        ):
            return (cls.name, expr.attr)
        if isinstance(expr, ast.Name) and expr.id in self.module_locks:
            return ("<module>", expr.id)
        return None

    def is_reentrant(self, key) -> bool:
        owner, name = key
        if _is_foreign(key):
            # Unknown type → unknown reentrancy: treat as reentrant so
            # no per-module self-deadlock fires on a foreign key.
            return True
        if owner == "<module>":
            return self.module_locks.get(name) in _REENTRANT
        cls = self.classes.get(owner)
        return bool(cls) and cls.locks.get(name) in _REENTRANT


class _BodyWalker:
    """Walks one unit's statements tracking the held-lock stack."""

    def __init__(self, scan: _ModuleScan, cls, unit: _Unit):
        self.scan = scan
        self.cls = cls
        self.unit = unit

    def walk(self) -> None:
        body = getattr(self.unit.node, "body", [])
        self._walk_stmts(body, [])

    def _walk_stmts(self, stmts, held: list) -> None:
        for stmt in stmts:
            self._walk_stmt(stmt, held)

    def _walk_stmt(self, stmt: ast.stmt, held: list) -> None:
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
            # Closure: runs later, on its own stack.  Analyze as a
            # sibling unit (nested name) with an empty held set.
            nested = _Unit(
                f"{self.unit.name}.<{stmt.name}>", stmt,
                self.cls.name if self.cls else None,
            )
            owner = (
                self.cls.units if self.cls else self.scan.module_units
            )
            owner[nested.name] = nested
            _BodyWalker(self.scan, self.cls, nested).walk()
            return
        if isinstance(stmt, ast.ClassDef):
            return  # method-local classes: out of scope
        if isinstance(stmt, (ast.With, ast.AsyncWith)):
            acquired_here = []
            for item in stmt.items:
                key = self.scan.lock_key(self.cls, item.context_expr)
                if key is None:
                    # ``with coll.lock:`` / ``with self.registry.lock:``
                    # — ANOTHER object's lock.  Identity needs cross-
                    # module typing, so the per-module rules skip these
                    # keys; the whole-program pass resolves them.
                    key = _foreign_key(item.context_expr)
                if key is not None:
                    # ``with self._a, self._b:`` acquires in item
                    # order — earlier items count as held for later
                    # ones.
                    self.unit.acquires.add(key)
                    self.unit.acq_sites.append(
                        (key, stmt.lineno, tuple(held + acquired_here))
                    )
                    acquired_here.append(key)
                else:
                    self._visit_subtree(item.context_expr, held)
            self._walk_stmts(stmt.body, held + acquired_here)
            return
        if isinstance(stmt, (ast.If, ast.While)):
            self._visit_subtree(stmt.test, held)
            self._walk_stmts(stmt.body, held)
            self._walk_stmts(stmt.orelse, held)
            return
        if isinstance(stmt, (ast.For, ast.AsyncFor)):
            self._visit_subtree(stmt.iter, held)
            self._walk_stmts(stmt.body, held)
            self._walk_stmts(stmt.orelse, held)
            return
        if isinstance(stmt, ast.Try):
            self._walk_stmts(stmt.body, held)
            for handler in stmt.handlers:
                self._walk_stmts(handler.body, held)
            self._walk_stmts(stmt.orelse, held)
            self._walk_stmts(stmt.finalbody, held)
            return
        if hasattr(ast, "Match") and isinstance(stmt, ast.Match):
            self._visit_subtree(stmt.subject, held)
            for case in stmt.cases:
                self._walk_stmts(case.body, held)
            return
        # Simple statement: visit every expression node underneath.
        self._visit_subtree(stmt, held)

    def _visit_subtree(self, node: ast.AST, held: list) -> None:
        for sub in ast.walk(node):
            if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue  # lambdas stay; real defs handled above
            self._visit_expr(sub, held)

    def _visit_expr(self, node: ast.AST, held: list) -> None:
        if isinstance(node, (ast.With, ast.AsyncWith, ast.FunctionDef,
                             ast.AsyncFunctionDef)):
            return  # handled structurally
        if isinstance(node, ast.Call):
            self._visit_call(node, held)
        elif isinstance(node, (ast.Assign, ast.AugAssign, ast.Delete)):
            targets = (
                node.targets if isinstance(node, ast.Assign)
                else [node.target] if isinstance(node, ast.AugAssign)
                else node.targets
            )
            for tgt in self._flatten_targets(targets):
                if (
                    isinstance(tgt, ast.Attribute)
                    and isinstance(tgt.value, ast.Name)
                    and tgt.value.id == "self"
                ):
                    self.unit.writes.append(
                        (tgt.attr, node.lineno, tuple(held))
                    )

    def _note_blocking(self, node: ast.Call, held: list) -> None:
        """Record a possibly-indefinitely-blocking call made while
        holding locks; the whole-program pass decides which shapes
        (no timeout argument, receiver kind) are findings."""
        fn = node.func
        name = (
            fn.attr if isinstance(fn, ast.Attribute)
            else fn.id if isinstance(fn, ast.Name) else None
        )
        if name not in self._BLOCKING_NAMES:
            return
        receiver_key = receiver_name = None
        if isinstance(fn, ast.Attribute):
            receiver_key = self.scan.lock_key(self.cls, fn.value)
            base = fn.value
            if isinstance(base, ast.Name):
                receiver_name = base.id
            elif isinstance(base, ast.Attribute):
                receiver_name = base.attr
        self.unit.blocking_calls.append((
            tuple(held), name, len(node.args),
            tuple(kw.arg for kw in node.keywords if kw.arg),
            receiver_key, receiver_name, node.lineno,
        ))

    @staticmethod
    def _flatten_targets(targets):
        """Unpack tuple/list/starred assignment targets —
        ``a, self._x = ...`` writes ``self._x`` too."""
        out = []
        stack = list(targets)
        while stack:
            tgt = stack.pop()
            if isinstance(tgt, (ast.Tuple, ast.List)):
                stack.extend(tgt.elts)
            elif isinstance(tgt, ast.Starred):
                stack.append(tgt.value)
            else:
                out.append(tgt)
        return out

    #: Callable names whose no-timeout forms can block indefinitely —
    #: recorded (with the held set) for ``blocking-call-under-lock``
    #: (analysis/wholeprogram.py evaluates the shapes).
    _BLOCKING_NAMES = frozenset({
        "join", "sleep", "wait", "get", "result", "urlopen",
        "recv", "accept", "connect", "check_output", "check_call",
        "communicate",
    })

    def _visit_call(self, node: ast.Call, held: list) -> None:
        fn = node.func
        # self.method(...) while holding locks.
        if (
            isinstance(fn, ast.Attribute)
            and isinstance(fn.value, ast.Name)
            and fn.value.id == "self"
        ):
            self.unit.self_calls.append(
                (tuple(held), fn.attr, node.lineno)
            )
        # Cross-object calls, for the whole-program pass: what this
        # unit invokes on OTHER objects/modules (and with which locks
        # held) is the raw material for cross-module lock-order
        # composition.
        elif isinstance(fn, ast.Attribute):
            base = fn.value
            if (
                isinstance(base, ast.Attribute)
                and isinstance(base.value, ast.Name)
                and base.value.id == "self"
            ):
                self.unit.ext_calls.append(
                    (tuple(held), "selfattr", base.attr, fn.attr,
                     node.lineno)
                )
            elif isinstance(base, ast.Name) and base.id != "self":
                self.unit.ext_calls.append(
                    (tuple(held), "name", base.id, fn.attr,
                     node.lineno)
                )
            elif isinstance(base, ast.Call):
                inner = base.func
                ref = (
                    inner.attr if isinstance(inner, ast.Attribute)
                    else inner.id if isinstance(inner, ast.Name)
                    else None
                )
                if ref:
                    self.unit.ext_calls.append(
                        (tuple(held), "callresult", ref, fn.attr,
                         node.lineno)
                    )
        elif isinstance(fn, ast.Name):
            self.unit.ext_calls.append(
                (tuple(held), "bare", fn.id, None, node.lineno)
            )
        # Recorded even with nothing held: a ``*_locked`` helper runs
        # under its CALLER's lock (the whole-program pass applies the
        # ambient-lock context when evaluating shapes).
        self._note_blocking(node, held)
        # threading.Thread(target=self.m) / Thread(target=fn)
        is_thread = (
            isinstance(fn, ast.Attribute) and fn.attr == "Thread"
        ) or (isinstance(fn, ast.Name) and fn.id == "Thread")
        if is_thread:
            for kw in node.keywords:
                if kw.arg != "target":
                    continue
                tgt = kw.value
                if (
                    isinstance(tgt, ast.Attribute)
                    and isinstance(tgt.value, ast.Name)
                    and tgt.value.id == "self"
                    and self.cls is not None
                ):
                    self.cls.thread_targets.add(tgt.attr)
                elif isinstance(tgt, ast.Lambda):
                    # Thread(target=lambda: self.serve(...)) — every
                    # self-method the lambda calls runs on the new
                    # thread.
                    for sub in ast.walk(tgt.body):
                        if (
                            isinstance(sub, ast.Call)
                            and isinstance(sub.func, ast.Attribute)
                            and isinstance(sub.func.value, ast.Name)
                            and sub.func.value.id == "self"
                            and self.cls is not None
                        ):
                            self.cls.thread_targets.add(sub.func.attr)
                elif isinstance(tgt, ast.Name) and self.cls is not None:
                    # Thread(target=local_closure): the nested unit is
                    # registered as "<enclosing>.<name>".
                    self.cls.thread_targets.add(
                        f"{self.unit.name}.<{tgt.id}>"
                    )


# -- rule evaluation ---------------------------------------------------------


def _closure_acquires(units: dict) -> dict:
    """Fixpoint of acquires over intraclass self-calls."""
    result = {name: set(u.acquires) for name, u in units.items()}
    changed = True
    while changed:
        changed = False
        for name, unit in units.items():
            for _held, callee, _line in unit.self_calls:
                extra = result.get(callee)
                if extra and not extra <= result[name]:
                    result[name] |= extra
                    changed = True
    return result


def _find_cycle(edges: dict) -> list | None:
    """→ one cycle as a node list, or None.  ``edges``: node -> {node}."""
    WHITE, GRAY, BLACK = 0, 1, 2
    color = {n: WHITE for n in edges}
    stack: list = []

    def visit(n) -> list | None:
        color[n] = GRAY
        stack.append(n)
        for nxt in sorted(edges.get(n, ())):
            if color.get(nxt, WHITE) == GRAY:
                return stack[stack.index(nxt):] + [nxt]
            if color.get(nxt, WHITE) == WHITE and nxt in edges:
                found = visit(nxt)
                if found:
                    return found
        stack.pop()
        color[n] = BLACK
        return None

    for node in sorted(edges):
        if color[node] == WHITE:
            found = visit(node)
            if found:
                return found
    return None


def _key_str(key) -> str:
    owner, name = key
    return (
        name if owner == "<module>" or _is_foreign(key)
        else f"{owner}.{name}"
    )


def analyze_concurrency(path: str, tree: ast.Module) -> list[Finding]:
    scan = _ModuleScan(path, tree)
    findings: list[Finding] = []

    # One order graph per module: module-level registry locks are
    # shared across classes, so edges from every unit combine.
    edges: dict = {}
    edge_sites: dict = {}

    scopes: list[tuple[_ClassInfo | None, dict]] = [
        (None, scan.module_units)
    ]
    scopes += [(cls, cls.units) for cls in scan.classes.values()]

    for cls, units in scopes:
        acq_closure = _closure_acquires(units)
        for unit in units.values():
            # Direct nesting: acquiring `key` while holding `held`.
            # Foreign keys (another object's lock) are opaque here —
            # the whole-program pass resolves and orders them.
            for key, line, held in unit.acq_sites:
                if _is_foreign(key):
                    continue
                for h in held:
                    if _is_foreign(h):
                        continue
                    if h == key:
                        if not scan.is_reentrant(key):
                            findings.append(Finding(
                                path, line, "lock-self-deadlock",
                                f"{unit.name} re-acquires non-"
                                f"reentrant lock {_key_str(key)} "
                                "already held on this path",
                            ))
                        continue
                    edges.setdefault(h, set()).add(key)
                    edge_sites.setdefault((h, key), (path, line))
            # Self-call propagation.
            for held, callee, line in unit.self_calls:
                if not held:
                    continue
                callee_locks = acq_closure.get(callee) or set()
                for key in callee_locks:
                    if _is_foreign(key):
                        continue
                    for h in held:
                        if _is_foreign(h):
                            continue
                        if h == key:
                            if not scan.is_reentrant(key):
                                findings.append(Finding(
                                    path, line, "lock-self-deadlock",
                                    f"{unit.name} holds "
                                    f"{_key_str(key)} and calls "
                                    f"self.{callee}() which "
                                    "re-acquires it",
                                ))
                            continue
                        edges.setdefault(h, set()).add(key)
                        edge_sites.setdefault((h, key), (path, line))

    cycle = _find_cycle(edges)
    if cycle:
        pairs = list(zip(cycle, cycle[1:]))
        where = edge_sites[pairs[0]]
        order = " -> ".join(_key_str(k) for k in cycle)
        findings.append(Finding(
            where[0], where[1], "lock-order",
            f"inconsistent lock acquisition order (cycle {order}); "
            "two threads entering from different methods can "
            "deadlock",
        ))

    # unlocked-shared-write per class.
    for cls in scan.classes.values():
        findings.extend(_shared_write_findings(path, cls))
    return findings


def _thread_reachable(cls: _ClassInfo) -> set[str]:
    """Unit names reachable from a thread entry point via self-calls."""
    reach = {
        name for name in cls.units
        if name in cls.thread_targets
        or name.split(".")[0] in cls.thread_targets
    }
    changed = True
    while changed:
        changed = False
        for unit in cls.units.values():
            if unit.name not in reach:
                continue
            for _held, callee, _line in unit.self_calls:
                for name in cls.units:
                    if (
                        name not in reach
                        and name.split(".")[0] == callee
                    ):
                        reach.add(name)
                        changed = True
    return reach


def _lock_context_exempt(cls: _ClassInfo) -> set[str]:
    """Private helpers whose every intraclass call site already holds
    a lock (directly, from an ``__init__``-family method where no
    concurrent alias exists yet, or from another exempt helper) — the
    caller provides the critical section.  The repo's ``*_locked``
    naming convention marks exactly these."""
    call_sites: dict[str, list] = {}
    for unit in cls.units.values():
        for held, callee, _line in unit.self_calls:
            call_sites.setdefault(callee, []).append(
                (unit.name, held)
            )
    exempt: set[str] = set()
    changed = True
    while changed:
        changed = False
        for name in cls.units:
            base = name.split(".")[0]
            if (
                name in exempt
                or name in cls.thread_targets
                or base in cls.thread_targets
            ):
                # A thread ENTRY is invoked bare by the runtime — no
                # call site provides a lock.  (Merely being reachable
                # from a thread is fine: the locked call site still
                # guards the helper.)
                continue
            if not base.startswith("_") or base.startswith("__"):
                continue
            sites = call_sites.get(base) or call_sites.get(name)
            if not sites:
                continue
            if all(
                held
                or caller.split(".")[0] in _INIT_EXEMPT
                or caller in exempt
                for caller, held in sites
            ):
                exempt.add(name)
                changed = True
    return exempt


def _shared_write_findings(path: str, cls: _ClassInfo) -> list[Finding]:
    findings: list[Finding] = []
    locked_attrs: set[str] = set()
    for unit in cls.units.values():
        for attr, _line, held in unit.writes:
            if held:
                locked_attrs.add(attr)
    reach = _thread_reachable(cls)
    exempt = _lock_context_exempt(cls)

    def unit_writes(pred):
        for unit in cls.units.values():
            base = unit.name.split(".")[0]
            if base in _INIT_EXEMPT or unit.name in exempt:
                continue
            for attr, line, held in unit.writes:
                if not held and pred(unit, attr):
                    yield unit, attr, line

    # Variant 1: attribute locked in one method, bare in another.
    if locked_attrs:
        for unit, attr, line in unit_writes(
            lambda u, a: a in locked_attrs
        ):
            findings.append(Finding(
                path, line, "unlocked-shared-write",
                f"{cls.name}.{unit.name} writes self.{attr} without "
                "a lock, but other methods guard the same attribute "
                f"with {'/'.join(sorted(cls.locks)) or 'a lock'} — "
                "inconsistent locking on shared state",
            ))
    # Variant 2: attribute written bare from two different methods,
    # at least one running on a spawned thread — unguarded
    # cross-thread shared state, even if no lock ever covers it (the
    # worse case: nobody thought about it).
    if reach:
        writers: dict[str, set[str]] = {}
        thread_written: set[str] = set()
        for unit in cls.units.values():
            base = unit.name.split(".")[0]
            if base in _INIT_EXEMPT or unit.name in exempt:
                continue
            for attr, _line, held in unit.writes:
                if held or attr in locked_attrs:
                    continue
                writers.setdefault(attr, set()).add(base)
                if unit.name in reach:
                    thread_written.add(attr)
        racy = {
            attr for attr, who in writers.items()
            if len(who) >= 2 and attr in thread_written
        }
        for unit, attr, line in unit_writes(lambda u, a: a in racy):
            findings.append(Finding(
                path, line, "unlocked-shared-write",
                f"{cls.name}.{unit.name} writes self.{attr} with no "
                "lock while a spawned thread also writes it "
                f"(thread entries: {', '.join(sorted(cls.thread_targets))}) "
                "— unguarded cross-thread shared state",
            ))
    return findings
