"""Program hazard lints — port of ``learningorchestra_tpu/analysis/
jaxlint.py``, retargeted to PyTorch.

The JAX package's rules flag the constructs that break "trace once,
dispatch forever" inside functions handed to ``jax.jit`` / ``pjit``; they
run here unchanged on any such body.  The port has no tracer: its
counterpart of a jitted body is a *program* — a function of the program
cache's closed table (``train/aot_store.py::program_function``), the
methods those run on the step path (:data:`PROGRAM_METHODS`: the fit
step, the device epoch, MoE routing, and the decode step that is
captured as a CUDA graph), and the module functions these call by name.
A host sync there stalls the card between launches, and inside a graph
capture it is an error:

``jit-host-sync`` (error)
    ``float()``/``int()``/``bool()`` on a tensor, ``.item()`` /
    ``.tolist()`` / ``.cpu()`` / ``.numpy()`` /
    ``.block_until_ready()``, ``np.asarray`` / ``np.array``,
    ``jax.device_get``, ``torch.cuda.synchronize``: each one makes the
    host wait on the device.  A transfer that is meant to be there (an
    epoch's metrics, a forward's host output) takes an inline
    suppression that says so.

``jit-mutable-global`` (error) and ``jit-shape-branch`` (warn)
    As in the JAX package, on jit-compiled bodies only: an eager program
    reads a global's current value and runs any shape.

Traced-value tracking is one-hop taint: the body's parameters are
tainted (of a program's, not ``self`` / ``cls``, the estimator or the
program object, nor those annotated as host values: ``int``, ``float``,
``bool``, ``str``, ``np.ndarray``), and any local assigned from an
expression mentioning a tainted name becomes tainted (fixpoint).
"""

from __future__ import annotations

import ast

from .findings import WARN, Finding

_JIT_NAMES = {"jit", "pjit"}
_SYNC_METHODS = {"item", "tolist", "block_until_ready", "cpu", "numpy"}
#: The decorator that registers a program function.
_PROGRAM_DECORATOR = "program_function"
#: The methods a program runs on the step path, by the end of their
#: file's path and their qualified name; a class stands for every method
#: but its constructor.
PROGRAM_METHODS = {
    "train/neural.py": ("NeuralEstimator._train_step",
                        "NeuralEstimator._device_epoch"),
    "ops/moe.py": ("route",),
    "serve/decode/pages.py": ("DecodeStepProgram",),
}
_NUMPY_MODULES = {"np", "numpy", "onp"}
_MUTABLE_LITERALS = (
    ast.Dict, ast.List, ast.Set, ast.ListComp, ast.SetComp,
    ast.DictComp,
)


def _is_jit_callable(node: ast.expr) -> bool:
    """``jax.jit`` / ``jit`` / ``pjit`` / ``partial(jax.jit, ...)``."""
    if isinstance(node, ast.Name):
        return node.id in _JIT_NAMES
    if isinstance(node, ast.Attribute):
        return node.attr in _JIT_NAMES
    if isinstance(node, ast.Call):
        fn = node.func
        is_partial = (
            isinstance(fn, ast.Name) and fn.id == "partial"
        ) or (isinstance(fn, ast.Attribute) and fn.attr == "partial")
        if is_partial and node.args:
            return _is_jit_callable(node.args[0])
        # jax.jit(fn, static_argnums=...) used as decorator factory —
        # the Call itself IS the jit application.
        return _is_jit_callable(fn)
    return False


def _collect_module_mutables(tree: ast.Module) -> set[str]:
    out: set[str] = set()
    for node in tree.body:
        targets = []
        if isinstance(node, ast.Assign):
            targets, value = node.targets, node.value
        elif isinstance(node, ast.AnnAssign) and node.value is not None:
            targets, value = [node.target], node.value
        else:
            continue
        if isinstance(value, _MUTABLE_LITERALS) or (
            isinstance(value, ast.Call)
            and isinstance(value.func, ast.Name)
            and value.func.id in ("dict", "list", "set")
        ):
            for tgt in targets:
                if isinstance(tgt, ast.Name):
                    out.add(tgt.id)
    return out


def _function_map(tree: ast.AST) -> dict[int, ast.AST]:
    """Map id(FunctionDef/Lambda) for every def in the tree."""
    return {
        id(n): n for n in ast.walk(tree)
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                          ast.Lambda))
    }


def _resolve_jitted(tree: ast.Module) -> list[ast.AST]:
    """All function nodes handed to jit/pjit: decorated defs, direct
    ``jax.jit(fn)`` / ``jax.jit(lambda ...)`` call sites with ``fn``
    a def visible in the enclosing body."""
    jitted: list[ast.AST] = []
    # Decorated defs.
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            for deco in node.decorator_list:
                if _is_jit_callable(deco):
                    jitted.append(node)
    # Call-form: jax.jit(target, ...).  Name targets resolve through
    # the enclosing lexical scopes, innermost first — the repo's
    # builders define the epoch fn a few lines above the jit call in
    # the same closure, and a same-named def in an unrelated scope
    # must NOT match.
    parents: dict[int, ast.AST] = {}
    for node in ast.walk(tree):
        for child in ast.iter_child_nodes(node):
            parents[id(child)] = node
    for node in ast.walk(tree):
        if not (isinstance(node, ast.Call)
                and _is_jit_callable(node.func)
                and node.args):
            continue
        target = node.args[0]
        if isinstance(target, ast.Lambda):
            jitted.append(target)
        elif isinstance(target, (ast.FunctionDef, ast.AsyncFunctionDef)):
            jitted.append(target)
        elif isinstance(target, ast.Name):
            scope: ast.AST | None = node
            while scope is not None:
                scope = parents.get(id(scope))
                if not isinstance(
                    scope,
                    (ast.FunctionDef, ast.AsyncFunctionDef, ast.Module),
                ):
                    continue
                hit = next(
                    (
                        item for item in scope.body
                        if isinstance(
                            item,
                            (ast.FunctionDef, ast.AsyncFunctionDef),
                        )
                        and item.name == target.id
                    ),
                    None,
                )
                if hit is not None:
                    jitted.append(hit)
                    break
    # De-dup (a decorated def can also be re-wrapped).
    seen: set[int] = set()
    out = []
    for fn in jitted:
        if id(fn) not in seen:
            seen.add(id(fn))
            out.append(fn)
    return out


def _decorator_name(deco: ast.expr) -> str | None:
    if isinstance(deco, ast.Call):
        deco = deco.func
    if isinstance(deco, ast.Name):
        return deco.id
    if isinstance(deco, ast.Attribute):
        return deco.attr
    return None


def _resolve_programs(path: str, tree: ast.Module) -> list[ast.AST]:
    """The program bodies of a module: ``program_function``-decorated
    defs, its :data:`PROGRAM_METHODS`, and (transitively) the module's
    top-level functions those call by name."""
    posix = path.replace("\\", "/")
    wanted = next((names for suffix, names in PROGRAM_METHODS.items()
                   if posix.endswith(suffix)), ())
    top = {n.name: n for n in tree.body
           if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))}
    found: list[ast.AST] = [
        n for n in ast.walk(tree)
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
        and any(_decorator_name(d) == _PROGRAM_DECORATOR
                for d in n.decorator_list)]
    found += [top[name] for name in wanted if name in top]
    for cls in tree.body:
        if not isinstance(cls, ast.ClassDef):
            continue
        for item in cls.body:
            if not isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            if f"{cls.name}.{item.name}" in wanted or (
                    cls.name in wanted and item.name != "__init__"):
                found.append(item)
    out: list[ast.AST] = []
    seen: set[int] = set()
    while found:
        fn = found.pop(0)
        if id(fn) in seen:
            continue
        seen.add(id(fn))
        out.append(fn)
        found += [top[n.func.id] for n in ast.walk(fn)
                  if isinstance(n, ast.Call) and isinstance(n.func, ast.Name)
                  and n.func.id in top]
    return out


def _param_names(fn: ast.AST) -> set[str]:
    args = fn.args
    names = [a.arg for a in args.posonlyargs + args.args
             + args.kwonlyargs]
    if args.vararg:
        names.append(args.vararg.arg)
    if args.kwarg:
        names.append(args.kwarg.arg)
    return set(names)


def _walk_own_scope(fn: ast.AST):
    """Walk ``fn``'s body, pruning nested def/lambda subtrees — their
    assignments bind in a DIFFERENT scope and must not leak into the
    outer function's analysis (``ast.walk`` has no pruning)."""
    stack = list(ast.iter_child_nodes(fn))
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            continue
        yield node
        stack.extend(ast.iter_child_nodes(node))


def _host_params(fn: ast.AST) -> set[str]:
    """A program's parameters annotated as host values (``int``,
    ``float``, ``bool``, ``str``, ``np.ndarray``): never tensors."""
    args = fn.args
    out = set()
    for a in args.posonlyargs + args.args + args.kwonlyargs:
        ann = a.annotation
        if (isinstance(ann, ast.Name)
                and ann.id in ("int", "float", "bool", "str")) or (
                isinstance(ann, ast.Attribute) and ann.attr == "ndarray"):
            out.add(a.arg)
    return out


def _tainted_names(fn: ast.AST, seeds: set[str] | None = None) -> set[str]:
    """Params (or ``seeds``) + locals assigned from expressions
    mentioning tainted names (fixpoint), in ``fn``'s own scope only."""
    tainted = _param_names(fn) if seeds is None else set(seeds)
    changed = True
    while changed:
        changed = False
        for node in _walk_own_scope(fn):
            if not isinstance(node, ast.Assign):
                continue
            value_names = {
                n.id for n in ast.walk(node.value)
                if isinstance(n, ast.Name)
            }
            if not value_names & tainted:
                continue
            for tgt in node.targets:
                for leaf in ast.walk(tgt):
                    if (
                        isinstance(leaf, ast.Name)
                        and leaf.id not in tainted
                    ):
                        tainted.add(leaf.id)
                        changed = True
    return tainted


def _base_name(node: ast.expr) -> str | None:
    """Leftmost Name of an attribute/subscript/call chain."""
    while isinstance(node, (ast.Attribute, ast.Subscript, ast.Call)):
        node = (
            node.func if isinstance(node, ast.Call) else node.value
        )
    return node.id if isinstance(node, ast.Name) else None


def _mentions_tainted(node: ast.expr, tainted: set[str]) -> bool:
    return any(
        isinstance(n, ast.Name) and n.id in tainted
        for n in ast.walk(node)
    )


def analyze_jax(path: str, tree: ast.Module) -> list[Finding]:
    findings: list[Finding] = []
    mutables = _collect_module_mutables(tree)

    for fn in _resolve_programs(path, tree):
        tainted = _tainted_names(fn, _param_names(fn) - {"self", "cls"}
                                 - _host_params(fn))
        what = f"program {fn.name}()"
        for stmt in fn.body:
            for node in ast.walk(stmt):
                if isinstance(node, ast.Call):
                    findings.extend(_host_sync(path, what, node, tainted))

    for fn in _resolve_jitted(tree):
        tainted = _tainted_names(fn)
        fn_name = getattr(fn, "name", "<lambda>")
        body_nodes = (
            fn.body if isinstance(fn.body, list) else [fn.body]
        )
        local_stores = {
            n.id for n in _walk_own_scope(fn)
            if isinstance(n, ast.Name)
            and isinstance(n.ctx, ast.Store)
        }
        for stmt in body_nodes:
            for node in ast.walk(stmt):
                findings.extend(_check_node(
                    path, fn_name, node, tainted, mutables,
                    local_stores,
                ))
    return findings


def _is_cuda_synchronize(fn: ast.expr) -> bool:
    """``torch.cuda.synchronize`` / ``cuda.synchronize``."""
    return isinstance(fn, ast.Attribute) and fn.attr == "synchronize" \
        and isinstance(fn.value, (ast.Attribute, ast.Name)) and (
            getattr(fn.value, "attr", None) == "cuda"
            or getattr(fn.value, "id", None) == "cuda")


def _host_sync(path, what, node: ast.Call, tainted) -> list[Finding]:
    """The host-sync findings of one call inside ``what`` (a jitted
    body or a program)."""
    out: list[Finding] = []
    fn = node.func
    # float(x) / int(x) / bool(x) on a traced value.
    if (
        isinstance(fn, ast.Name)
        and fn.id in ("float", "int", "bool")
        and node.args
        and _mentions_tainted(node.args[0], tainted)
    ):
        out.append(Finding(
            path, node.lineno, "jit-host-sync",
            f"{fn.id}() on a traced value inside {what} "
            "blocks dispatch on a device "
            "round-trip (ConcretizationError at best, a silent "
            "sync at worst)",
        ))
    # .item() / .tolist() / .cpu() / .numpy() / .block_until_ready()
    if (
        isinstance(fn, ast.Attribute)
        and fn.attr in _SYNC_METHODS
        and _mentions_tainted(fn.value, tainted)
    ):
        out.append(Finding(
            path, node.lineno, "jit-host-sync",
            f".{fn.attr}() inside {what} forces a "
            "host-device sync on the dispatch path",
        ))
    # np.asarray / np.array on traced values; jax.device_get.
    if isinstance(fn, ast.Attribute):
        base = _base_name(fn)
        if (
            base in _NUMPY_MODULES
            and fn.attr in ("asarray", "array")
            and node.args
            and _mentions_tainted(node.args[0], tainted)
        ):
            out.append(Finding(
                path, node.lineno, "jit-host-sync",
                f"{base}.{fn.attr}() on a traced value inside "
                f"{what} pulls the array to host "
                "memory mid-trace",
            ))
        if fn.attr == "device_get":
            out.append(Finding(
                path, node.lineno, "jit-host-sync",
                f"jax.device_get inside {what} is a "
                "synchronous device->host transfer",
            ))
    if _is_cuda_synchronize(fn):
        out.append(Finding(
            path, node.lineno, "jit-host-sync",
            f"torch.cuda.synchronize inside {what} waits for "
            "every queued kernel",
        ))
    return out


def _check_node(path, fn_name, node, tainted, mutables,
                local_stores) -> list[Finding]:
    out: list[Finding] = []
    if isinstance(node, ast.Call):
        out.extend(_host_sync(path, f"jitted {fn_name}()", node, tainted))
    elif isinstance(node, ast.Name) and isinstance(node.ctx, ast.Load):
        if node.id in mutables and node.id not in local_stores \
                and node.id not in tainted:
            out.append(Finding(
                path, node.lineno, "jit-mutable-global",
                f"jitted {fn_name}() reads module-level mutable "
                f"{node.id!r}: its value is captured at trace time — "
                "later mutations never reach the cached executable",
            ))
    elif isinstance(node, (ast.If, ast.While)):
        test = node.test
        shapeish = any(
            (isinstance(n, ast.Attribute) and n.attr in
             ("shape", "ndim", "size")
             and _mentions_tainted(n.value, tainted))
            or (isinstance(n, ast.Call)
                and isinstance(n.func, ast.Name)
                and n.func.id == "len"
                and n.args
                and _mentions_tainted(n.args[0], tainted))
            for n in ast.walk(test)
        )
        if shapeish:
            out.append(Finding(
                path, node.lineno, "jit-shape-branch",
                f"Python branch on a traced argument's shape inside "
                f"jitted {fn_name}() retraces per shape class "
                "(deliberate bucketing should suppress this)",
                severity=WARN,
            ))
    return out
