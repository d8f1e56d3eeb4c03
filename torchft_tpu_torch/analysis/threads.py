"""Thread-safety checker: unlocked read-modify-write of cross-thread state.

Per class, the checker builds a *thread-entry graph*:

- entry points are every ``threading.Thread(target=self.X)`` spawn and
  every executor ``submit(self.X, ...)`` (lambdas passed to either
  contribute the ``self`` methods they call) — RPC handler methods are
  covered transitively, because the accept loop that dispatches them is
  itself a ``Thread`` target;
- the implicit *caller* context covers the public surface (public methods,
  ``__init__``/dunders) and everything they reach via ``self.*()`` calls;
- each entry's transitive ``self.*()`` call closure defines which methods
  run in which context.

An attribute of ``self`` that is *mutated* from two or more distinct
contexts is shared mutable state; every mutation site of it that is a
**read-modify-write** (``+=`` / ``x = f(x)`` / container mutation /
item assignment) and not lexically under a ``with <lock>`` is flagged —
exactly the non-atomic ``_inflight_ops +=`` class the PR-6 review caught
by hand.

Escape hatches the checker understands (document WHY at the use site):

- ``with self._lock:`` (any name containing ``lock``/``mutex``, or the
  ``_mu``/``_cv``/``_cond`` suffixes — condition variables are locks);
- a method whose name ends in ``_locked`` asserts its callers hold the
  lock, so its sites are treated as locked;
- ``# ftlint: ignore[thread-safety] — <reason>`` on the site's line.
"""

from __future__ import annotations

import ast
import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

from torchft_tpu_torch.analysis.core import Finding, iter_py_files

CHECKER = "thread-safety"

# Method calls that mutate a builtin container in place.  Each is
# individually GIL-atomic on builtins, but paired with ANY other access
# from a second thread they form the check-then-act races this checker
# exists for (and on non-builtin types not even the single call is safe).
_CONTAINER_MUTATORS = frozenset(
    {
        "append", "extend", "insert", "remove", "pop", "popitem", "clear",
        "update", "setdefault", "add", "discard", "appendleft", "popleft",
        "sort", "reverse",
    }
)

# Read-modify-write kinds that get flagged (plain ``self.x = <const>``
# rebinds count toward the cross-thread spread but are not themselves
# flagged — a single STORE_ATTR is atomic).
_RMW_KINDS = frozenset({"augassign", "rmw-assign", "container", "item-assign"})


def _is_lockish(name: str) -> bool:
    n = name.lower().strip("_")
    return (
        "lock" in n
        or "mutex" in n
        or n in ("mu", "cv", "cond")
        or n.endswith("_mu")
        or n.endswith("_cv")
        or n.endswith("_cond")
        or n.startswith("cond")
    )


def _terminal_names(node: ast.AST) -> List[str]:
    out = []
    for sub in ast.walk(node):
        if isinstance(sub, ast.Attribute):
            out.append(sub.attr)
        elif isinstance(sub, ast.Name):
            out.append(sub.id)
    return out


def _is_lock_context(item: ast.withitem) -> bool:
    return any(_is_lockish(n) for n in _terminal_names(item.context_expr))


def _self_attr(node: ast.AST) -> Optional[str]:
    """``self.X`` -> ``X`` (one level only — ``self.a.b`` returns None so
    mutating a sub-object isn't misattributed to the holder)."""
    if (
        isinstance(node, ast.Attribute)
        and isinstance(node.value, ast.Name)
        and node.value.id == "self"
    ):
        return node.attr
    return None


def _reads_self_attr(expr: ast.AST, attr: str) -> bool:
    for sub in ast.walk(expr):
        if _self_attr(sub) == attr:
            return True
    return False


@dataclass
class _Mutation:
    attr: str
    line: int
    kind: str  # augassign | rmw-assign | container | item-assign | assign
    locked: bool


@dataclass
class _MethodInfo:
    name: str
    self_calls: Set[str] = field(default_factory=set)
    mutations: List[_Mutation] = field(default_factory=list)
    spawn_targets: List[str] = field(default_factory=list)  # entry methods


class _MethodVisitor(ast.NodeVisitor):
    """One pass over a method body: ``self.*()`` call edges, spawn/submit
    targets, and mutation sites with their lexical lock depth.

    Nested ``def``s are collected as pseudo-methods (``parent.nested``) with
    their own mutation/call info: they close over the same ``self`` but run
    whenever they are *called* — typically as a closure ``Thread`` target,
    the dominant spawn idiom in this codebase — so their sites must not
    inherit the parent's context or its lexical lock depth."""

    def __init__(
        self, info: _MethodInfo, extras: Optional[Dict[str, "_MethodInfo"]] = None
    ) -> None:
        self.info = info
        self.extras: Dict[str, _MethodInfo] = extras if extras is not None else {}
        self._nested: Dict[str, str] = {}  # local def name -> qualified name
        self._lock_depth = 0

    # -- nested defs (closure thread targets) --------------------------------

    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        self._visit_nested(node)

    def visit_AsyncFunctionDef(self, node: ast.AsyncFunctionDef) -> None:
        self._visit_nested(node)

    def _visit_nested(self, node) -> None:
        qual = f"{self.info.name}.{node.name}"
        child = _MethodInfo(name=qual)
        visitor = _MethodVisitor(child, self.extras)
        for stmt in node.body:
            visitor.visit(stmt)
        self.extras[qual] = child
        self._nested[node.name] = qual

    # -- lock scopes --------------------------------------------------------

    def visit_With(self, node: ast.With) -> None:
        self._visit_with(node)

    def visit_AsyncWith(self, node: ast.AsyncWith) -> None:
        self._visit_with(node)

    def _visit_with(self, node) -> None:
        locked = any(_is_lock_context(item) for item in node.items)
        for item in node.items:
            self.visit(item)
        if locked:
            self._lock_depth += 1
        for stmt in node.body:
            self.visit(stmt)
        if locked:
            self._lock_depth -= 1

    # -- call edges + spawn targets -----------------------------------------

    def _callable_targets(self, node: ast.AST) -> List[str]:
        """Methods of self a callable expression would run: ``self.X``, a
        nested closure ``def``, ``lambda: self.X(...)``,
        ``functools.partial(self.X, ...)``."""
        if isinstance(node, ast.Name) and node.id in self._nested:
            return [self._nested[node.id]]
        if isinstance(node, ast.Lambda):
            out = []
            for sub in ast.walk(node.body):
                if isinstance(sub, ast.Call):
                    name = _self_attr(sub.func)
                    if name:
                        out.append(name)
            return out
        if isinstance(node, ast.Call):  # functools.partial(self.X, ...)
            fn = node.func
            if isinstance(fn, ast.Attribute) and fn.attr == "partial" or (
                isinstance(fn, ast.Name) and fn.id == "partial"
            ):
                if node.args:
                    name = _self_attr(node.args[0])
                    return [name] if name else []
            return []
        name = _self_attr(node)
        return [name] if name else []

    def visit_Call(self, node: ast.Call) -> None:
        func = node.func
        # self.X(...) call edge
        name = _self_attr(func)
        if name:
            self.info.self_calls.add(name)
        # direct call of a nested def: its sites run in THIS context too
        if isinstance(func, ast.Name) and func.id in self._nested:
            self.info.self_calls.add(self._nested[func.id])
        # threading.Thread(target=...)
        if isinstance(func, ast.Attribute) and func.attr == "Thread" or (
            isinstance(func, ast.Name) and func.id == "Thread"
        ):
            for kw in node.keywords:
                if kw.arg == "target":
                    self.info.spawn_targets.extend(
                        self._callable_targets(kw.value)
                    )
        # executor.submit(self.X, ...)
        if isinstance(func, ast.Attribute) and func.attr == "submit" and node.args:
            self.info.spawn_targets.extend(self._callable_targets(node.args[0]))
        # container mutation in ANY expression position (statement-level
        # `self.d.pop(k)` and value-level `x = self.d.pop(k)` alike)
        if isinstance(func, ast.Attribute) and func.attr in _CONTAINER_MUTATORS:
            self._add(_self_attr(func.value), node.lineno, "container")
        self.generic_visit(node)

    # -- mutation sites ------------------------------------------------------

    def _add(self, attr: Optional[str], line: int, kind: str) -> None:
        if attr:
            self.info.mutations.append(
                _Mutation(attr, line, kind, self._lock_depth > 0)
            )

    def visit_AugAssign(self, node: ast.AugAssign) -> None:
        target = node.target
        attr = _self_attr(target)
        if attr is None and isinstance(target, ast.Subscript):
            attr = _self_attr(target.value)
        self._add(attr, node.lineno, "augassign")
        self.generic_visit(node)

    def visit_Assign(self, node: ast.Assign) -> None:
        for target in node.targets:
            for el in (
                target.elts if isinstance(target, (ast.Tuple, ast.List)) else [target]
            ):
                attr = _self_attr(el)
                if attr is not None:
                    kind = (
                        "rmw-assign"
                        if _reads_self_attr(node.value, attr)
                        else "assign"
                    )
                    self._add(attr, node.lineno, kind)
                elif isinstance(el, ast.Subscript):
                    self._add(_self_attr(el.value), node.lineno, "item-assign")
        self.generic_visit(node)

    def visit_Delete(self, node: ast.Delete) -> None:
        for target in node.targets:
            if isinstance(target, ast.Subscript):
                self._add(_self_attr(target.value), node.lineno, "item-assign")
            else:
                attr = _self_attr(target)
                self._add(attr, node.lineno, "assign")
        self.generic_visit(node)

    # nested defs are intercepted by visit_FunctionDef above and analyzed
    # as isolated pseudo-methods — their bodies are NOT visited in the
    # parent's context (they run when called, e.g. as a Thread target, not
    # where they are defined).  Lambdas, by contrast, stay attributed to
    # the enclosing method.


def _collect_methods(cls: ast.ClassDef) -> Dict[str, _MethodInfo]:
    methods: Dict[str, _MethodInfo] = {}
    extras: Dict[str, _MethodInfo] = {}  # nested closure pseudo-methods
    for node in cls.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            info = _MethodInfo(name=node.name)
            visitor = _MethodVisitor(info, extras)
            for stmt in node.body:
                visitor.visit(stmt)
            methods[node.name] = info
    methods.update(extras)
    return methods


def _closure(start: str, methods: Dict[str, _MethodInfo]) -> Set[str]:
    seen: Set[str] = set()
    stack = [start]
    while stack:
        name = stack.pop()
        if name in seen or name not in methods:
            continue
        seen.add(name)
        stack.extend(methods[name].self_calls)
    return seen


def check_class(cls: ast.ClassDef, rel_path: str) -> List[Finding]:
    methods = _collect_methods(cls)
    if not methods:
        return []

    # entry points: spawned methods (thread targets / executor submits)
    spawned: Set[str] = set()
    for info in methods.values():
        spawned.update(t for t in info.spawn_targets if t in methods)
    if not spawned:
        return []  # single-context class: nothing can race

    # context labels per method
    contexts: Dict[str, Set[str]] = {name: set() for name in methods}
    for entry in spawned:
        for name in _closure(entry, methods):
            contexts[name].add(f"spawn:{entry}")
    # caller context: the public surface and its closure.  A spawned-only
    # private method stays out of it; an uncalled private method is assumed
    # externally callable (conservative).
    called_by_someone: Set[str] = set()
    for info in methods.values():
        called_by_someone.update(info.self_calls)
    caller_seeds = [
        name
        for name in methods
        if "." not in name  # nested closures are never externally callable
        and (
            (not name.startswith("_") or name.startswith("__"))
            or (name not in spawned and name not in called_by_someone)
        )
    ]
    for seed in caller_seeds:
        for name in _closure(seed, methods):
            contexts[name].add("caller")

    # group mutations by attribute
    per_attr: Dict[str, List[Tuple[str, _Mutation]]] = {}
    for name, info in methods.items():
        for mut in info.mutations:
            per_attr.setdefault(mut.attr, []).append((name, mut))

    findings: List[Finding] = []
    for attr, sites in sorted(per_attr.items()):
        labels: Set[str] = set()
        for method_name, _mut in sites:
            labels.update(contexts[method_name])
        if len(labels) < 2:
            continue
        for method_name, mut in sites:
            if mut.kind not in _RMW_KINDS or mut.locked:
                continue
            if method_name.endswith("_locked"):
                continue  # caller-holds-lock convention
            findings.append(
                Finding(
                    checker=CHECKER,
                    file=rel_path,
                    line=mut.line,
                    symbol=f"{cls.name}.{method_name}.{attr}",
                    message=(
                        f"{cls.name}.{attr} is mutated from multiple thread "
                        f"contexts ({', '.join(sorted(labels))}) but this "
                        f"{mut.kind} in {method_name}() is not under a lock"
                    ),
                )
            )
    return findings


def check_source(source: str, rel_path: str) -> List[Finding]:
    tree = ast.parse(source)
    findings: List[Finding] = []
    for node in ast.walk(tree):
        if isinstance(node, ast.ClassDef):
            findings.extend(check_class(node, rel_path))
    return findings


def check(root: str) -> List[Finding]:
    findings: List[Finding] = []
    for rel in iter_py_files(root, ["torchft_tpu_torch"]):
        with open(os.path.join(root, rel)) as f:
            source = f.read()
        findings.extend(check_source(source, rel))
    return findings
