"""Concurrency deep-analysis: lock ordering, blocking-under-lock, executor
starvation.

The ``thread-safety`` checker (:mod:`.threads`) finds *unlocked* cross-thread mutation; the
three checkers here find the bugs that happen when the locks ARE there:

- ``lock-order``: per class, extracts the lock-acquisition graph — an edge
  A -> B when ``with <B>:`` is entered while A is lexically held, including
  acquisitions reached through ``self._method()`` calls made under A — and
  flags cycles (two threads entering the cycle from different ends deadlock)
  plus same-thread re-acquisition of a plain ``threading.Lock`` (immediate
  self-deadlock; ``RLock``/``Condition`` are reentrant and exempt).
- ``blocking-under-lock``: flags calls that can block indefinitely — RPC
  client calls, socket send/recv, ``Future.result()``, ``Event.wait()``,
  ``Thread.join()``, ``time.sleep`` — made while a lock is lexically held,
  either directly in the ``with`` body or through the transitive
  ``self._method()`` closure entered under the lock.  This is the classic
  quorum-wedge shape: one stuck RPC holds the lock every other thread needs.
  ``cv.wait()`` on the lock being held is exempt (wait releases it).
- ``executor-starvation``: identifies single-thread executors
  (``ThreadPoolExecutor(max_workers=1)`` members) and flags ``submit`` calls
  onto such an executor from code that itself runs ON that executor (the
  submitted task can never start while its submitter occupies the only
  worker — waiting on it self-deadlocks, and even fire-and-forget submits
  queue behind the current task, inverting the intended ordering).

All three share the lexical model of :mod:`.threads`: nested ``def``s are
pseudo-methods that do NOT inherit the parent's lock depth (they run where
they are *called*), lambdas are opaque (their bodies run later, not under
the enclosing locks), and lock recognition follows ``threads._is_lockish``.
Suppress a justified site with ``# ftlint: ignore[<checker>] — <reason>``.
"""

from __future__ import annotations

import ast
import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Set, Tuple

from torchft_tpu_torch.analysis.core import Finding, iter_py_files
from torchft_tpu_torch.analysis.threads import _is_lockish, _self_attr, _terminal_names

LOCK_ORDER = "lock-order"
BLOCKING = "blocking-under-lock"
STARVATION = "executor-starvation"

# module-level wire helpers that do socket IO (torchft_tpu_torch/wire.py); calling
# one while holding a lock is a blocking-under-lock site like sock.recv
_BLOCKING_NAMES = frozenset(
    {"send_frame", "recv_frame", "recv_exact", "connect", "sleep"}
)

# socket / channel methods that block on the peer
_BLOCKING_SOCKET_ATTRS = frozenset(
    {
        "recv", "recv_into", "recvfrom", "recvmsg", "send", "sendall",
        "sendmsg", "accept", "connect", "select",
    }
)


def _lock_name(expr: ast.AST) -> Optional[str]:
    """Identity of a lock context-manager expression: ``self._lock`` ->
    ``_lock``, a bare name -> itself, ``self._x.r_lock()`` -> ``_x``.
    None when nothing in the expression looks lockish."""
    if isinstance(expr, ast.Call):
        expr = expr.func
    attr = _self_attr(expr)
    if attr is not None:
        return attr if _is_lockish(attr) else None
    if isinstance(expr, ast.Name):
        return expr.id if _is_lockish(expr.id) else None
    if isinstance(expr, ast.Attribute):
        # self._x.r_lock() / self._x.w_lock(): the holder attribute is the
        # lock identity (rwlock wrappers)
        inner = _self_attr(expr.value)
        if inner is not None and any(_is_lockish(n) for n in _terminal_names(expr)):
            return inner
    names = [n for n in _terminal_names(expr) if _is_lockish(n)]
    return names[-1] if names else None


@dataclass
class _Acquire:
    held: Tuple[str, ...]
    lock: str
    line: int


@dataclass
class _CallSite:
    held: Tuple[str, ...]
    callee: str
    line: int


@dataclass
class _BlockSite:
    held: Tuple[str, ...]
    desc: str
    line: int


@dataclass
class _SubmitSite:
    executor: str
    targets: Tuple[str, ...]
    line: int


@dataclass
class _MInfo:
    name: str
    acquires: List[_Acquire] = field(default_factory=list)
    calls: List[_CallSite] = field(default_factory=list)
    blocks: List[_BlockSite] = field(default_factory=list)
    submits: List[_SubmitSite] = field(default_factory=list)


class _Visitor(ast.NodeVisitor):
    """One pass over a method body collecting lock acquisitions (with the
    lexically-held set at each), self-call sites, blocking-call sites, and
    executor submits.  Mirrors threads._MethodVisitor's nesting rules."""

    def __init__(self, info: _MInfo, extras: Dict[str, _MInfo]) -> None:
        self.info = info
        self.extras = extras
        self._nested: Dict[str, str] = {}
        self._held: List[str] = []

    # -- nested defs / lambdas ----------------------------------------------

    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        self._visit_nested(node)

    def visit_AsyncFunctionDef(self, node: ast.AsyncFunctionDef) -> None:
        self._visit_nested(node)

    def _visit_nested(self, node) -> None:
        qual = f"{self.info.name}.{node.name}"
        child = _MInfo(name=qual)
        visitor = _Visitor(child, self.extras)
        for stmt in node.body:
            visitor.visit(stmt)
        self.extras[qual] = child
        self._nested[node.name] = qual

    def visit_Lambda(self, node: ast.Lambda) -> None:
        pass  # runs later, not under the enclosing locks

    # -- lock scopes ---------------------------------------------------------

    def visit_With(self, node: ast.With) -> None:
        self._visit_with(node)

    def visit_AsyncWith(self, node: ast.AsyncWith) -> None:
        self._visit_with(node)

    def _visit_with(self, node) -> None:
        entered: List[str] = []
        for item in node.items:
            self.visit(item.context_expr)
            lock = _lock_name(item.context_expr)
            if lock is not None:
                self.info.acquires.append(
                    _Acquire(tuple(self._held), lock, item.context_expr.lineno)
                )
                self._held.append(lock)
                entered.append(lock)
        for stmt in node.body:
            self.visit(stmt)
        for _ in entered:
            self._held.pop()

    # -- call sites ----------------------------------------------------------

    def _submit_targets(self, node: ast.AST) -> Tuple[str, ...]:
        out: List[str] = []
        if isinstance(node, ast.Name) and node.id in self._nested:
            out.append(self._nested[node.id])
        name = _self_attr(node)
        if name:
            out.append(name)
        if isinstance(node, ast.Lambda):
            for sub in ast.walk(node.body):
                if isinstance(sub, ast.Call):
                    n = _self_attr(sub.func)
                    if n:
                        out.append(n)
        if isinstance(node, ast.Call):  # functools.partial(self.X, ...)
            fn = node.func
            if (isinstance(fn, ast.Attribute) and fn.attr == "partial") or (
                isinstance(fn, ast.Name) and fn.id == "partial"
            ):
                if node.args:
                    n = _self_attr(node.args[0])
                    if n:
                        out.append(n)
        return tuple(out)

    def _blocking_desc(self, node: ast.Call) -> Optional[str]:
        func = node.func
        if isinstance(func, ast.Name):
            if func.id in _BLOCKING_NAMES and func.id != "sleep":
                return f"{func.id}() (socket IO)"
            if func.id == "sleep":
                return "sleep()"
            return None
        if not isinstance(func, ast.Attribute):
            return None
        attr = func.attr
        recv = func.value
        if attr == "sleep" and isinstance(recv, ast.Name) and recv.id == "time":
            return "time.sleep()"
        if attr == "result":
            return "Future.result()"
        if attr in ("wait", "wait_for"):
            # cv.wait on the lock being held RELEASES it — not a block
            holder = _self_attr(recv)
            if holder is None and isinstance(recv, ast.Name):
                holder = recv.id
            if holder is not None and holder in self._held:
                return None
            return f"{attr}()"
        if attr == "join" and not node.args:
            # thread.join() takes no positional args; str.join(parts) does
            return "join()"
        if attr in _BLOCKING_SOCKET_ATTRS:
            return f"{attr}() (socket IO)"
        # any method on a *client*-named receiver is an RPC round-trip
        # (RpcClient.call and every typed wrapper around it); close() and
        # interrupt() are local socket teardown, not round-trips
        if attr not in ("close", "interrupt"):
            names = "/".join(_terminal_names(recv)).lower()
            if "client" in names or "rpc" in names:
                return f"RPC .{attr}()"
        return None

    def visit_Call(self, node: ast.Call) -> None:
        func = node.func
        name = _self_attr(func)
        if name:
            self.info.calls.append(
                _CallSite(tuple(self._held), name, node.lineno)
            )
        if isinstance(func, ast.Name) and func.id in self._nested:
            self.info.calls.append(
                _CallSite(tuple(self._held), self._nested[func.id], node.lineno)
            )
        if isinstance(func, ast.Attribute) and func.attr == "submit" and node.args:
            executor = _self_attr(func.value)
            if executor is not None:
                self.info.submits.append(
                    _SubmitSite(
                        executor, self._submit_targets(node.args[0]), node.lineno
                    )
                )
        desc = self._blocking_desc(node)
        if desc is not None:
            self.info.blocks.append(
                _BlockSite(tuple(self._held), desc, node.lineno)
            )
        self.generic_visit(node)


@dataclass
class _ClassModel:
    name: str
    methods: Dict[str, _MInfo]
    # lock attr -> ctor kind ("Lock" | "RLock" | "Condition" | ...) when a
    # `self.X = threading.Y()` assignment was seen anywhere in the class
    lock_ctors: Dict[str, str]
    # executor attr -> True when ThreadPoolExecutor(max_workers=1)
    single_executors: Set[str]


def _model_class(cls: ast.ClassDef) -> _ClassModel:
    methods: Dict[str, _MInfo] = {}
    extras: Dict[str, _MInfo] = {}
    for node in cls.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            info = _MInfo(name=node.name)
            visitor = _Visitor(info, extras)
            for stmt in node.body:
                visitor.visit(stmt)
            methods[node.name] = info
    methods.update(extras)

    lock_ctors: Dict[str, str] = {}
    single_executors: Set[str] = set()
    for node in ast.walk(cls):
        if not isinstance(node, ast.Assign) or not isinstance(node.value, ast.Call):
            continue
        call = node.value
        ctor = _terminal_names(call.func)
        for target in node.targets:
            attr = _self_attr(target)
            if attr is None:
                continue
            for kind in ("RLock", "Condition", "Lock", "Semaphore", "Event"):
                if kind in ctor:
                    lock_ctors[attr] = kind
                    break
            if "ThreadPoolExecutor" in ctor:
                for kw in call.keywords:
                    if (
                        kw.arg == "max_workers"
                        and isinstance(kw.value, ast.Constant)
                        and kw.value.value == 1
                    ):
                        single_executors.add(attr)
    return _ClassModel(cls.name, methods, lock_ctors, single_executors)


def _closure(start: str, methods: Dict[str, _MInfo]) -> Set[str]:
    seen: Set[str] = set()
    stack = [start]
    while stack:
        name = stack.pop()
        if name in seen or name not in methods:
            continue
        seen.add(name)
        stack.extend(c.callee for c in methods[name].calls)
    return seen


def _transitive_acquires(model: _ClassModel) -> Dict[str, Set[str]]:
    """Locks acquired anywhere in each method's call closure."""
    out: Dict[str, Set[str]] = {}
    for name in model.methods:
        locks: Set[str] = set()
        for m in _closure(name, model.methods):
            locks.update(a.lock for a in model.methods[m].acquires)
        out[name] = locks
    return out


# ---------------------------------------------------------------------------
# lock-order
# ---------------------------------------------------------------------------


def _lock_order_findings(model: _ClassModel, rel_path: str) -> List[Finding]:
    findings: List[Finding] = []
    acquires_star = _transitive_acquires(model)

    # edges: (held_lock -> acquired_lock) with a representative site
    edges: Dict[Tuple[str, str], Tuple[str, int, str]] = {}  # -> (method, line, via)
    for name, info in model.methods.items():
        for acq in info.acquires:
            for held in acq.held:
                edges.setdefault(
                    (held, acq.lock), (name, acq.line, "")
                )
        for call in info.calls:
            if not call.held:
                continue
            for lock in acquires_star.get(call.callee, set()):
                for held in call.held:
                    edges.setdefault(
                        (held, lock),
                        (name, call.line, f" via self.{call.callee}()"),
                    )

    # self-deadlock: re-acquiring a plain Lock on the same thread.  RLock
    # and Condition (which wraps an RLock by default) are reentrant; when
    # the ctor is unseen the type is unknown — stay quiet.
    for (a, b), (method, line, via) in sorted(edges.items()):
        if a == b and model.lock_ctors.get(a) == "Lock":
            findings.append(
                Finding(
                    checker=LOCK_ORDER,
                    file=rel_path,
                    line=line,
                    symbol=f"{model.name}.{a}.self-deadlock",
                    message=(
                        f"{model.name}.{method}() re-acquires plain Lock "
                        f"self.{a} while already holding it{via} — "
                        f"threading.Lock is not reentrant; this deadlocks "
                        f"the calling thread"
                    ),
                )
            )

    # cycles among distinct locks: Tarjan SCCs over the edge graph
    graph: Dict[str, Set[str]] = {}
    for (a, b) in edges:
        if a != b:
            graph.setdefault(a, set()).add(b)
            graph.setdefault(b, set())
    for scc in _sccs(graph):
        if len(scc) < 2:
            continue
        cycle = sorted(scc)
        # a representative pair of conflicting edges for the message
        sites = []
        for (a, b), (method, line, via) in sorted(edges.items()):
            if a in scc and b in scc and a != b:
                sites.append(f"{method}():{line} takes {b} under {a}{via}")
        findings.append(
            Finding(
                checker=LOCK_ORDER,
                file=rel_path,
                line=min(
                    line
                    for (a, b), (_m, line, _v) in edges.items()
                    if a in scc and b in scc and a != b
                ),
                symbol=f"{model.name}.cycle.{'<->'.join(cycle)}",
                message=(
                    f"{model.name} acquires locks {{{', '.join(cycle)}}} in "
                    f"conflicting orders ({'; '.join(sites)}) — two threads "
                    f"entering from different ends deadlock"
                ),
            )
        )
    return findings


def _sccs(graph: Dict[str, Set[str]]) -> List[Set[str]]:
    """Tarjan's strongly-connected components (iterative)."""
    index: Dict[str, int] = {}
    low: Dict[str, int] = {}
    on_stack: Set[str] = set()
    stack: List[str] = []
    out: List[Set[str]] = []
    counter = [0]

    def strongconnect(root: str) -> None:
        work = [(root, iter(sorted(graph.get(root, ()))))]
        index[root] = low[root] = counter[0]
        counter[0] += 1
        stack.append(root)
        on_stack.add(root)
        while work:
            v, it = work[-1]
            advanced = False
            for w in it:
                if w not in index:
                    index[w] = low[w] = counter[0]
                    counter[0] += 1
                    stack.append(w)
                    on_stack.add(w)
                    work.append((w, iter(sorted(graph.get(w, ())))))
                    advanced = True
                    break
                elif w in on_stack:
                    low[v] = min(low[v], index[w])
            if advanced:
                continue
            work.pop()
            if low[v] == index[v]:
                scc: Set[str] = set()
                while True:
                    w = stack.pop()
                    on_stack.discard(w)
                    scc.add(w)
                    if w == v:
                        break
                out.append(scc)
            if work:
                parent = work[-1][0]
                low[parent] = min(low[parent], low[v])

    for node in sorted(graph):
        if node not in index:
            strongconnect(node)
    return out


# ---------------------------------------------------------------------------
# blocking-under-lock
# ---------------------------------------------------------------------------


def _blocking_findings(model: _ClassModel, rel_path: str) -> List[Finding]:
    findings: List[Finding] = []

    # transitive blocking descriptions per method (any held-ness inside the
    # callee: the caller's lock is held across the whole call either way)
    blocks_star: Dict[str, Set[str]] = {}
    for name in model.methods:
        descs: Set[str] = set()
        for m in _closure(name, model.methods):
            descs.update(b.desc for b in model.methods[m].blocks)
        blocks_star[name] = descs

    for name, info in model.methods.items():
        for block in info.blocks:
            if not block.held:
                continue
            findings.append(
                Finding(
                    checker=BLOCKING,
                    file=rel_path,
                    line=block.line,
                    symbol=f"{model.name}.{name}.{block.held[-1]}.{block.desc}",
                    message=(
                        f"{model.name}.{name}() calls {block.desc} while "
                        f"holding {block.held[-1]} — a stall here wedges "
                        f"every thread contending for the lock"
                    ),
                )
            )
        for call in info.calls:
            if not call.held or call.callee == name:
                continue
            reached = blocks_star.get(call.callee, set())
            if not reached:
                continue
            desc = sorted(reached)[0]
            findings.append(
                Finding(
                    checker=BLOCKING,
                    file=rel_path,
                    line=call.line,
                    symbol=(
                        f"{model.name}.{name}.{call.held[-1]}"
                        f".{call.callee}.{desc}"
                    ),
                    message=(
                        f"{model.name}.{name}() calls self.{call.callee}() "
                        f"while holding {call.held[-1]}, and that call "
                        f"reaches {desc} — the lock is held across the "
                        f"blocking call"
                    ),
                )
            )
    return findings


# ---------------------------------------------------------------------------
# executor-starvation
# ---------------------------------------------------------------------------


def _starvation_findings(model: _ClassModel, rel_path: str) -> List[Finding]:
    findings: List[Finding] = []
    for executor in sorted(model.single_executors):
        entries: Set[str] = set()
        for info in model.methods.values():
            for sub in info.submits:
                if sub.executor == executor:
                    entries.update(
                        t for t in sub.targets if t in model.methods
                    )
        on_executor: Set[str] = set()
        for entry in entries:
            on_executor.update(_closure(entry, model.methods))
        for name in sorted(on_executor):
            for sub in model.methods[name].submits:
                if sub.executor != executor:
                    continue
                findings.append(
                    Finding(
                        checker=STARVATION,
                        file=rel_path,
                        line=sub.line,
                        symbol=f"{model.name}.{name}.{executor}",
                        message=(
                            f"{model.name}.{name}() runs on single-thread "
                            f"executor {executor} (submitted transitively) "
                            f"and submits back onto it — the task queues "
                            f"behind its submitter; waiting on it "
                            f"self-deadlocks"
                        ),
                    )
                )
    return findings


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------


def check_source(
    source: str, rel_path: str, checkers: Sequence[str] = (LOCK_ORDER, BLOCKING, STARVATION)
) -> List[Finding]:
    tree = ast.parse(source)
    findings: List[Finding] = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.ClassDef):
            continue
        model = _model_class(node)
        if LOCK_ORDER in checkers:
            findings.extend(_lock_order_findings(model, rel_path))
        if BLOCKING in checkers:
            findings.extend(_blocking_findings(model, rel_path))
        if STARVATION in checkers:
            findings.extend(_starvation_findings(model, rel_path))
    return findings


def _check(root: str, checker: str) -> List[Finding]:
    findings: List[Finding] = []
    for rel in iter_py_files(root, ["torchft_tpu_torch"]):
        with open(os.path.join(root, rel)) as f:
            source = f.read()
        findings.extend(check_source(source, rel, (checker,)))
    return findings


def check_lock_order(root: str) -> List[Finding]:
    return _check(root, LOCK_ORDER)


def check_blocking(root: str) -> List[Finding]:
    return _check(root, BLOCKING)


def check_starvation(root: str) -> List[Finding]:
    return _check(root, STARVATION)
