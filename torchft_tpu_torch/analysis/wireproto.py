"""Wire-protocol checker: central tag registry + version-gate symmetry.

Three invariants:

1. **Tag registration.**  Every data-plane tag literal (``tag=`` /
   ``tag_base=`` keyword, or a module-level ``*_TAG*`` constant) must be a
   value declared in ``wire.py``'s central registry
   (``USER_TAG_ALLOCATIONS`` / ``WIRE_TAG_OFFSETS`` /
   ``INTERNAL_TAG_BASES``).  Ad-hoc user tags 0..7 are allowed for
   point-to-point sends.
2. **Allocation collisions.**  USER allocations must be pairwise disjoint
   and live below the lowest user-composed WIRE offset; WIRE offsets must
   be at least 1000 apart (the nominal namespace width).
3. **Pack/unpack symmetry.**  For every class in ``wire.py`` with an
   ``encode(w)``/``decode(r)`` pair, the sequence of primitive field
   operations must match between the two — *per wire-version gate*: a
   field written under ``manager_quorum_wire_version() >= N`` must be read
   under a ``... >= N`` guard, so a one-sided tail cannot desync a rolling
   upgrade.  List fields normalize to ``count + many:<prim>``, nested
   ``encode``/``decode`` to ``many:nested``/``nested``, and the tail
   version marker itself is recognized and dropped on both sides.
"""

from __future__ import annotations

import ast
import os
from typing import Dict, List, Optional, Tuple

from torchft_tpu_torch.analysis.core import Finding, iter_py_files

CHECKER = "wire-protocol"

_PRIMS = frozenset(
    {"u8", "u32", "u64", "i64", "f64", "boolean", "string", "blob", "opt_i64"}
)
# files where raw tag literals are hunted (the data plane)
_TAG_SCAN_DIRS = ("torchft_tpu_torch",)
_ADHOC_TAG_MAX = 7  # small ad-hoc p2p tags stay legal


# ---------------------------------------------------------------------------
# 1 + 2: tag registry
# ---------------------------------------------------------------------------


def _registered_values(wire_mod) -> Dict[int, str]:
    values: Dict[int, str] = {}
    for name, (base, _span) in wire_mod.USER_TAG_ALLOCATIONS.items():
        values[base] = name
    for name, off in wire_mod.WIRE_TAG_OFFSETS.items():
        values[off] = name
    for name, base in wire_mod.INTERNAL_TAG_BASES.items():
        values[base] = name
    return values


def check_allocations(
    user: Dict[str, Tuple[int, int]],
    offsets: Dict[str, int],
    rel_path: str = "torchft_tpu_torch/wire.py",
) -> List[Finding]:
    """Collision rules over a registry (parameterized for fixture tests)."""
    findings: List[Finding] = []
    ranges = sorted(
        (base, base + span, name) for name, (base, span) in user.items()
    )
    for (s1, e1, n1), (s2, e2, n2) in zip(ranges, ranges[1:]):
        if s2 < e1:
            findings.append(
                Finding(
                    checker=CHECKER,
                    file=rel_path,
                    line=1,
                    symbol=f"{n1}/{n2}",
                    message=(
                        f"tag allocations {n1} [{s1},{e1}) and {n2} "
                        f"[{s2},{e2}) collide"
                    ),
                )
            )
    # user tags must stay below EVERY wire offset: a raw user tag at or
    # above an offset value aliases that namespace's composed frames (the
    # BROADCAST namespace is offset + buffer index, so this includes it)
    if offsets and ranges:
        top = max(e for _s, e, _n in ranges)
        low = min(offsets.values())
        if top > low:
            findings.append(
                Finding(
                    checker=CHECKER,
                    file=rel_path,
                    line=1,
                    symbol="USER_TAG_ALLOCATIONS",
                    message=(
                        f"user tag allocations reach {top} but the lowest "
                        f"wire offset is {low}: raw user tags would alias "
                        f"frames of that namespace"
                    ),
                )
            )
    offs = sorted((v, k) for k, v in offsets.items())
    for (v1, k1), (v2, k2) in zip(offs, offs[1:]):
        if v2 - v1 < 1000:
            findings.append(
                Finding(
                    checker=CHECKER,
                    file=rel_path,
                    line=1,
                    symbol=f"{k1}/{k2}",
                    message=(
                        f"wire offsets {k1}={v1} and {k2}={v2} are closer "
                        f"than the 1000-wide namespace they partition"
                    ),
                )
            )
    return findings


def _literal_tags_in_source(source: str, rel_path: str) -> List[Tuple[int, int, str]]:
    """(value, line, context) for every numeric tag literal in the file."""
    out: List[Tuple[int, int, str]] = []
    tree = ast.parse(source)
    for node in ast.walk(tree):
        if isinstance(node, ast.Call):
            for kw in node.keywords:
                if kw.arg in ("tag", "tag_base") and isinstance(
                    kw.value, ast.Constant
                ) and isinstance(kw.value.value, int):
                    out.append((kw.value.value, kw.value.lineno, kw.arg))
                # tag=BASE + tag / tag=BASE * k: a literal inside the math
                elif kw.arg in ("tag", "tag_base") and isinstance(
                    kw.value, ast.BinOp
                ):
                    for sub in ast.walk(kw.value):
                        if isinstance(sub, ast.Constant) and isinstance(
                            sub.value, int
                        ) and sub.value > _ADHOC_TAG_MAX:
                            out.append((sub.value, sub.lineno, kw.arg))
        elif isinstance(node, ast.Assign):
            for target in node.targets:
                name = target.id if isinstance(target, ast.Name) else None
                if name and "TAG" in name.upper() and isinstance(
                    node.value, ast.Constant
                ) and isinstance(node.value.value, int):
                    out.append((node.value.value, node.lineno, name))
    return out


def check_tag_literals(
    source: str, rel_path: str, registered: Dict[int, str]
) -> List[Finding]:
    findings = []
    for value, line, context in _literal_tags_in_source(source, rel_path):
        if value <= _ADHOC_TAG_MAX:
            continue
        if value in registered:
            continue
        if value >= (1 << 63):
            continue  # control-frame sentinels, not tags
        findings.append(
            Finding(
                checker=CHECKER,
                file=rel_path,
                line=line,
                symbol=str(value),
                message=(
                    f"tag literal {value} ({context}) is not declared in "
                    f"the wire.py tag registry — allocate it in "
                    f"USER_TAG_ALLOCATIONS / WIRE_TAG_OFFSETS and use the "
                    f"named constant"
                ),
            )
        )
    return findings


# ---------------------------------------------------------------------------
# 3: encode/decode symmetry
# ---------------------------------------------------------------------------


class _OpCollector:
    """Emit primitive field ops of an encode/decode body in evaluation
    order, attributed to the wire-version level active at the emit site."""

    def __init__(self, handle: str, is_encode: bool) -> None:
        self.handle = handle  # "w" or "r"
        self.is_encode = is_encode
        self.ops: List[Tuple[int, str]] = []  # (level, op)
        self.level = 0
        # names assigned from a version expression -> the level they gate
        self.version_vars: Dict[str, Optional[int]] = {}

    # -- version guard recognition ------------------------------------------

    def _is_version_expr(self, node: ast.AST) -> bool:
        for sub in ast.walk(node):
            if isinstance(sub, ast.Call):
                fn = sub.func
                name = fn.attr if isinstance(fn, ast.Attribute) else getattr(fn, "id", "")
                if "wire_version" in name or name == "manager_quorum_wire_version":
                    return True
            if isinstance(sub, ast.Name) and sub.id in self.version_vars:
                return True
            if isinstance(sub, ast.Name) and "version" in sub.id.lower():
                return True
        return False

    def _guard_level(self, test: ast.AST) -> Optional[int]:
        """``<version expr> >= N`` anywhere in a test -> N."""
        for sub in ast.walk(test):
            if isinstance(sub, ast.Compare) and len(sub.ops) == 1:
                if isinstance(sub.ops[0], ast.GtE) and isinstance(
                    sub.comparators[0], ast.Constant
                ):
                    left = sub.left
                    if self._is_version_expr(left) or (
                        not self.is_encode
                        and isinstance(left, ast.Call)
                        and self._is_reader_call(left) == "u32"
                    ):
                        return int(sub.comparators[0].value)
            if isinstance(sub, ast.Name) and self.version_vars.get(sub.id):
                return self.version_vars[sub.id]
        return None

    def _is_reader_call(self, node: ast.AST) -> Optional[str]:
        if (
            isinstance(node, ast.Call)
            and isinstance(node.func, ast.Attribute)
            and node.func.attr in _PRIMS
        ):
            return node.func.attr
        return None

    # -- statement walk ------------------------------------------------------

    def visit_body(self, body: List[ast.stmt]) -> None:
        for stmt in body:
            self.visit_stmt(stmt)

    def visit_stmt(self, stmt: ast.stmt) -> None:
        if isinstance(stmt, ast.If):
            level = self._guard_level(stmt.test)
            # a decoder's `if not r.done():` tail guard opens no new level
            if level is not None:
                saved = self.level
                self.level = max(self.level, level)
                self.visit_body(stmt.body)
                self.level = saved
            else:
                self.visit_body(stmt.body)
            self.visit_body(stmt.orelse)
            return
        if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1:
            target = stmt.targets[0]
            if isinstance(target, ast.Name):
                # version marker read:  tail_version = r.u32()
                if (
                    not self.is_encode
                    and self._is_reader_call(stmt.value) == "u32"
                    and "version" in target.id.lower()
                ):
                    self.version_vars[target.id] = None
                    return
                # has_tail = <version expr >= N and ...>
                level = (
                    self._guard_level(stmt.value)
                    if self._is_version_expr(stmt.value)
                    else None
                )
                if level is not None:
                    self.version_vars[target.id] = level
                    return
        if isinstance(stmt, (ast.For, ast.While)):
            before = len(self.ops)
            for sub in ast.walk(stmt):
                self._maybe_emit_call(sub)
            # loop body ops become many:<op>
            looped = self.ops[before:]
            self.ops[before:] = [(lv, f"many:{op}") for lv, op in looped]
            return
        self._collect_expr(stmt)

    def _collect_expr(self, node: ast.AST) -> None:
        for child in self._eval_order(node):
            self._maybe_emit_call(child)

    def _eval_order(self, node: ast.AST) -> List[ast.AST]:
        """Children in evaluation order (func chain before args)."""
        out: List[ast.AST] = []

        def rec(n: ast.AST) -> None:
            if isinstance(n, (ast.ListComp, ast.SetComp, ast.GeneratorExp)):
                out.append(n)  # handled atomically by _maybe_emit_call
                return
            if isinstance(n, ast.Call):
                rec(n.func)
                for a in n.args:
                    rec(a)
                for k in n.keywords:
                    rec(k.value)
                out.append(n)
                return
            for child in ast.iter_child_nodes(n):
                rec(child)

        rec(node)
        return out

    def _maybe_emit_call(self, node: ast.AST) -> None:
        if isinstance(node, (ast.ListComp, ast.SetComp, ast.GeneratorExp)):
            # [X for _ in range(r.u32())]  ->  count + many:<elt op>
            gen = node.generators[0]
            has_count = any(
                self._is_reader_call(sub) == "u32" for sub in ast.walk(gen.iter)
            )
            if has_count:
                self.ops.append((self.level, "count"))
            elt_op = self._op_of(node.elt)
            if elt_op:
                self.ops.append((self.level, f"many:{elt_op}"))
            return
        op = self._op_of(node)
        if op:
            self.ops.append((self.level, op))

    def _op_of(self, node: ast.AST) -> Optional[str]:
        if not isinstance(node, ast.Call):
            return None
        fn = node.func
        if isinstance(fn, ast.Attribute):
            if fn.attr in _PRIMS:
                # encode: w.u32(len(x)) is a count; w.u32(<const/IfExp of
                # consts>) right after opening a versioned block is the tail
                # version marker — drop it (the decode side drops its
                # matching `tail_version = r.u32()` read)
                if self.is_encode and fn.attr == "u32" and node.args:
                    arg = node.args[0]
                    if (
                        isinstance(arg, ast.Call)
                        and isinstance(arg.func, ast.Name)
                        and arg.func.id == "len"
                    ):
                        return "count"
                    if isinstance(arg, ast.Constant) or isinstance(
                        arg, ast.IfExp
                    ):
                        return None  # version marker
                return fn.attr
            if fn.attr == "encode":
                return "nested"
            if fn.attr == "decode":
                return "nested"
        return None


def _method(cls: ast.ClassDef, name: str):
    for node in cls.body:
        if isinstance(node, ast.FunctionDef) and node.name == name:
            return node
    return None


def check_codec_class(cls: ast.ClassDef, rel_path: str) -> List[Finding]:
    enc = _method(cls, "encode")
    dec = _method(cls, "decode")
    if enc is None or dec is None:
        return []
    enc_args = [a.arg for a in enc.args.args if a.arg != "self"]
    dec_args = [a.arg for a in dec.args.args if a.arg != "self"]
    if not enc_args or not dec_args:
        return []
    enc_col = _OpCollector(enc_args[0], is_encode=True)
    enc_col.visit_body(enc.body)
    dec_col = _OpCollector(dec_args[0], is_encode=False)
    dec_col.visit_body(dec.body)

    findings: List[Finding] = []

    def _norm(op: str) -> str:
        # a list-length prefix is wire-identical to a bare u32 (the decode
        # side may read it into a variable before the comprehension)
        return op.replace("count", "u32")

    levels = sorted(
        {lv for lv, _ in enc_col.ops} | {lv for lv, _ in dec_col.ops}
    )
    for level in levels:
        wrote = [_norm(op) for lv, op in enc_col.ops if lv == level]
        read = [_norm(op) for lv, op in dec_col.ops if lv == level]
        if wrote != read:
            gate = (
                "ungated fields"
                if level == 0
                else f"fields gated on wire version >= {level}"
            )
            findings.append(
                Finding(
                    checker=CHECKER,
                    file=rel_path,
                    line=enc.lineno,
                    symbol=f"{cls.name}.encode/decode@v{level}",
                    message=(
                        f"{cls.name}: {gate} are asymmetric — encode writes "
                        f"{wrote} but decode reads {read}; a field "
                        f"serialized under a version gate must be parsed "
                        f"under the same gate"
                    ),
                )
            )
    return findings


def check_codec_source(source: str, rel_path: str) -> List[Finding]:
    findings: List[Finding] = []
    for node in ast.walk(ast.parse(source)):
        if isinstance(node, ast.ClassDef):
            findings.extend(check_codec_class(node, rel_path))
    return findings


# ---------------------------------------------------------------------------
# entry point
# ---------------------------------------------------------------------------


def check(root: str) -> List[Finding]:
    from torchft_tpu_torch import wire

    findings = check_allocations(
        wire.USER_TAG_ALLOCATIONS, wire.WIRE_TAG_OFFSETS
    )
    registered = _registered_values(wire)
    for rel in iter_py_files(root, _TAG_SCAN_DIRS):
        if rel.replace(os.sep, "/").startswith("torchft_tpu_torch/analysis/"):
            continue
        with open(os.path.join(root, rel)) as f:
            source = f.read()
        if rel.replace(os.sep, "/") == "torchft_tpu_torch/wire.py":
            findings.extend(check_codec_source(source, rel))
            continue  # the registry's own declarations aren't "literals"
        findings.extend(check_tag_literals(source, rel, registered))
    return findings
