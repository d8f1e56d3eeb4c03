"""Knob-registry checker: every env knob declared, docs in sync.

Extracts every ``TORCHFT_*`` / ``TPUFT_*`` token from string constants in
the port's package and ``chip_smoke.py`` (AST-based, so comments don't count) and
requires each to be declared in :mod:`torchft_tpu_torch.knobs`.  Indirection is
free: a ``RETRIES_ENV = "..."`` constant declares the knob literal right
where it is defined, and ``os.environ.get(RETRIES_ENV)`` carries no
literal at all.

Docs drift is checked in both directions against ``docs/torch_operations.md``:

- a knob mentioned in the doc but absent from the registry is a doc for a
  knob that doesn't exist (or was renamed without the doc);
- a registered knob never mentioned in the doc is an undocumented operator
  surface (the generated table in torch_operations.md §1 keeps this green —
  regenerate with ``python -m torchft_tpu_torch.knobs``).
"""

from __future__ import annotations

import ast
import os
import re
from typing import Dict, List, Set, Tuple

from torchft_tpu_torch.analysis.core import Finding, iter_py_files

CHECKER = "knob-registry"

_KNOB_RE = re.compile(r"\b(?:TORCHFT|TPUFT)_[A-Z0-9]+(?:_[A-Z0-9]+)*\b")
# source roots whose knob mentions must be registered
_SCAN_ROOTS = ("torchft_tpu_torch", "chip_smoke.py")
_DOC_REL = os.path.join("docs", "torch_operations.md")


def knob_tokens_in_source(source: str) -> List[Tuple[str, int]]:
    """(token, line) for every knob-shaped name in a string constant."""
    out: List[Tuple[str, int]] = []
    for node in ast.walk(ast.parse(source)):
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            for m in _KNOB_RE.finditer(node.value):
                out.append((m.group(0), node.lineno))
    return out


def _is_prefix_mention(token: str, registry: Dict[str, object]) -> bool:
    """``TPUFT_BENCH`` in a ``startswith("TPUFT_BENCH_")`` filter is a
    family prefix, not a knob."""
    probe = token + "_"
    return any(name.startswith(probe) for name in registry)


def check_source_tokens(
    source: str, rel_path: str, registry: Dict[str, object]
) -> List[Finding]:
    findings = []
    seen: Set[Tuple[str, int]] = set()
    for token, line in knob_tokens_in_source(source):
        if token in registry or _is_prefix_mention(token, registry):
            continue
        if (token, line) in seen:
            continue
        seen.add((token, line))
        findings.append(
            Finding(
                checker=CHECKER,
                file=rel_path,
                line=line,
                symbol=token,
                message=(
                    f"{token} is not declared in torchft_tpu_torch/knobs.py — "
                    f"register it (name, type, default, doc) before use"
                ),
            )
        )
    return findings


def check_docs(
    doc_text: str, registry: Dict[str, object], rel_path: str = _DOC_REL
) -> List[Finding]:
    findings = []
    doc_names: Dict[str, int] = {}
    for i, line_text in enumerate(doc_text.splitlines(), start=1):
        for m in _KNOB_RE.finditer(line_text):
            doc_names.setdefault(m.group(0), i)
    for name, line in sorted(doc_names.items()):
        if name not in registry and not _is_prefix_mention(name, registry):
            findings.append(
                Finding(
                    checker=CHECKER,
                    file=rel_path.replace(os.sep, "/"),
                    line=line,
                    symbol=name,
                    message=(
                        f"docs/torch_operations.md mentions {name}, which is not "
                        f"in the knob registry — stale doc or unregistered "
                        f"knob"
                    ),
                )
            )
    for name in sorted(set(registry) - set(doc_names)):
        findings.append(
            Finding(
                checker=CHECKER,
                file=rel_path.replace(os.sep, "/"),
                line=1,
                symbol=name,
                message=(
                    f"registered knob {name} is never mentioned in "
                    f"docs/torch_operations.md — add it to the knob table "
                    f"(python -m torchft_tpu_torch.knobs regenerates it)"
                ),
            )
        )
    return findings


def check(root: str) -> List[Finding]:
    from torchft_tpu_torch import knobs

    registry = knobs.REGISTRY
    findings: List[Finding] = []
    for rel in iter_py_files(root, _SCAN_ROOTS):
        with open(os.path.join(root, rel)) as f:
            source = f.read()
        try:
            findings.extend(check_source_tokens(source, rel, registry))
        except SyntaxError:
            continue  # not this checker's job
    doc_path = os.path.join(root, _DOC_REL)
    if os.path.exists(doc_path):
        with open(doc_path) as f:
            findings.extend(check_docs(f.read(), registry))
    return findings
