"""Metrics-registry checker: every /metrics name declared once, legal,
documented, and every serving site registered.

The ``/metrics`` plane (``obs/metrics.py``) declares every served metric
name exactly once.  This checker enforces the contract statically:

1. **Declarations** (``_m("name", "kind", ...)`` in ``obs/metrics.py``):
   parsed textually so a duplicate that would raise at import is caught at
   lint time too; names must be Prometheus-legal
   (``[a-z_:][a-z0-9_:]*``), kinds must be gauge/counter, counters must
   end in ``_total``.
2. **Serving sites**: every ``torchft_lh_*`` / ``torchft_mgr_*`` string
   literal anywhere in package source (AST string constants, so comments
   don't count) must name a declared metric — an undeclared literal is a
   metric that would KeyError at scrape time (or a typo that would
   silently never serve).
3. **Docs**: every declared metric must appear in ``docs/torch_operations.md``
   (its §2 carries the generated table —
   ``python -m torchft_tpu_torch.obs.metrics`` re-emits it), and every
   metric-shaped name in the doc must be declared (stale doc detection) —
   the same two-way contract the knob checker enforces.
"""

from __future__ import annotations

import ast
import os
import re
from typing import Dict, List, Tuple

from torchft_tpu_torch.analysis.core import Finding, iter_py_files

CHECKER = "metrics-registry"

_REGISTRY_REL = os.path.join("torchft_tpu_torch", "obs", "metrics.py")
_DOC_REL = os.path.join("docs", "torch_operations.md")
_SCAN_ROOTS = ("torchft_tpu_torch", "chip_smoke.py")

_DECL_RE = re.compile(r'_m\(\s*\n?\s*"(?P<name>[^"]+)",\s*"(?P<kind>[^"]+)"')
_NAME_RE = re.compile(r"^[a-z_:][a-z0-9_:]*$")
# metric-shaped tokens: the two namespaces the /metrics plane serves
_METRIC_TOKEN_RE = re.compile(r"\btorchft_(?:lh|mgr)_[a-z0-9_]+\b")


def parse_declarations(source: str) -> List[Tuple[str, str, int]]:
    """(name, kind, line) for every ``_m("...", "...")`` declaration."""
    out = []
    for m in _DECL_RE.finditer(source):
        line = source[: m.start()].count("\n") + 1
        out.append((m.group("name"), m.group("kind"), line))
    return out


def check_declarations(source: str, rel: str = _REGISTRY_REL) -> List[Finding]:
    findings: List[Finding] = []
    seen: Dict[str, int] = {}
    for name, kind, line in parse_declarations(source):
        if name in seen:
            findings.append(
                Finding(
                    checker=CHECKER,
                    file=rel.replace(os.sep, "/"),
                    line=line,
                    symbol=name,
                    message=(
                        f"metric {name} declared twice (first at line "
                        f"{seen[name]}) — every /metrics name must be "
                        f"declared exactly once"
                    ),
                )
            )
            continue
        seen[name] = line
        if not _NAME_RE.match(name):
            findings.append(
                Finding(
                    checker=CHECKER,
                    file=rel.replace(os.sep, "/"),
                    line=line,
                    symbol=name,
                    message=f"metric {name} is not a legal Prometheus name",
                )
            )
        if kind not in ("gauge", "counter"):
            findings.append(
                Finding(
                    checker=CHECKER,
                    file=rel.replace(os.sep, "/"),
                    line=line,
                    symbol=name,
                    message=f"metric {name} has unknown kind {kind!r}",
                )
            )
        elif kind == "counter" and not name.endswith("_total"):
            findings.append(
                Finding(
                    checker=CHECKER,
                    file=rel.replace(os.sep, "/"),
                    line=line,
                    symbol=name,
                    message=(
                        f"counter {name} must end in _total (Prometheus "
                        f"naming convention)"
                    ),
                )
            )
    return findings


def metric_tokens_in_source(source: str) -> List[Tuple[str, int]]:
    """(token, line) for every metric-shaped name in a string constant."""
    out: List[Tuple[str, int]] = []
    for node in ast.walk(ast.parse(source)):
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            for m in _METRIC_TOKEN_RE.finditer(node.value):
                out.append((m.group(0), node.lineno))
    return out


def check_serving_sites(
    source: str, rel_path: str, declared: Dict[str, object]
) -> List[Finding]:
    """Every metric-shaped literal outside the registry must be declared."""
    findings = []
    seen = set()
    for token, line in metric_tokens_in_source(source):
        if token in declared or (token, line) in seen:
            continue
        seen.add((token, line))
        findings.append(
            Finding(
                checker=CHECKER,
                file=rel_path,
                line=line,
                symbol=token,
                message=(
                    f"{token} is not declared in torchft_tpu_torch/obs/metrics.py "
                    f"— an undeclared name KeyErrors at scrape time; "
                    f"register it (name, kind, doc) first"
                ),
            )
        )
    return findings


def check_docs(
    doc_text: str, declared: Dict[str, object], rel_path: str = _DOC_REL
) -> List[Finding]:
    findings = []
    doc_names: Dict[str, int] = {}
    for i, line_text in enumerate(doc_text.splitlines(), start=1):
        for m in _METRIC_TOKEN_RE.finditer(line_text):
            doc_names.setdefault(m.group(0), i)
    for name, line in sorted(doc_names.items()):
        if name not in declared:
            findings.append(
                Finding(
                    checker=CHECKER,
                    file=rel_path.replace(os.sep, "/"),
                    line=line,
                    symbol=name,
                    message=(
                        f"docs/torch_operations.md mentions metric {name}, which "
                        f"is not in the obs/metrics.py registry — stale doc "
                        f"or unregistered metric"
                    ),
                )
            )
    for name in sorted(set(declared) - set(doc_names)):
        findings.append(
            Finding(
                checker=CHECKER,
                file=rel_path.replace(os.sep, "/"),
                line=1,
                symbol=name,
                message=(
                    f"registered metric {name} is never mentioned in "
                    f"docs/torch_operations.md — add it to the metrics table "
                    f"(python -m torchft_tpu_torch.obs.metrics regenerates it)"
                ),
            )
        )
    return findings


def check(root: str) -> List[Finding]:
    findings: List[Finding] = []
    registry_path = os.path.join(root, _REGISTRY_REL)
    if not os.path.exists(registry_path):
        return [
            Finding(
                checker=CHECKER,
                file=_REGISTRY_REL.replace(os.sep, "/"),
                line=1,
                symbol="registry",
                message="obs/metrics.py missing — no metric registry to check",
            )
        ]
    with open(registry_path) as f:
        registry_source = f.read()
    findings.extend(check_declarations(registry_source))
    declared: Dict[str, object] = {
        name: kind for name, kind, _line in parse_declarations(registry_source)
    }
    registry_rel = _REGISTRY_REL.replace(os.sep, "/")
    for rel in iter_py_files(root, _SCAN_ROOTS):
        if rel.replace(os.sep, "/") == registry_rel:
            continue
        with open(os.path.join(root, rel)) as f:
            source = f.read()
        try:
            findings.extend(check_serving_sites(source, rel, declared))
        except SyntaxError:
            continue  # not this checker's job
    doc_path = os.path.join(root, _DOC_REL)
    if os.path.exists(doc_path):
        with open(doc_path) as f:
            findings.extend(check_docs(f.read(), declared))
    return findings
