"""Shared ftlint infrastructure: findings, pragmas, the baseline, the runner.

A :class:`Finding` carries a *fingerprint* that is stable across line-number
drift (checker + file + symbol + message), so baselining a grandfathered
violation survives unrelated edits to the file.  Suppression is two-tier:

- inline pragma ``# ftlint: ignore[<checker>]`` on the finding's line (or
  the line above it) — the preferred form, because the justification lives
  next to the code it excuses;
- the JSON baseline (``torchft_tpu_torch/analysis/baseline.json``) — for
  violations that predate the analyzer and need a tracked debt entry.

Stale baseline entries (fingerprints no checker produces any more) are
reported so the debt list can only shrink.
"""

from __future__ import annotations

import hashlib
import json
import os
import re
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Tuple

# pragmas live in `#` comments in Python and `//` comments in the C++ tier
_PRAGMA_RE = re.compile(r"(?:#|//)\s*ftlint:\s*ignore\[([a-z0-9_,\- ]+)\]")


@dataclass
class Finding:
    checker: str
    file: str  # repo-relative path
    line: int
    symbol: str  # class.method / knob name / tag name / constant name
    message: str

    @property
    def fingerprint(self) -> str:
        digest = hashlib.sha1(
            f"{self.checker}|{self.file}|{self.symbol}|{self.message}".encode()
        ).hexdigest()[:12]
        return f"{self.checker}:{self.file}:{self.symbol}:{digest}"

    def render(self) -> str:
        return f"{self.file}:{self.line}: [{self.checker}] {self.message}"


def repo_root(start: Optional[str] = None) -> str:
    """Walk up from ``start`` (default: this package) to the directory
    holding ``pyproject.toml`` — the scan root everything is relative to."""
    d = os.path.abspath(start or os.path.dirname(os.path.dirname(os.path.dirname(__file__))))
    while True:
        if os.path.exists(os.path.join(d, "pyproject.toml")):
            return d
        parent = os.path.dirname(d)
        if parent == d:
            raise FileNotFoundError("pyproject.toml not found above " + str(start))
        d = parent


def iter_py_files(root: str, rel_dirs: Iterable[str]) -> List[str]:
    """Repo-relative paths of every ``.py`` file under the given relative
    dirs (or the single file itself), sorted for deterministic output."""
    out: List[str] = []
    for rel in rel_dirs:
        top = os.path.join(root, rel)
        if os.path.isfile(top):
            out.append(rel)
            continue
        for dirpath, _dirnames, filenames in os.walk(top):
            for name in filenames:
                if name.endswith(".py"):
                    out.append(
                        os.path.relpath(os.path.join(dirpath, name), root)
                    )
    return sorted(out)


def pragma_lines(source: str) -> Dict[int, Tuple[str, ...]]:
    """Map of 1-based line number -> checkers ignored on that line."""
    out: Dict[int, Tuple[str, ...]] = {}
    for i, text in enumerate(source.splitlines(), start=1):
        m = _PRAGMA_RE.search(text)
        if m:
            out[i] = tuple(
                part.strip() for part in m.group(1).split(",") if part.strip()
            )
    return out


def is_suppressed(finding: Finding, pragmas: Dict[int, Tuple[str, ...]]) -> bool:
    """A pragma suppresses a finding from its own line or the line above
    (so long mutation statements can carry the pragma on a lead-in
    comment).  ``ignore[all]`` suppresses every checker."""
    for line in (finding.line, finding.line - 1):
        for name in pragmas.get(line, ()):
            if name == "all" or name == finding.checker:
                return True
    return False


def default_baseline_path(root: str) -> str:
    return os.path.join(root, "torchft_tpu_torch", "analysis", "baseline.json")


def load_baseline(path: str) -> List[str]:
    if not os.path.exists(path):
        return []
    with open(path) as f:
        data = json.load(f)
    entries = data if isinstance(data, list) else data.get("suppressions", [])
    out = []
    for entry in entries:
        out.append(entry["fingerprint"] if isinstance(entry, dict) else entry)
    return out


def save_baseline(path: str, findings: Iterable[Finding]) -> None:
    payload = {
        "_comment": (
            "ftlint grandfathered violations. Every entry is debt: prefer "
            "an inline `# ftlint: ignore[checker] — reason` pragma next to "
            "the code, and only baseline findings that need a tracked "
            "cross-file exception. See docs/torch_operations.md."
        ),
        "suppressions": [
            {"fingerprint": f.fingerprint, "note": f.message}
            for f in sorted(findings, key=lambda f: f.fingerprint)
        ],
    }
    with open(path, "w") as f:
        json.dump(payload, f, indent=2)
        f.write("\n")


@dataclass
class RunResult:
    new: List[Finding] = field(default_factory=list)  # fail the build
    suppressed: List[Finding] = field(default_factory=list)  # pragma'd
    baselined: List[Finding] = field(default_factory=list)
    stale_baseline: List[str] = field(default_factory=list)
    all_findings: List[Finding] = field(default_factory=list)


def run_checkers(
    root: Optional[str] = None,
    checkers: Optional[Iterable[str]] = None,
    baseline_path: Optional[str] = None,
) -> RunResult:
    """Run the requested checkers (default: all four) over the repo at
    ``root`` and partition findings into new / pragma-suppressed /
    baselined."""
    from torchft_tpu_torch.analysis import (
        concurrency,
        knobcheck,
        metricscheck,
        nativelocks,
        nativemirror,
        threads,
        wireproto,
    )

    root = root or repo_root()
    registry = {
        "thread-safety": threads.check,
        "lock-order": concurrency.check_lock_order,
        "blocking-under-lock": concurrency.check_blocking,
        "executor-starvation": concurrency.check_starvation,
        "wire-protocol": wireproto.check,
        "knob-registry": knobcheck.check,
        "metrics-registry": metricscheck.check,
        "native-mirror": nativemirror.check,
        "native-locks": nativelocks.check,
    }
    names = list(checkers) if checkers else list(registry)
    unknown = [n for n in names if n not in registry]
    if unknown:
        raise ValueError(f"unknown checker(s): {unknown} (have {list(registry)})")

    result = RunResult()
    pragma_cache: Dict[str, Dict[int, Tuple[str, ...]]] = {}
    for name in names:
        for finding in registry[name](root):
            result.all_findings.append(finding)
            if finding.file not in pragma_cache:
                path = os.path.join(root, finding.file)
                try:
                    with open(path) as f:
                        pragma_cache[finding.file] = pragma_lines(f.read())
                except OSError:
                    pragma_cache[finding.file] = {}
            if is_suppressed(finding, pragma_cache[finding.file]):
                result.suppressed.append(finding)
            else:
                result.new.append(finding)

    baseline = set(load_baseline(baseline_path or default_baseline_path(root)))
    if baseline:
        still_new = []
        for finding in result.new:
            if finding.fingerprint in baseline:
                result.baselined.append(finding)
            else:
                still_new.append(finding)
        result.new = still_new
        produced = {f.fingerprint for f in result.all_findings}
        result.stale_baseline = sorted(baseline - produced)
    return result
