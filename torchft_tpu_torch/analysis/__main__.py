"""``ftlint`` CLI: ``python -m torchft_tpu_torch.analysis [options]``.

Exit status 0 when every finding is pragma-suppressed or baselined,
1 otherwise.  ``--write-baseline`` grandfathers the
current findings; keep that list near-empty and justified (see
docs/torch_operations.md §3).
"""

from __future__ import annotations

import argparse
import json
import sys

from torchft_tpu_torch.analysis import CHECKERS
from torchft_tpu_torch.analysis.core import (
    default_baseline_path,
    repo_root,
    run_checkers,
    save_baseline,
)


def _emit_json(result) -> None:
    """Machine-readable run result (``--format json``): every finding with
    its fingerprint and disposition, so CI tooling can diff runs."""

    def row(finding, disposition):
        return {
            "checker": finding.checker,
            "file": finding.file,
            "line": finding.line,
            "symbol": finding.symbol,
            "message": finding.message,
            "fingerprint": finding.fingerprint,
            "disposition": disposition,
        }

    payload = {
        "findings": [row(f, "new") for f in result.new]
        + [row(f, "suppressed") for f in result.suppressed]
        + [row(f, "baselined") for f in result.baselined],
        "stale_baseline": result.stale_baseline,
        "counts": {
            "new": len(result.new),
            "suppressed": len(result.suppressed),
            "baselined": len(result.baselined),
        },
    }
    json.dump(payload, sys.stdout, indent=2)
    sys.stdout.write("\n")


def _emit_github(result) -> None:
    """GitHub Actions workflow-command lines (``--format github``): each new
    finding becomes an ``::error`` annotation rendered inline on the PR
    diff.  Only NEW findings annotate — suppressed/baselined debt would be
    noise on every PR."""
    for f in sorted(result.new, key=lambda f: (f.file, f.line)):
        # the message is one line by construction; %, CR and LF would need
        # workflow-command escaping if that ever changes
        print(
            f"::error file={f.file},line={f.line},title=ftlint "
            f"{f.checker}::{f.message}"
        )


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="ftlint", description="torchft_tpu_torch repo-specific static analysis"
    )
    parser.add_argument("--root", default=None, help="repo root (default: auto)")
    parser.add_argument(
        "--checker",
        action="append",
        choices=CHECKERS,
        help="run only this checker (repeatable; default: all)",
    )
    parser.add_argument(
        "--baseline", default=None, help="baseline path (default: in-package)"
    )
    parser.add_argument(
        "--write-baseline",
        action="store_true",
        help="grandfather every current finding into the baseline",
    )
    parser.add_argument(
        "-q", "--quiet", action="store_true", help="findings only, no summary"
    )
    parser.add_argument(
        "--format",
        choices=("text", "json", "github"),
        default="text",
        help=(
            "output format: human text (default), json (full run result "
            "with fingerprints), or github (::error annotation lines CI "
            "surfaces inline on PRs)"
        ),
    )
    args = parser.parse_args(argv)

    root = args.root or repo_root()
    baseline_path = args.baseline or default_baseline_path(root)
    result = run_checkers(
        root=root, checkers=args.checker, baseline_path=baseline_path
    )

    if args.write_baseline:
        # keep still-firing grandfathered entries; only stale ones drop
        keep = result.new + result.baselined
        save_baseline(baseline_path, keep)
        print(f"ftlint: wrote {len(keep)} suppressions to {baseline_path}")
        return 0

    if args.format == "json":
        _emit_json(result)
        return 1 if result.new else 0
    if args.format == "github":
        _emit_github(result)
        return 1 if result.new else 0

    for finding in sorted(result.new, key=lambda f: (f.file, f.line)):
        print(finding.render())
    if not args.quiet:
        parts = [f"{len(result.new)} finding(s)"]
        if result.suppressed:
            parts.append(f"{len(result.suppressed)} pragma-suppressed")
        if result.baselined:
            parts.append(f"{len(result.baselined)} baselined")
        print(f"ftlint: {', '.join(parts)}", file=sys.stderr)
        for fp in result.stale_baseline:
            print(
                f"ftlint: warning: stale baseline entry {fp} (no longer "
                f"produced — remove it)",
                file=sys.stderr,
            )
    return 1 if result.new else 0


if __name__ == "__main__":
    sys.exit(main())
