"""Native lock-discipline checker: C++ concurrency conventions, textually.

The port's native tier (``torchft_tpu_torch/csrc/native/*.h``, ``*.cc``) is header-only C++ compiled with
no sanitizer in the default build, so its locking discipline is enforced the
same way :mod:`.nativemirror` enforces the wire mirror: by parsing the text
(no C++ toolchain needed at lint time).  Four conventions are checked:

1. **Guards annotations** — a ``// guards a_/b_/c_`` comment above a
   ``std::mutex`` member declares which members that mutex protects (the
   convention ``comm.h`` already documents for ``state_mu_``).  Every use
   of a guarded member must then appear inside a lexical
   ``lock_guard``/``unique_lock``/``scoped_lock`` scope of that mutex.
   Member declarations and constructor-initializer-list entries are exempt.
   Only ``name_``-suffixed members can be annotated (the class-member
   naming convention) — short unsuffixed names like ``q`` would false-match
   locals.
2. **Snapshot discipline** — a member with a ``<stem>_snapshot()`` accessor
   (``io_`` / ``io_snapshot()``, ``pool_`` / ``pool_snapshot()``) must never
   be *dereferenced* through the raw member (``io_->``): configure() swaps
   these pointers under the state mutex while superseded op threads may
   still be mid-IO, so the only sanctioned access is copying the
   ``shared_ptr`` out under the lock — exactly the torn-``EpochIO``-pointer
   UB that was once caught only by hand.
3. **Mutex liveness** — every declared ``std::mutex`` must be acquired
   somewhere in the file; a mutex no ``lock_guard`` ever names is either
   dead weight or, worse, state that silently lost its lock.
4. **Atomic/plain mixing** — a ``std::atomic`` member must not be handed to
   ``memcpy``/``memset``/``memmove`` (bypasses the atomic access path), and
   the same member name must not be declared both atomic and plain in one
   file (a stale shadow of a field that was made atomic).

Suppress a justified site with ``// ftlint: ignore[native-locks] — reason``
on the line or the line above.
"""

from __future__ import annotations

import os
import re
from typing import Dict, List, Set, Tuple

from torchft_tpu_torch.analysis.core import Finding

CHECKER = "native-locks"

_NATIVE_DIR = os.path.join("torchft_tpu_torch", "csrc", "native")

_GUARDS_RE = re.compile(r"//\s*guards\s+(.+)$", re.M)
_MUTEX_DECL_RE = re.compile(
    r"^\s*(?:mutable\s+)?std::mutex\s+(\w+)\s*;", re.M
)
_ATOMIC_DECL_RE = re.compile(
    r"std::atomic<[^>]+>(?:\[\])?>?\s+(\w+)\s*[;{=]"
)
_LOCK_ACQ_RE = re.compile(
    r"std::(?:lock_guard|unique_lock|scoped_lock)\s*<[^>]*>\s*\w+\s*\(([^)]*)\)"
)
_SNAPSHOT_FN_RE = re.compile(r"\b(\w+)_snapshot\s*\(")


def _finding(rel: str, line: int, symbol: str, message: str) -> Finding:
    return Finding(
        checker=CHECKER, file=rel, line=line, symbol=symbol, message=message
    )


def _line_at(text: str, pos: int) -> int:
    return text.count("\n", 0, pos) + 1


def _strip(text: str) -> str:
    """Blank comments and string/char literals, preserving offsets, so
    member-name matching never fires inside prose or log strings."""
    out = list(text)
    i, n = 0, len(text)
    while i < n:
        c = text[i]
        if c == "/" and i + 1 < n and text[i + 1] == "/":
            j = text.find("\n", i)
            j = n if j < 0 else j
            for k in range(i, j):
                out[k] = " "
            i = j
        elif c == "/" and i + 1 < n and text[i + 1] == "*":
            j = text.find("*/", i + 2)
            j = n if j < 0 else j + 2
            for k in range(i, j):
                if out[k] != "\n":
                    out[k] = " "
            i = j
        elif c in "\"'":
            quote = c
            j = i + 1
            while j < n and text[j] != quote:
                if text[j] == "\\":
                    j += 1
                j += 1
            j = min(j + 1, n)
            for k in range(i + 1, j - 1):
                if out[k] != "\n":
                    out[k] = " "
            i = j
        else:
            i += 1
    return "".join(out)


def _guard_map(text: str) -> Dict[str, str]:
    """``member -> mutex`` from ``// guards a_/b_`` annotations (raw text —
    the annotation lives in a comment).  The annotation binds to the next
    ``std::mutex`` declaration within the following few lines, and the
    member list may wrap onto ``//`` continuation lines — every
    ``name_``-suffixed token between ``guards`` and the declaration is part
    of the guarded set (a first-line-only parse would silently drop the
    wrapped members and stop enforcing them)."""
    out: Dict[str, str] = {}
    for m in _GUARDS_RE.finditer(text):
        annotation = m.group(1)
        tail = text[m.end():]
        # consume continuation comment lines up to the mutex declaration
        for line in tail.splitlines()[1:]:
            if not line.lstrip().startswith("//"):
                break
            annotation += " " + line
        members = re.findall(r"\b([a-z]\w*_)\b", annotation)
        decl = _MUTEX_DECL_RE.search(tail[:500])
        if not decl:
            continue
        mutex = decl.group(1)
        for member in members:
            if member != mutex:
                out[member] = mutex
    return out


def _lock_scopes(stripped: str) -> List[Tuple[str, int, int]]:
    """(mutex, start, end) byte ranges where each mutex is lexically held:
    from the guard's construction to the close of its enclosing block."""
    scopes: List[Tuple[str, int, int]] = []
    for m in _LOCK_ACQ_RE.finditer(stripped):
        args = m.group(1)
        idents = re.findall(r"\w+", args)
        if not idents:
            continue
        mutex = idents[-1]
        depth = 0
        end = len(stripped)
        for i in range(m.end(), len(stripped)):
            c = stripped[i]
            if c == "{":
                depth += 1
            elif c == "}":
                depth -= 1
                if depth < 0:
                    end = i
                    break
        scopes.append((mutex, m.start(), end))
    return scopes


_USE_KEYWORDS = frozenset({"return", "throw", "delete", "co_return", "co_yield"})


def _member_uses(stripped: str, member: str) -> List[int]:
    """Offsets of uses of ``member``, excluding its declaration (a type
    token directly precedes and ``;`` follows — but ``return io_;`` is a
    use, so expression keywords don't count as types) and constructor-
    initializer entries (token followed by ``(``)."""
    uses: List[int] = []
    for m in re.finditer(rf"\b{re.escape(member)}\b", stripped):
        tail = stripped[m.end():m.end() + 2].lstrip()
        if tail.startswith("("):
            continue  # ctor initializer list: io_(std::make_shared<...>())
        if tail.startswith(";") or (tail.startswith("=") and not tail.startswith("==")):
            # `IoPtr io_;` / `uint64_t gen_ = 0;` are declarations when a
            # type token directly precedes; `return io_;` / `gen_ = 1;`
            # (statement context: `;`/`{`/`}` precedes) are uses
            head = stripped[:m.start()].rstrip()
            if head and (head[-1].isalnum() or head[-1] in "_>*&"):
                prev_word = re.search(r"(\w+)$", head)
                if not (prev_word and prev_word.group(1) in _USE_KEYWORDS):
                    continue
        uses.append(m.start())
    return uses


def _locked_fn_ranges(stripped: str) -> List[Tuple[int, int]]:
    """Extents of ``*_locked`` member functions — the caller-holds-lock
    convention (mirror of the Python checker's ``*_locked`` exemption)."""
    out: List[Tuple[int, int]] = []
    for m in re.finditer(r"\b\w+_locked\s*\([^)]*\)(?:\s*const)?\s*\{", stripped):
        depth = 1
        end = len(stripped)
        for i in range(m.end(), len(stripped)):
            c = stripped[i]
            if c == "{":
                depth += 1
            elif c == "}":
                depth -= 1
                if depth == 0:
                    end = i
                    break
        out.append((m.start(), end))
    return out


def check_text(text: str, rel: str) -> List[Finding]:
    findings: List[Finding] = []
    stripped = _strip(text)
    scopes = _lock_scopes(stripped)
    held_by: Dict[str, List[Tuple[int, int]]] = {}
    for mutex, start, end in scopes:
        held_by.setdefault(mutex, []).append((start, end))
    locked_fns = _locked_fn_ranges(stripped)

    # 1. guards annotations
    for member, mutex in sorted(_guard_map(text).items()):
        ranges = held_by.get(mutex, []) + locked_fns
        for pos in _member_uses(stripped, member):
            if any(start <= pos < end for start, end in ranges):
                continue
            findings.append(
                _finding(
                    rel,
                    _line_at(stripped, pos),
                    f"guards.{member}",
                    f"{member} is annotated `// guards` by {mutex} but this "
                    f"use is outside any lock_guard/unique_lock({mutex}) "
                    f"scope",
                )
            )

    # 2. snapshot discipline: raw deref of members with *_snapshot()
    snapshot_stems: Set[str] = set(_SNAPSHOT_FN_RE.findall(stripped))
    for stem in sorted(snapshot_stems):
        member = stem + "_"
        for m in re.finditer(rf"\b{re.escape(member)}\s*->", stripped):
            findings.append(
                _finding(
                    rel,
                    _line_at(stripped, m.start()),
                    f"snapshot.{member}",
                    f"{member} is dereferenced through the raw member — it "
                    f"has a {stem}_snapshot() accessor because configure() "
                    f"swaps it while superseded op threads are mid-IO; "
                    f"copy the shared_ptr out via {stem}_snapshot() instead "
                    f"(torn-pointer UB otherwise)",
                )
            )

    # 3. mutex liveness
    for m in _MUTEX_DECL_RE.finditer(stripped):
        mutex = m.group(1)
        if mutex in held_by:
            continue
        # condition_variable waits also prove the mutex is live
        if re.search(rf"\bwait(?:_until|_for)?\s*\(\s*\w*{re.escape(mutex)}", stripped):
            continue
        findings.append(
            _finding(
                rel,
                _line_at(stripped, m.start()),
                f"mutex.{mutex}",
                f"std::mutex {mutex} is declared but no "
                f"lock_guard/unique_lock in this file ever acquires it — "
                f"either dead weight or state that lost its lock",
            )
        )

    # 4. atomic/plain mixing
    atomics = set(_ATOMIC_DECL_RE.findall(stripped))
    for member in sorted(atomics):
        for m in re.finditer(
            rf"\bmem(?:cpy|set|move)\s*\([^;]*&\s*{re.escape(member)}\b", stripped
        ):
            findings.append(
                _finding(
                    rel,
                    _line_at(stripped, m.start()),
                    f"atomic.{member}",
                    f"std::atomic member {member} is passed to a raw memory "
                    f"op — this bypasses the atomic access path (plain "
                    f"access mixed with atomic access is a data race)",
                )
            )
        for m in re.finditer(
            rf"^\s*(?:mutable\s+)?(?:bool|int\w*|size_t|uint\w+|float|double)\s+"
            rf"{re.escape(member)}\s*[;=]",
            stripped,
            re.M,
        ):
            findings.append(
                _finding(
                    rel,
                    _line_at(stripped, m.start()),
                    f"atomic.{member}",
                    f"{member} is declared both std::atomic and plain in "
                    f"this file — a stale non-atomic shadow of an "
                    f"atomicized field",
                )
            )
    return findings


def check(root: str) -> List[Finding]:
    findings: List[Finding] = []
    native = os.path.join(root, _NATIVE_DIR)
    if not os.path.isdir(native):
        return [
            _finding(
                _NATIVE_DIR, 1, "dir", "csrc/native/ missing — cannot check lock discipline"
            )
        ]
    for name in sorted(os.listdir(native)):
        if not (name.endswith(".h") or name.endswith(".cc")):
            continue
        rel = f"{_NATIVE_DIR}/{name}"
        with open(os.path.join(root, rel)) as f:
            findings.extend(check_text(f.read(), rel))
    return findings
