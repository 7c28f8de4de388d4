"""Markdown link checker (docs CI gate).

Walks the repo's user-facing markdown — ``README.md``, ``ROADMAP.md`` and
everything under ``docs/`` by default — and verifies every **relative**
link resolves:

* ``[text](path/to/file.md)``      — the target file/directory exists;
* ``[text](file.md#anchor)``       — the file exists *and* contains a
  heading whose GitHub slug matches the anchor;
* ``[text](#anchor)``              — same-file heading exists.

``http(s)://`` and ``mailto:`` links are skipped (no network in CI), as
are links inside fenced code blocks.  Stdlib only, jax-free, so the docs
CI job runs without the accelerator stack.

Findings use ``code="dead-link"`` / ``"dead-anchor"`` with
``where="file.md:line"`` so CI artifacts and tests key on them.
"""
from __future__ import annotations

import os
import re
from typing import Dict, Iterable, List, Optional, Sequence, Set

from .errors import CheckError, Finding, raise_findings

# [text](target) — non-greedy target, no nested parens; images share the form
_LINK_RE = re.compile(r"!?\[[^\]]*\]\(([^)\s]+)(?:\s+\"[^\"]*\")?\)")
_HEADING_RE = re.compile(r"^#{1,6}\s+(.*)$")
_FENCE_RE = re.compile(r"^(```|~~~)")
_SKIP_SCHEMES = ("http://", "https://", "mailto:", "ftp://")

DEFAULT_DOCS = ("README.md", "ROADMAP.md", "PAPER.md", "docs")


class DocsCheckError(CheckError):
    """A relative markdown link points at nothing."""


def github_slug(heading: str) -> str:
    """GitHub's anchor slug for a heading: lowercase, strip punctuation
    (keep word chars, spaces, hyphens), spaces -> hyphens."""
    # drop inline code/emphasis markers and trailing anchors first
    text = re.sub(r"[`*_]", "", heading.strip())
    text = re.sub(r"[^\w\- ]", "", text.lower())
    return text.replace(" ", "-")


def _markdown_lines(path: str) -> List[str]:
    with open(path, encoding="utf-8") as f:
        return f.read().splitlines()


def anchors_in(path: str) -> Set[str]:
    """All heading slugs in a markdown file (GitHub duplicate suffixes
    ``-1``, ``-2``… included)."""
    seen: Dict[str, int] = {}
    out: Set[str] = set()
    in_fence = False
    for line in _markdown_lines(path):
        if _FENCE_RE.match(line):
            in_fence = not in_fence
            continue
        if in_fence:
            continue
        m = _HEADING_RE.match(line)
        if not m:
            continue
        slug = github_slug(m.group(1))
        n = seen.get(slug, 0)
        seen[slug] = n + 1
        out.add(slug if n == 0 else f"{slug}-{n}")
    return out


def check_markdown_file(path: str, repo_root: str) -> List[Finding]:
    """Check every relative link in one markdown file."""
    findings: List[Finding] = []
    rel = os.path.relpath(path, repo_root).replace(os.sep, "/")
    base = os.path.dirname(path)
    in_fence = False
    for lineno, line in enumerate(_markdown_lines(path), start=1):
        if _FENCE_RE.match(line):
            in_fence = not in_fence
            continue
        if in_fence:
            continue
        for m in _LINK_RE.finditer(line):
            target = m.group(1)
            if target.startswith(_SKIP_SCHEMES) or target.startswith("<"):
                continue
            frag = ""
            if "#" in target:
                target, frag = target.split("#", 1)
            if target:
                dest = os.path.normpath(os.path.join(base, target))
                if not os.path.exists(dest):
                    findings.append(Finding(
                        "dead-link", f"{rel}:{lineno}",
                        f"link target {target!r} does not exist"))
                    continue
            else:
                dest = path       # same-file anchor
            if frag:
                if not (os.path.isfile(dest) and dest.endswith(".md")):
                    continue      # anchors into non-markdown: not checked
                if frag.lower() not in anchors_in(dest):
                    findings.append(Finding(
                        "dead-anchor", f"{rel}:{lineno}",
                        f"anchor #{frag} not found in "
                        f"{os.path.relpath(dest, repo_root)}"))
    return findings


def _walk_markdown(entry: str) -> Iterable[str]:
    if os.path.isfile(entry):
        yield entry
        return
    for dirpath, dirnames, filenames in os.walk(entry):
        dirnames[:] = sorted(d for d in dirnames if not d.startswith("."))
        for fn in sorted(filenames):
            if fn.endswith(".md"):
                yield os.path.join(dirpath, fn)


def check_docs(repo_root: Optional[str] = None,
               entries: Sequence[str] = DEFAULT_DOCS) -> List[Finding]:
    """Link-check the repo's markdown set; missing entries are skipped
    (PAPER.md is optional), findings sorted by location."""
    if repo_root is None:
        # src/repro_torch/check/docs.py -> the repo root is three levels
        # up from src
        here = os.path.dirname(os.path.abspath(__file__))
        repo_root = os.path.dirname(os.path.dirname(os.path.dirname(here)))
    findings: List[Finding] = []
    for entry in entries:
        full = os.path.join(repo_root, entry)
        if not os.path.exists(full):
            continue
        for path in _walk_markdown(full):
            findings += check_markdown_file(path, repo_root)
    return sorted(findings, key=lambda f: f.where)


def verify_docs(repo_root: Optional[str] = None,
                strict: bool = False) -> List[Finding]:
    return raise_findings(check_docs(repo_root), DocsCheckError,
                          "markdown link check failed", strict=strict)
