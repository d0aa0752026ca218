"""AST lint framework: rules, waivers, file walking, reporting.

The JAX package's framework (pure :mod:`ast`), over the port's tree.  It
is deliberately small: a :class:`Rule` sees one parsed file
(:class:`FileContext` — source, AST, parent links, its path relative to the
package root) and yields :class:`Violation`\\ s.  Policy (which modules a
rule covers, lock names, fence names) lives in
:mod:`repro_torch.analysis.config`;
the rules themselves are mechanism only.

**Waivers.**  Rules R1-R5 are static heuristics over a dynamic property, so
false positives are possible by construction.  They are silenced inline —
never globally — with a mandatory justification::

    raw = lazy.cpu()  # fct-lint: waive[R4] -- collection boundary

The waiver must sit on the flagged line or the line directly above it, name
the rule id it waives, and carry a non-empty justification after ``--``.
A waiver without a justification is itself a violation (rule ``WAIVER``):
an unexplained suppression is exactly the silent invariant-erosion this
pass exists to prevent.
"""
from __future__ import annotations

import ast
import dataclasses
import re
import tokenize
from pathlib import Path
from typing import Dict, Iterable, Iterator, List, Optional, Sequence, Tuple

from repro_torch.analysis.config import EXCLUDED_DIRS

#: comment grammar: ``# fct-lint: waive[R3] -- justification text``
WAIVER_RE = re.compile(
    r"#\s*fct-lint:\s*waive\[([A-Za-z0-9_-]+)\]\s*(?:--\s*(\S.*))?")


@dataclasses.dataclass(frozen=True)
class Violation:
    """One finding: ``file:line rule-id message`` (plus JSON fields)."""

    path: str           # repo-relative posix path
    line: int
    rule: str
    message: str

    def render(self) -> str:
        return f"{self.path}:{self.line} {self.rule} {self.message}"

    def to_json(self) -> dict:
        return {"file": self.path, "line": self.line, "rule": self.rule,
                "message": self.message}


@dataclasses.dataclass(frozen=True)
class Waiver:
    """One inline suppression and its justification."""

    path: str
    line: int
    rule: str
    justification: str

    def to_json(self) -> dict:
        return {"file": self.path, "line": self.line, "rule": self.rule,
                "justification": self.justification}


class FileContext:
    """One parsed file, as the rules see it."""

    def __init__(self, path: Path, rel: str, display: str,
                 source: str) -> None:
        self.path = path
        self.rel = rel              # path relative to the package root
        self.display = display      # repo-relative path used in reports
        self.source = source
        self.tree = ast.parse(source, filename=str(path))
        self._parents: Dict[ast.AST, ast.AST] = {}
        for parent in ast.walk(self.tree):
            for child in ast.iter_child_nodes(parent):
                self._parents[child] = parent

    def parent(self, node: ast.AST) -> Optional[ast.AST]:
        return self._parents.get(node)

    def ancestors(self, node: ast.AST) -> Iterator[ast.AST]:
        cur = self._parents.get(node)
        while cur is not None:
            yield cur
            cur = self._parents.get(cur)

    def enclosing_function(self, node: ast.AST) -> Optional[ast.AST]:
        for anc in self.ancestors(node):
            if isinstance(anc, (ast.FunctionDef, ast.AsyncFunctionDef)):
                return anc
        return None

    def violation(self, node: ast.AST, rule: str, message: str) -> Violation:
        return Violation(path=self.display, line=getattr(node, "lineno", 0),
                         rule=rule, message=message)


class Rule:
    """Base rule: subclasses set ``rule_id``/``title`` and implement
    ``applies`` (path scoping) and ``check`` (the AST walk)."""

    rule_id: str = "R0"
    title: str = ""

    def applies(self, ctx: FileContext) -> bool:  # pragma: no cover
        raise NotImplementedError

    def check(self, ctx: FileContext) -> Iterator[Violation]:
        raise NotImplementedError  # pragma: no cover


# ---------------------------------------------------------------------------
# shared AST helpers used by several rules
# ---------------------------------------------------------------------------

def call_path(func: ast.AST) -> str:
    """Dotted spelling of a call target: ``torch.compile`` for
    ``Attribute(Name('torch'), 'compile')``, ``psum`` for a bare name."""
    parts: List[str] = []
    while isinstance(func, ast.Attribute):
        parts.append(func.attr)
        func = func.value
    if isinstance(func, ast.Name):
        parts.append(func.id)
        return ".".join(reversed(parts))
    return ""


def import_aliases(tree: ast.AST) -> Dict[str, str]:
    """Local name -> the dotted path it was imported as: ``import a.b``
    binds ``a``, ``import a.b as c`` binds ``c`` to ``a.b``, ``from a
    import b as c`` binds ``c`` to ``a.b`` (absolute imports only)."""
    aliases: Dict[str, str] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                if alias.asname:
                    aliases[alias.asname] = alias.name
                else:
                    head = alias.name.split(".", 1)[0]
                    aliases[head] = head
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            for alias in node.names:
                aliases[alias.asname or alias.name] = (
                    f"{node.module}.{alias.name}")
    return aliases


def resolved_path(node: ast.AST, aliases: Dict[str, str]) -> str:
    """:func:`call_path` with its first name replaced by what the module
    imported under that name ("" when the first name was not imported)."""
    path = call_path(node)
    head, _, rest = path.partition(".")
    if head not in aliases:
        return ""
    return aliases[head] + ("." + rest if rest else "")


def self_attr(node: ast.AST) -> Optional[str]:
    """The attribute name if ``node`` is ``self.<attr>`` (else None)."""
    if (isinstance(node, ast.Attribute)
            and isinstance(node.value, ast.Name)
            and node.value.id == "self"):
        return node.attr
    return None


def under_lock(ctx: FileContext, node: ast.AST,
               lock_names: Sequence[str]) -> bool:
    """True if ``node`` sits inside ``with self.<lock>:`` for one of the
    configured lock names (any enclosing ``with`` statement counts)."""
    for anc in ctx.ancestors(node):
        if isinstance(anc, (ast.With, ast.AsyncWith)):
            for item in anc.items:
                name = self_attr(item.context_expr)
                if name in lock_names:
                    return True
    return False


# ---------------------------------------------------------------------------
# waiver parsing
# ---------------------------------------------------------------------------

def parse_waivers(path: Path,
                  display: str) -> Tuple[Dict[Tuple[str, int], Waiver],
                                         List[Violation]]:
    """Scan comments for waivers.  Returns ``{(rule, line): Waiver}`` plus
    the violations for malformed (justification-free) waivers."""
    waivers: Dict[Tuple[str, int], Waiver] = {}
    bad: List[Violation] = []
    with tokenize.open(path) as fh:
        tokens = tokenize.generate_tokens(fh.readline)
        for tok in tokens:
            if tok.type != tokenize.COMMENT:
                continue
            m = WAIVER_RE.search(tok.string)
            if m is None:
                continue
            rule, justification = m.group(1), m.group(2)
            line = tok.start[0]
            if not justification:
                bad.append(Violation(
                    path=display, line=line, rule="WAIVER",
                    message=f"waiver for {rule} has no justification "
                            f"(syntax: # fct-lint: waive[{rule}] -- why)"))
                continue
            waivers[(rule, line)] = Waiver(path=display, line=line,
                                           rule=rule,
                                           justification=justification)
    return waivers, bad


def apply_waivers(violations: List[Violation],
                  waivers: Dict[Tuple[str, int], Waiver]
                  ) -> Tuple[List[Violation], List[Waiver]]:
    """A violation is waived by a matching-rule waiver on its own line or
    the line directly above."""
    kept: List[Violation] = []
    used: List[Waiver] = []
    for v in violations:
        w = waivers.get((v.rule, v.line)) or waivers.get((v.rule, v.line - 1))
        if w is not None:
            used.append(w)
        else:
            kept.append(v)
    return kept, used


# ---------------------------------------------------------------------------
# walking and reporting
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class LintReport:
    violations: List[Violation]
    waived: List[Waiver]
    files_checked: int

    @property
    def ok(self) -> bool:
        return not self.violations

    def to_json(self) -> dict:
        return {"ok": self.ok,
                "files_checked": self.files_checked,
                "violations": [v.to_json() for v in self.violations],
                "waived": [w.to_json() for w in self.waived]}


def _excluded(rel: str) -> bool:
    head = rel.split("/", 1)[0]
    return head in EXCLUDED_DIRS


def iter_source_files(package_root: Path) -> Iterator[Tuple[Path, str]]:
    """(path, rel) for every lintable file under the package root, with
    the shared exclusion list applied."""
    for path in sorted(package_root.rglob("*.py")):
        rel = path.relative_to(package_root).as_posix()
        if _excluded(rel):
            continue
        yield path, rel


def default_rules() -> List[Rule]:
    from repro_torch.analysis.rules import ALL_RULES
    return [cls() for cls in ALL_RULES]


def lint_file(path: Path, rel: str, display: str,
              rules: Optional[Iterable[Rule]] = None
              ) -> Tuple[List[Violation], List[Waiver]]:
    """Lint one file; returns (violations, used waivers)."""
    if rules is None:
        rules = default_rules()
    source = path.read_text()
    try:
        ctx = FileContext(path, rel, display, source)
    except SyntaxError as exc:
        return [Violation(path=display, line=exc.lineno or 0, rule="PARSE",
                          message=f"syntax error: {exc.msg}")], []
    found: List[Violation] = []
    for rule in rules:
        if rule.applies(ctx):
            found.extend(rule.check(ctx))
    waivers, malformed = parse_waivers(path, display)
    kept, used = apply_waivers(found, waivers)
    kept.extend(malformed)
    kept.sort(key=lambda v: (v.path, v.line, v.rule))
    return kept, used


def lint_paths(package_root: Path,
               rules: Optional[Iterable[Rule]] = None,
               repo_root: Optional[Path] = None) -> LintReport:
    """Lint every non-excluded file under ``package_root`` (the
    ``repro_torch`` package directory).  ``repo_root`` only affects report paths."""
    package_root = Path(package_root)
    if repo_root is None:
        repo_root = package_root.parent.parent
    rules = list(rules) if rules is not None else default_rules()
    violations: List[Violation] = []
    waived: List[Waiver] = []
    n = 0
    for path, rel in iter_source_files(package_root):
        try:
            display = path.relative_to(repo_root).as_posix()
        except ValueError:
            display = path.as_posix()
        kept, used = lint_file(path, rel, display, rules)
        violations.extend(kept)
        waived.extend(used)
        n += 1
    return LintReport(violations=violations, waived=waived, files_checked=n)
