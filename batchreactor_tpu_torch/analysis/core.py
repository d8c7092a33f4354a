"""brlint tier-A engine of the port: findings, rule registry,
suppressions, baseline.

Port of ``batchreactor_tpu/analysis/core.py``, line for line: a finding's
rendered line and its fingerprint come out byte-equal to the JAX engine's
for the same rule, path and line, so a baseline file means the same thing
to both.

* A **rule** is a callable ``rule(ctx) -> iterable[Finding]`` registered
  under a stable kebab-case name via :func:`register`.  ``ctx`` is a
  :class:`FileContext` carrying the parsed AST, the source lines, and
  the per-function device-reachability classification
  (:mod:`.reachability`: which functions run inside a captured step).
* **Suppressions** are per-line: ``# brlint: disable=rule-a,rule-b`` on
  the flagged line (or the line above, for long expressions) silences
  exactly those rules there; a bare ``# brlint: disable`` silences all.
  A suppression carries its reason in the surrounding comment.
* A **baseline** file records pre-existing findings by content
  fingerprint (rule + path + normalized source line), so existing debt
  is *tracked* rather than silenced: the scan fails only on findings not
  in the baseline, and stale baseline entries are reported so the file
  shrinks as debt is paid down.

Stdlib-only: tier A runs on a host whose torch does not import.
"""

import ast
import dataclasses
import hashlib
import json
import os
import re
import tokenize

from . import reachability

# severity ordering for output; both fail the scan unless baselined
SEVERITIES = ("error", "warning")


@dataclasses.dataclass(frozen=True)
class Finding:
    rule: str
    path: str
    line: int
    col: int
    message: str
    severity: str = "error"
    symbol: str = ""         # enclosing function, for human output

    def base_fingerprint(self, source_lines):
        """Content-addressed identity for baseline matching: stable under
        unrelated edits that shift line numbers, invalidated when the
        flagged line itself changes (the finding must be re-justified).
        Identical flagged lines in one file share this base — the
        module-level :func:`fingerprints` disambiguates them with an
        occurrence counter so duplicated debt is never silently
        baselined."""
        text = ""
        if 0 < self.line <= len(source_lines):
            text = source_lines[self.line - 1].strip()
        digest = hashlib.sha1(
            f"{self.rule}|{text}".encode()).hexdigest()[:12]
        # full normalized path, not basename: identically named files
        # (every __init__.py) must not share fingerprints, or debt in one
        # could absorb a new finding in another
        return f"{self.rule}:{os.path.normpath(self.path)}:{digest}"

    def render(self):
        sym = f" [{self.symbol}]" if self.symbol else ""
        return (f"{self.path}:{self.line}:{self.col}: {self.severity}: "
                f"{self.rule}: {self.message}{sym}")


_RULES = {}


def register(name, doc=""):
    """Decorator: register ``rule(ctx) -> iterable[Finding]`` under a
    stable name (the name users suppress with, so it is API)."""

    def deco(fn):
        fn.rule_name = name
        fn.rule_doc = doc or (fn.__doc__ or "").strip().splitlines()[0]
        _RULES[name] = fn
        return fn

    return deco


def all_rules():
    return dict(_RULES)


_SUPPRESS_RE = re.compile(r"#\s*brlint:\s*disable(?:=([\w\-, ]+))?")


def load_suppressions(source):
    """Map line number -> set of suppressed rule names ({'*'} = all).

    Tokenize-based so a ``# brlint:`` inside a string literal is not a
    suppression; falls back to a regex line scan if tokenization fails
    (the AST parse will surface the real syntax problem separately).
    """
    out = {}

    def add(lineno, spec):
        names = ({"*"} if spec is None else
                 {n.strip() for n in spec.split(",") if n.strip()})
        out.setdefault(lineno, set()).update(names)

    try:
        import io

        for tok in tokenize.generate_tokens(io.StringIO(source).readline):
            if tok.type == tokenize.COMMENT:
                m = _SUPPRESS_RE.search(tok.string)
                if m:
                    add(tok.start[0], m.group(1))
    except (tokenize.TokenError, IndentationError, SyntaxError):
        for k, line in enumerate(source.splitlines(), 1):
            m = _SUPPRESS_RE.search(line)
            if m:
                add(k, m.group(1))
    return out


class FileContext:
    """Everything a tier-A rule needs about one source file.  Rule
    selection is the runner's concern (:func:`lint_file`), not state
    here."""

    def __init__(self, path, source):
        self.path = path
        self.source = source
        self.lines = source.splitlines()
        self.tree = ast.parse(source, filename=path)
        self.index = reachability.ModuleIndex(self.tree, path)
        self.suppressions = load_suppressions(source)

    def suppressed(self, finding):
        # the flagged line, or the line directly above (long expressions
        # whose comment would overflow the flagged line)
        for ln in (finding.line, finding.line - 1):
            names = self.suppressions.get(ln)
            if names and ("*" in names or finding.rule in names):
                return True
        return False


def lint_file(path, select=None):
    """Run every registered rule over one file.

    Returns (findings, n_suppressed, source_lines) — the lines are the
    exact content the findings were computed from, for fingerprinting
    (re-reading the file could race an editor save).  Unparseable files
    yield a single ``parse-error`` finding rather than crashing the scan.
    """
    with open(path, encoding="utf-8") as fh:
        source = fh.read()
    lines = source.splitlines()
    try:
        ctx = FileContext(path, source)
    except SyntaxError as e:
        return [Finding("parse-error", path, e.lineno or 1, 0,
                        f"could not parse: {e.msg}")], 0, lines
    findings, n_suppressed = [], 0
    for name, rule in _RULES.items():
        if select is not None and name not in select:
            continue
        for f in rule(ctx):
            if ctx.suppressed(f):
                n_suppressed += 1
            else:
                findings.append(f)
    findings.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    return findings, n_suppressed, lines


def iter_python_files(paths):
    for p in paths:
        if os.path.isfile(p):
            yield p
        else:
            for root, dirs, files in os.walk(p):
                dirs[:] = sorted(d for d in dirs
                                 if d not in ("__pycache__", ".git"))
                for f in sorted(files):
                    if f.endswith(".py"):
                        yield os.path.join(root, f)


def lint_paths(paths, select=None):
    """Scan files/directories; returns (findings, n_suppressed, sources)
    with ``sources`` mapping path -> the scanned source lines (for
    fingerprints — the same content the findings came from)."""
    findings, n_suppressed, sources = [], 0, {}
    for path in iter_python_files(paths):
        fs, ns, lines = lint_file(path, select)
        findings.extend(fs)
        n_suppressed += ns
        sources[path] = lines
    return findings, n_suppressed, sources


def fingerprints(findings, sources):
    """Fingerprint per finding, in order: base content fingerprint plus
    an occurrence counter for repeats, so a NEW duplicate of an already
    baselined line still fails the scan (and fixing one of N duplicates
    surfaces a stale entry).  Deterministic because ``lint_paths`` emits
    findings sorted by (path, line)."""
    seen = {}
    out = []
    for f in findings:
        base = f.base_fingerprint(sources.get(f.path, []))
        k = seen.get(base, 0)
        seen[base] = k + 1
        out.append(base if k == 0 else f"{base}#{k}")
    return out


class Baseline:
    """Tracked-debt file: fingerprint -> {rule, path, note}.

    ``apply`` splits findings into (new, baselined) and reports stale
    entries (fingerprints no longer produced) so the file only shrinks.
    """

    def __init__(self, entries=None):
        self.entries = dict(entries or {})

    @classmethod
    def load(cls, path):
        if not os.path.exists(path):
            return cls()
        with open(path, encoding="utf-8") as fh:
            data = json.load(fh)
        return cls(data.get("findings", {}))

    def save(self, path):
        with open(path, "w", encoding="utf-8") as fh:
            json.dump({"format": 1, "findings": self.entries}, fh,
                      indent=1, sort_keys=True)
            fh.write("\n")

    @classmethod
    def from_findings(cls, findings, sources):
        entries = {}
        for f, fp in zip(findings, fingerprints(findings, sources)):
            entries[fp] = {"rule": f.rule,
                           "path": f.path, "message": f.message}
        return cls(entries)

    def apply(self, findings, sources):
        new, baselined, seen = [], [], set()
        for f, fp in zip(findings, fingerprints(findings, sources)):
            if fp in self.entries:
                baselined.append(f)
                seen.add(fp)
            else:
                new.append(f)
        stale = sorted(set(self.entries) - seen)
        return new, baselined, stale
