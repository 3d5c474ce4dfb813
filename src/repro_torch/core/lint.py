"""capre-lint — Pass 4 of the static hint optimizer: the verifier
(DESIGN.md section 3.9).

Passes 1–3 (:mod:`repro_torch.core.opt`) decorate the analysis output; this pass
*checks* it.  Hints are data that ride from registration time into every
dispatch path, golden artifact and replay fingerprint, so a malformed hint
(schema drift after an app edit, a hand-edited golden, an optimizer
regression) fails loudly here instead of silently mis-prefetching:

  * **schema** — every hint path must type-check against the application
    type graph: each step resolves to a persistent association on the
    walked class (supertype chain included) with the recorded cardinality;
  * **unreachable** — an association whose target class is missing from
    the schema is a dangling edge: the path walks into a type that cannot
    be reached (or even instantiated);
  * **depth** — hint depth is bounded (:data:`MAX_HINT_DEPTH`): the
    analysis cuts recursion, so an over-deep path means graph corruption;
  * **bounds** — optimizer annotations are internally consistent:
    ``rfo_depths`` index real steps, truncation carries both
    ``trunc_step`` (a collection step) and a positive ``prefix_bound``,
    priority sits in (0, 1];
  * **shadowed** — the section 5.1.3 all-callers dedup is re-derived from
    scratch and must reproduce the report's kept set exactly: a kept hint
    every caller covers (or a dropped hint some caller does not) means
    the dedup and the graphs have drifted apart.

``--compare`` diffs the freshly-analyzed hints of every checked app
against the committed golden (``artifacts/analysis/hints.json`` by
default) and fails on any drift — the CI gate that makes hint-set changes
reviewable instead of silent.  ``--write`` regenerates the golden.

Exit codes: 0 clean, 1 lint findings, 2 golden drift (or missing golden).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from dataclasses import dataclass
from typing import Callable, Optional

from . import lang
from .hints import AnalysisReport, Hint, _dedup_against_callers, generate, method_paths
from .opt import optimize_report
from .type_graph import CAPreAnalysis, INCLUDE_BRANCH_DEPENDENT

#: deepest hint path the analysis can legitimately emit: recursion is cut
#: at the back edge, so depth is bounded by the longest acyclic navigation
#: chain in the schema — far below this, generously rounded up
MAX_HINT_DEPTH = 16

#: the committed golden hint-set artifact (the ``--compare`` reference)
DEFAULT_GOLDEN = os.path.join("artifacts", "analysis", "hints.json")

#: the apps whose hint sets are golden-gated
DEFAULT_APPS = ("bank", "wordcount", "kmeans", "oo7", "pga")


def _builders() -> dict[str, Callable[[], lang.Application]]:
    from repro_torch.apps import bank, kmeans, oo7, pga, wordcount

    return {
        "bank": bank.build_bank_app,
        "wordcount": wordcount.build_wordcount_app,
        "kmeans": kmeans.build_kmeans_app,
        "oo7": oo7.build_oo7_app,
        "pga": pga.build_pga_app,
    }


@dataclass(frozen=True)
class Finding:
    app: str
    method: str
    hint: str
    kind: str  # schema | unreachable | depth | bounds | shadowed
    message: str

    def __str__(self) -> str:
        where = f"{self.app}:{self.method}"
        if self.hint:
            where += f" {self.hint}"
        return f"[{self.kind}] {where}: {self.message}"


# ---------------------------------------------------------------------------
# per-hint checks
# ---------------------------------------------------------------------------


def _check_path(app: lang.Application, owner: str, h: Hint) -> list[str]:
    """Type-check one hint path against the schema, walking from the
    method's receiver class.  Returns problem strings (empty = clean)."""
    problems: list[str] = []
    cls = owner
    for i, (fld, card) in enumerate(h.steps):
        try:
            spec = app.field_spec(cls, fld)
        except AttributeError:
            problems.append(f"step {i} ({fld}): no field {fld!r} on {cls}")
            break
        if not spec.is_persistent:
            problems.append(
                f"step {i} ({fld}): primitive field, not a persistent association"
            )
            break
        if spec.card != card:
            problems.append(
                f"step {i} ({fld}): cardinality {card!r} but schema says {spec.card!r}"
            )
        if spec.target not in app.classes:
            problems.append(
                f"step {i} ({fld}): unreachable target class {spec.target!r}"
            )
            break
        cls = spec.target
    return problems


def _check_bounds(h: Hint) -> list[str]:
    """Optimizer-annotation consistency for one hint."""
    problems: list[str] = []
    n = len(h.steps)
    for d in h.rfo_depths:
        if not (0 <= d < n):
            problems.append(f"rfo depth {d} outside [0, {n})")
    if tuple(sorted(set(h.rfo_depths))) != tuple(h.rfo_depths):
        problems.append(f"rfo depths {h.rfo_depths} not sorted/unique")
    if (h.trunc_step is None) != (h.prefix_bound is None):
        problems.append(
            f"truncation half-set: trunc_step={h.trunc_step} "
            f"prefix_bound={h.prefix_bound}"
        )
    if h.trunc_step is not None:
        if not (0 <= h.trunc_step < n):
            problems.append(f"trunc step {h.trunc_step} outside [0, {n})")
        elif h.steps[h.trunc_step][1] != lang.COLLECTION:
            problems.append(
                f"trunc step {h.trunc_step} ({h.steps[h.trunc_step][0]}) "
                "is not a collection step"
            )
    if h.prefix_bound is not None and h.prefix_bound <= 0:
        problems.append(f"non-positive prefix bound {h.prefix_bound}")
    if not (0.0 < h.priority <= 1.0):
        problems.append(f"priority {h.priority} outside (0, 1]")
    return problems


def _check_shadowing(analysis: CAPreAnalysis,
                     report: AnalysisReport) -> list[Finding]:
    """Re-derive the all-callers dedup from the graphs and demand it
    reproduces the report's kept hint sets exactly."""
    findings: list[Finding] = []
    paths = {k: method_paths(g, report.policy) for k, g in report.graphs.items()}
    for key, full in report.full_hints.items():
        rederived = {
            str(h) for h in _dedup_against_callers(
                analysis, report.graphs, paths, key, full)
        }
        kept = report.hints_str(key)
        for extra in sorted(kept - rederived):
            findings.append(Finding(
                report.app_name, key, extra, "shadowed",
                "kept hint is covered by every caller (dedup missed it)"))
        for missing in sorted(rederived - kept):
            findings.append(Finding(
                report.app_name, key, missing, "shadowed",
                "dropped hint is NOT covered by every caller (over-dedup)"))
    return findings


# ---------------------------------------------------------------------------
# per-app lint
# ---------------------------------------------------------------------------


def lint_report(app: lang.Application, analysis: CAPreAnalysis,
                report: AnalysisReport) -> list[Finding]:
    """All checks over one app's analyzed + optimized report."""
    findings: list[Finding] = []
    for key, hints in report.hints.items():
        owner = key.split(".", 1)[0]
        if owner not in app.classes:
            findings.append(Finding(
                report.app_name, key, "", "schema",
                f"method key owner {owner!r} not in schema"))
            continue
        for h in hints:
            for msg in _check_path(app, owner, h):
                kind = "unreachable" if "unreachable" in msg else "schema"
                findings.append(Finding(report.app_name, key, str(h), kind, msg))
            if len(h.steps) > MAX_HINT_DEPTH:
                findings.append(Finding(
                    report.app_name, key, str(h), "depth",
                    f"depth {len(h.steps)} exceeds bound {MAX_HINT_DEPTH}"))
            for msg in _check_bounds(h):
                findings.append(Finding(report.app_name, key, str(h), "bounds", msg))
    findings.extend(_check_shadowing(analysis, report))
    return findings


def analyze(name: str, policy: str = INCLUDE_BRANCH_DEPENDENT
            ) -> tuple[lang.Application, CAPreAnalysis, AnalysisReport]:
    """Build + analyze + optimize one catalog app, keeping the analysis
    object (its call sites feed the shadowing re-derivation)."""
    app = _builders()[name]()
    analysis = CAPreAnalysis(app)
    report = generate(analysis, policy)
    optimize_report(report, app=app)
    return app, analysis, report


# ---------------------------------------------------------------------------
# golden hint-set artifact
# ---------------------------------------------------------------------------


def hint_record(h: Hint) -> dict:
    """The JSON shape one hint takes in the golden (annotations included:
    optimizer drift is hint drift)."""
    return {
        "path": str(h),
        "rfo_depths": list(h.rfo_depths),
        "trunc_step": h.trunc_step,
        "prefix_bound": h.prefix_bound,
        "priority": h.priority,
    }


def golden_payload(reports: dict[str, AnalysisReport]) -> dict:
    return {
        "version": 1,
        "apps": {
            name: {
                "stats": report.opt.snapshot() if report.opt else {},
                "methods": {
                    key: [hint_record(h)
                          for h in sorted(hints, key=str)]
                    for key, hints in sorted(report.hints.items())
                    if hints
                },
            }
            for name, report in sorted(reports.items())
        },
    }


def diff_golden(golden: dict, current: dict) -> list[str]:
    """Human-readable structural drift between two golden payloads (empty
    list = identical hint sets)."""
    drift: list[str] = []
    g_apps, c_apps = golden.get("apps", {}), current.get("apps", {})
    for name in sorted(set(g_apps) | set(c_apps)):
        if name not in c_apps:
            drift.append(f"{name}: app missing from current analysis")
            continue
        if name not in g_apps:
            drift.append(f"{name}: app not in golden (re-run --write?)")
            continue
        g_m, c_m = g_apps[name].get("methods", {}), c_apps[name].get("methods", {})
        for key in sorted(set(g_m) | set(c_m)):
            g_hints = {h["path"]: h for h in g_m.get(key, [])}
            c_hints = {h["path"]: h for h in c_m.get(key, [])}
            for path in sorted(g_hints.keys() - c_hints.keys()):
                drift.append(f"{name}:{key}: hint disappeared: {path}")
            for path in sorted(c_hints.keys() - g_hints.keys()):
                drift.append(f"{name}:{key}: new hint: {path}")
            for path in sorted(g_hints.keys() & c_hints.keys()):
                if g_hints[path] != c_hints[path]:
                    drift.append(
                        f"{name}:{key}: {path}: annotations changed "
                        f"{g_hints[path]} -> {c_hints[path]}")
    return drift


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------


def main(argv: Optional[list[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="capre-lint",
        description="verify analyzed prefetch hints and gate the golden hint-set",
    )
    ap.add_argument("--apps", default=",".join(DEFAULT_APPS),
                    help="comma-separated catalog apps to lint")
    ap.add_argument("--policy", default=INCLUDE_BRANCH_DEPENDENT,
                    help="branch-dependence policy (include/exclude)")
    ap.add_argument("--golden", default=DEFAULT_GOLDEN,
                    help="golden hint-set JSON path")
    ap.add_argument("--write", action="store_true",
                    help="regenerate the golden from the current analysis")
    ap.add_argument("--compare", action="store_true",
                    help="fail (exit 2) if current hints drift from the golden")
    args = ap.parse_args(argv)

    apps = tuple(a for a in args.apps.split(",") if a)
    reports: dict[str, AnalysisReport] = {}
    findings: list[Finding] = []
    for name in apps:
        app, analysis, report = analyze(name, policy=args.policy)
        reports[name] = report
        app_findings = lint_report(app, analysis, report)
        findings.extend(app_findings)
        shadowed = sum(
            len(report.full_hints[k]) - len(report.hints[k])
            for k in report.full_hints
        )
        s = report.opt
        print(f"{name}: methods={s.methods} hints={s.hints} "
              f"rfo={s.rfo_hints} truncated={s.truncated_hints} "
              f"caller-shadowed={shadowed} findings={len(app_findings)}")

    for f in findings:
        print(str(f), file=sys.stderr)

    current = golden_payload(reports)
    if args.write:
        os.makedirs(os.path.dirname(args.golden) or ".", exist_ok=True)
        with open(args.golden, "w") as fh:
            json.dump(current, fh, indent=2, sort_keys=True)
            fh.write("\n")
        print(f"# wrote {args.golden}")

    rc = 1 if findings else 0
    if args.compare:
        if not os.path.exists(args.golden):
            print(f"# golden {args.golden} missing — run --write and commit it",
                  file=sys.stderr)
            return 2
        with open(args.golden) as fh:
            golden = json.load(fh)
        drift = diff_golden(golden, current)
        for line in drift:
            print(f"drift: {line}", file=sys.stderr)
        if drift:
            print(f"# {len(drift)} hint-set drift(s) vs {args.golden}; "
                  "if intended, regenerate with --write and commit",
                  file=sys.stderr)
            return 2
        print(f"# hint sets match {args.golden}")
    return rc


if __name__ == "__main__":
    sys.exit(main())
