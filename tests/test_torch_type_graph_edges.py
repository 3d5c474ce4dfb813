"""Twins of tests/test_type_graph_edges.py on the port: edge cases of the
augmented-type-graph analysis (``repro_torch.core.type_graph``) and the
static hint optimizer (``repro_torch.core.opt``) and the ``capre-lint``
verifier (``repro_torch.core.lint``), each also holding the port against
the JAX package: every hand-made app is built in both packages (objects
never cross them) and its graphs, call sites and hints compared by their
plain forms (``torch_capre_canon``).  Then the lint CLI of both packages
in subprocesses: the same exit code and stdout on the committed golden,
exit 2 from both on a drifted copy, and ``--write`` byte for byte the
committed golden.  Every comparison is exact.
"""

import json
import os
import subprocess
import sys
from dataclasses import replace
from types import SimpleNamespace

import pytest

from repro.core import hints as jhints
from repro.core import lang as jlang
from repro.core import lint as jlint
from repro.core import opt as jopt
from repro.core import type_graph as jtype_graph
from repro_torch.core import hints as phints
from repro_torch.core import lang
from repro_torch.core import lint as plint
from repro_torch.core import type_graph as ptype_graph
from repro_torch.core.hints import analyze_application
from repro_torch.core.lint import (
    DEFAULT_APPS,
    analyze,
    diff_golden,
    golden_payload,
    lint_report,
)
from repro_torch.core.opt import (
    DEFAULT_COLLECTION_FANOUT,
    DEFAULT_PREFIX_BOUND,
    hint_cost,
    hint_priority,
)
from repro_torch.core.type_graph import _covers_unconditional
from torch_capre_canon import call_sites_canon, report_canon

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
SRC = os.path.join(ROOT, "src")
GOLDEN = os.path.join(ROOT, "artifacts", "analysis", "hints.json")

PORT = SimpleNamespace(lang=lang, hints=phints, tg=ptype_graph, lint=plint)
JAX = SimpleNamespace(lang=jlang, hints=jhints, tg=jtype_graph, lint=jlint)


def _noop(L, name="noop"):
    return L.ExprStmt(L.Compute(lambda: None, (), name))


def _cond(L, name="c"):
    return L.Compute(lambda: True, (), name)


def _both(build):
    """``build(L)`` in the port and in JAX, each analysed and reported (no
    optimizer, as ``generate`` runs it); the port's analysis and report
    are returned after their plain forms are held equal to JAX's."""
    out = []
    for P in (PORT, JAX):
        analysis = P.tg.CAPreAnalysis(build(P.lang))
        out.append((analysis, P.hints.generate(analysis)))
    (analysis, report), (janalysis, jreport) = out
    assert report_canon(report) == report_canon(jreport)
    assert call_sites_canon(analysis) == call_sites_canon(janalysis)
    return analysis, report


# ---------------------------------------------------------------------------
# _covers_unconditional: nested conditionals
# ---------------------------------------------------------------------------

COVER_CASES = [
    {()},
    set(),
    {((1, 0, 2),)},
    {((1, 0, 2),), ((1, 1, 2),)},
    {((1, 1, 2),), ((1, 0, 2), (2, 0, 2)), ((1, 0, 2), (2, 1, 2))},
    {((1, 1, 2),), ((1, 0, 2), (2, 0, 2))},
    {((1, 0, 2), (2, 0, 2)), ((1, 1, 2), (3, 0, 2))},
    {((1, 0, 3),), ((1, 1, 3),), ((1, 2, 3), (4, 0, 1))},
]


def _same_cover(paths):
    got = _covers_unconditional(set(paths))
    assert got == jtype_graph._covers_unconditional(set(paths)), paths
    return got


def test_covers_unconditional_trivial_cases():
    assert _same_cover({()})
    assert not _same_cover(set())
    assert not _same_cover({((1, 0, 2),)})
    assert _same_cover({((1, 0, 2),), ((1, 1, 2),)})
    for paths in COVER_CASES:
        _same_cover(paths)


def test_covers_unconditional_nested_reduction():
    paths = {
        ((1, 1, 2),),
        ((1, 0, 2), (2, 0, 2)),
        ((1, 0, 2), (2, 1, 2)),
    }
    assert _same_cover(paths)
    assert not _same_cover(paths - {((1, 0, 2), (2, 1, 2))})


def test_covers_unconditional_incomplete_nested():
    assert not _same_cover({
        ((1, 0, 2), (2, 0, 2)),
        ((1, 1, 2), (3, 0, 2)),
    })


def _nested_app(L):
    leaf = L.ClassDef("Leaf", L.fields_of(L.FieldSpec("x")))
    node = L.ClassDef("Node", L.fields_of(L.FieldSpec("a", target="Leaf"),
                                          L.FieldSpec("b", target="Leaf")))
    node.add_method(L.MethodDef("m", params=(), body=[
        L.If(cond=_cond(L, "outer"),
             then=[L.If(cond=_cond(L, "inner"),
                        then=[L.ExprStmt(L.Get(L.This(), "a"))],
                        els=[L.ExprStmt(L.Get(L.This(), "a"))])],
             els=[L.ExprStmt(L.Get(L.This(), "a")),
                  L.ExprStmt(L.Get(L.This(), "b"))]),
    ]))
    return L.Application(name="nested", classes={c.name: c for c in (leaf, node)})


def test_nested_conditional_branch_dependence_end_to_end():
    _analysis, report = _both(_nested_app)
    children = report.graphs["Node.m"].this_root.children
    assert not children["a"].branch_dependent
    assert children["b"].branch_dependent


# ---------------------------------------------------------------------------
# loop taint x grafted callee subtrees
# ---------------------------------------------------------------------------


def _graft_app(L, caller_body):
    item = L.ClassDef("Item", L.fields_of(L.FieldSpec("detail", target="Detail"),
                                          L.FieldSpec("amount")))
    item.add_method(L.MethodDef("touch", params=(), ret_type=None, body=[
        L.ExprStmt(L.Get(L.Get(L.This(), "detail"), "amount")),
    ]))
    detail = L.ClassDef("Detail", L.fields_of(L.FieldSpec("amount")))
    box = L.ClassDef("Box", L.fields_of(
        L.FieldSpec("items", target="Item", card=L.COLLECTION)))
    box.add_method(L.MethodDef("scan", params=(), body=caller_body(L)))
    return L.Application(name="graft", classes={c.name: c for c in (item, detail, box)})


def test_grafted_subtree_inherits_loop_taint():
    def body(L):
        return [L.ForEach("it", L.This(), "items", [
            L.ExprStmt(L.Call(L.Var("it"), "touch")),
            L.Break(),
        ])]

    _analysis, report = _both(lambda L: _graft_app(L, body))
    items = report.graphs["Box.scan"].this_root.children["items"]
    detail = items.children["detail"]
    assert all(tainted for _bp, tainted in items.occurrences)
    assert all(tainted for _bp, tainted in detail.occurrences)
    assert items.branch_dependent and detail.branch_dependent


def test_grafted_subtree_clean_in_untainted_loop():
    def body(L):
        return [L.ForEach("it", L.This(), "items", [
            L.ExprStmt(L.Call(L.Var("it"), "touch")),
        ])]

    _analysis, report = _both(lambda L: _graft_app(L, body))
    detail = report.graphs["Box.scan"].this_root.children["items"].children["detail"]
    assert any(not tainted for _bp, tainted in detail.occurrences)
    assert not detail.branch_dependent


def _write_app(L):
    item = L.ClassDef("Item", L.fields_of(L.FieldSpec("amount"), L.FieldSpec("flag")))
    item.add_method(L.MethodDef("always", params=(), body=[
        L.SetField(L.This(), "amount", L.Compute(lambda: 1, (), "one")),
    ]))
    item.add_method(L.MethodDef("sometimes", params=(), body=[
        L.If(cond=_cond(L), then=[L.SetField(L.This(), "flag",
                                             L.Compute(lambda: 1, (), "one"))]),
    ]))
    box = L.ClassDef("Box", L.fields_of(
        L.FieldSpec("items", target="Item", card=L.COLLECTION)))
    box.add_method(L.MethodDef("creditEach", params=(), body=[
        L.ForEach("it", L.This(), "items", [L.ExprStmt(L.Call(L.Var("it"), "always"))]),
    ]))
    box.add_method(L.MethodDef("flagEach", params=(), body=[
        L.ForEach("it", L.This(), "items", [L.ExprStmt(L.Call(L.Var("it"), "sometimes"))]),
    ]))
    return L.Application(name="wr", classes={c.name: c for c in (item, box)})


def test_grafted_callee_write_set_propagates_conditionality():
    _analysis, report = _both(_write_app)
    credit = report.graphs["Box.creditEach"].this_root.children["items"]
    assert credit.written
    assert any(not t for _bp, t in credit.write_occurrences)
    flag = report.graphs["Box.flagEach"].this_root.children["items"]
    assert flag.written
    assert all(t for _bp, t in flag.write_occurrences)


# ---------------------------------------------------------------------------
# recursion cut: call recording + hints kept at every level
# ---------------------------------------------------------------------------


def _tree_app(L):
    node = L.ClassDef("Tree", L.fields_of(L.FieldSpec("left", target="Tree"),
                                          L.FieldSpec("val")))
    node.add_method(L.MethodDef("walk", params=(), body=[
        L.ExprStmt(L.Get(L.Get(L.This(), "left"), "val")),
        L.ExprStmt(L.Call(L.Get(L.This(), "left"), "walk")),
    ]))
    return L.Application(name="rec", classes={"Tree": node})


def test_recursion_cut_records_ungrafted_call_site():
    analysis, report = _both(_tree_app)
    sites = analysis.call_sites["Tree.walk"]
    assert sites and all(s.reason == "recursion" and not s.grafted for s in sites)
    assert report.hints_str("Tree.walk") == {"left"}


# ---------------------------------------------------------------------------
# all-callers dedup under dynamic dispatch
# ---------------------------------------------------------------------------


def _dispatch_app(L, overridden: bool):
    part = L.ClassDef("Part", L.fields_of(L.FieldSpec("name")))
    base = L.ClassDef("Base", L.fields_of(L.FieldSpec("part", target="Part")))
    base.add_method(L.MethodDef("work", params=(), body=[
        L.ExprStmt(L.Get(L.Get(L.This(), "part"), "name")),
    ]))
    classes = [part, base]
    if overridden:
        sub = L.ClassDef("Sub", supertype="Base")
        sub.add_method(L.MethodDef("work", params=(), body=[_noop(L)]))
        classes.append(sub)
    owner = L.ClassDef("Owner", L.fields_of(
        L.FieldSpec("bases", target="Base", card=L.COLLECTION)))
    owner.add_method(L.MethodDef("runAll", params=(), body=[
        L.ForEach("b", L.This(), "bases", [L.ExprStmt(L.Call(L.Var("b"), "work"))]),
    ]))
    classes.append(owner)
    return L.Application(name="dyn", classes={c.name: c for c in classes})


def test_all_callers_dedup_with_monomorphic_callee():
    analysis, report = _both(lambda L: _dispatch_app(L, overridden=False))
    assert report.full_hints_str("Base.work") == {"part"}
    assert report.hints_str("Base.work") == set()
    assert report.hints_str("Owner.runAll") == {"bases[].part"}
    assert all(s.grafted for s in analysis.call_sites["Base.work"])


def test_all_callers_dedup_skipped_under_dynamic_dispatch():
    analysis, report = _both(lambda L: _dispatch_app(L, overridden=True))
    assert report.hints_str("Base.work") == {"part"}
    assert report.hints_str("Owner.runAll") == {"bases[]"}
    sites = analysis.call_sites["Base.work"]
    assert all(not s.grafted and s.reason == "overridden" for s in sites)


# ---------------------------------------------------------------------------
# optimizer passes (core.opt)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def bank_report():
    from repro.apps.bank import build_bank_app as jbuild
    from repro_torch.apps.bank import build_bank_app

    report = analyze_application(build_bank_app())
    assert report_canon(report) == report_canon(jhints.analyze_application(jbuild()))
    return report


def test_opt_rfo_projection_on_bank(bank_report):
    by_method = {
        key: {str(h): h for h in hints}
        for key, hints in bank_report.hints.items()
    }
    credit = by_method["BankManagement.creditAll"]["transactions[]"]
    assert credit.rfo and credit.rfo_depths == (0,)
    setter = by_method["BankManagement.setAllTransCustomers"][
        "transactions[].account.cust.company"]
    assert setter.rfo_depths == (1,)
    audit = by_method["BankManagement.auditAll"][
        "transactions[].account.cust.company"]
    assert not audit.rfo


def test_opt_truncation_on_early_exit_scan(bank_report):
    hints = {str(h): h for h in
             bank_report.hints["BankManagement.findLargeTransaction"]}
    h = hints["transactions[].account.cust"]
    assert h.truncated
    assert h.trunc_step == 0
    assert h.prefix_bound == DEFAULT_PREFIX_BOUND == jopt.DEFAULT_PREFIX_BOUND
    audit = {str(h): h for h in bank_report.hints["BankManagement.auditAll"]}
    assert all(not h.truncated for h in audit.values())


def test_opt_cost_and_priority_model():
    single = (("a", lang.SINGLE), ("b", lang.SINGLE))
    assert hint_cost(single) == 2.0
    coll = (("xs", lang.COLLECTION),)
    assert hint_cost(coll) == DEFAULT_COLLECTION_FANOUT == jopt.DEFAULT_COLLECTION_FANOUT
    nested = (("xs", lang.COLLECTION), ("ys", lang.COLLECTION))
    assert hint_cost(nested) == (DEFAULT_COLLECTION_FANOUT
                                 + DEFAULT_COLLECTION_FANOUT ** 2)
    assert hint_cost(coll, prefix_bound=4, trunc_step=0) == 4.0
    costs = [1.0, 2.0, 16.0, 272.0]
    prios = [hint_priority(c) for c in costs]
    assert prios == sorted(prios, reverse=True)
    assert all(0.0 < p <= 1.0 for p in prios)
    for steps in (single, coll, nested, nested + single, single + coll):
        for kw in ({}, {"prefix_bound": 4, "trunc_step": 0}, {"fanout": 3},
                   {"prefix_bound": 2, "trunc_step": 1}):
            assert hint_cost(steps, **kw) == jopt.hint_cost(steps, **kw)
    for c in costs + [0.0, 0.5, 3.0, 1e6]:
        assert hint_priority(c) == jopt.hint_priority(c)


def test_opt_annotations_do_not_change_hint_identity(bank_report):
    h = bank_report.hints["BankManagement.creditAll"][0]
    plain = replace(h, rfo_depths=(), prefix_bound=None, trunc_step=None,
                    priority=0.0)
    assert plain == h and hash(plain) == hash(h)
    jh = jhints.Hint(h.steps)
    assert hash(jh) == hash(h)  # steps-only identity in both packages


# ---------------------------------------------------------------------------
# capre-lint (core.lint): verifier + golden drift
# ---------------------------------------------------------------------------


def _findings(P, name, mutate=None):
    app, analysis, report = P.lint.analyze(name)
    if mutate is not None:
        mutate(P, report)
    return [str(f) for f in P.lint.lint_report(app, analysis, report)]


def test_lint_clean_on_all_catalog_apps():
    assert DEFAULT_APPS == jlint.DEFAULT_APPS
    for name in DEFAULT_APPS:
        app, analysis, report = analyze(name)
        assert lint_report(app, analysis, report) == [], name
        assert _findings(JAX, name) == [], name


def _corrupt_annotations(P, report):
    key = "BankManagement.auditAll"
    h = report.hints[key][0]
    report.hints[key] = (
        replace(h, rfo_depths=(99,), trunc_step=1, prefix_bound=None,
                priority=7.0),
    ) + report.hints[key][1:]


def test_lint_flags_corrupted_annotations():
    app, analysis, report = analyze("bank")
    _corrupt_annotations(PORT, report)
    findings = lint_report(app, analysis, report)
    assert "bounds" in {f.kind for f in findings}
    assert [str(f) for f in findings] == _findings(JAX, "bank", _corrupt_annotations)


def _drift_schema(P, report):
    key = "BankManagement.auditAll"
    report.hints[key] = report.hints[key] + (
        P.hints.Hint((("no_such_field", P.lang.SINGLE),), priority=0.5),
    )


def test_lint_flags_schema_drift():
    app, analysis, report = analyze("bank")
    _drift_schema(PORT, report)
    findings = lint_report(app, analysis, report)
    assert any(f.kind == "schema" and "no_such_field" in f.message
               for f in findings)
    assert [str(f) for f in findings] == _findings(JAX, "bank", _drift_schema)


def test_golden_diff_detects_hint_and_annotation_drift():
    reports = {name: analyze(name)[2] for name in ("bank", "wordcount")}
    golden = golden_payload(reports)
    assert diff_golden(golden, golden_payload(reports)) == []
    jgolden = jlint.golden_payload({name: jlint.analyze(name)[2]
                                    for name in ("bank", "wordcount")})
    assert golden == jgolden
    mutated = golden_payload(reports)
    rec = mutated["apps"]["bank"]["methods"]["BankManagement.creditAll"][0]
    rec["priority"] = 0.9999
    drift = diff_golden(golden, mutated)
    assert drift and any("annotations changed" in d for d in drift)
    assert drift == jlint.diff_golden(golden, mutated)
    mutated2 = golden_payload(reports)
    mutated2["apps"]["bank"]["methods"].pop("BankManagement.creditAll")
    drift2 = diff_golden(golden, mutated2)
    assert any("disappeared" in d for d in drift2)
    assert drift2 == jlint.diff_golden(golden, mutated2)
    assert diff_golden(mutated2, golden) == jlint.diff_golden(mutated2, golden)


def test_committed_golden_matches_current_analysis():
    """The port's payload of the five apps equals the committed golden and
    JAX's payload, and each hint's record equals JAX's."""
    with open(GOLDEN) as fh:
        golden = json.load(fh)
    reports = {name: analyze(name)[2] for name in DEFAULT_APPS}
    jreports = {name: jlint.analyze(name)[2] for name in DEFAULT_APPS}
    current = golden_payload(reports)
    assert diff_golden(golden, current) == []
    assert current == golden == jlint.golden_payload(jreports)
    for name in DEFAULT_APPS:
        for key, hints in reports[name].hints.items():
            assert ([plint.hint_record(h) for h in hints]
                    == [jlint.hint_record(h) for h in jreports[name].hints[key]])


@pytest.mark.parametrize("policy", ["include", "exclude"])
def test_golden_payload_equals_jax_under_both_policies(policy):
    current = golden_payload({n: analyze(n, policy=policy)[2] for n in DEFAULT_APPS})
    assert current == jlint.golden_payload(
        {n: jlint.analyze(n, policy=policy)[2] for n in DEFAULT_APPS})


# ---------------------------------------------------------------------------
# the lint CLI of both packages
# ---------------------------------------------------------------------------


def _cli(package, *args, cwd):
    env = dict(os.environ, PYTHONPATH=SRC)
    return subprocess.run([sys.executable, "-m", f"{package}.core.lint", *args],
                          capture_output=True, text=True, env=env, cwd=cwd, timeout=300)


def test_lint_cli_compare_matches_jax(tmp_path):
    """``--compare`` against the committed golden: exit 0 and JAX's stdout
    line for line."""
    r = _cli("repro_torch", "--compare", "--golden", GOLDEN, cwd=tmp_path)
    j = _cli("repro", "--compare", "--golden", GOLDEN, cwd=tmp_path)
    assert (r.returncode, j.returncode) == (0, 0), r.stderr
    assert r.stdout.splitlines() == j.stdout.splitlines()
    assert r.stdout.splitlines()[-1] == f"# hint sets match {GOLDEN}"
    assert r.stderr == j.stderr == ""


def test_lint_cli_drifted_golden_exits_2_as_jax(tmp_path):
    """A drifted copy of the golden (a priority changed, a method's hints
    gone, a hint the analysis does not make): exit 2 from both, with the
    same drift lines; a missing golden: exit 2 from both."""
    with open(GOLDEN) as fh:
        golden = json.load(fh)
    methods = golden["apps"]["bank"]["methods"]
    methods["BankManagement.creditAll"][0]["priority"] = 0.1234
    methods.pop("BankManagement.auditAll")
    methods["BankManagement.creditAll"].append(dict(
        methods["BankManagement.creditAll"][0], path="transactions[].nowhere"))
    bad = tmp_path / "drifted.json"
    bad.write_text(json.dumps(golden, indent=2, sort_keys=True) + "\n")
    r = _cli("repro_torch", "--compare", "--golden", str(bad), cwd=tmp_path)
    j = _cli("repro", "--compare", "--golden", str(bad), cwd=tmp_path)
    assert (r.returncode, j.returncode) == (2, 2)
    assert r.stdout == j.stdout and r.stderr == j.stderr
    for what in ("annotations changed", "new hint", "hint disappeared"):
        assert what in r.stderr, what
    missing = str(tmp_path / "missing.json")
    r = _cli("repro_torch", "--compare", "--golden", missing, cwd=tmp_path)
    j = _cli("repro", "--compare", "--golden", missing, cwd=tmp_path)
    assert (r.returncode, j.returncode) == (2, 2)
    assert r.stderr == j.stderr


def test_lint_main_writes_the_committed_golden(tmp_path, capsys):
    """``main(["--write"])`` into a temporary file writes the committed
    golden byte for byte; ``main(["--compare"])`` then returns 0, and a
    subset of the apps under the other policy prints JAX's lines."""
    out = tmp_path / "hints.json"
    assert plint.main(["--write", "--golden", str(out)]) == 0
    with open(GOLDEN, "rb") as fh:
        assert out.read_bytes() == fh.read()
    assert plint.main(["--compare", "--golden", str(out)]) == 0
    capsys.readouterr()
    args = ["--apps", "bank,oo7", "--policy", "exclude", "--golden", str(out)]
    assert plint.main(args) == jlint.main(args) == 0
    got = capsys.readouterr().out.splitlines()
    assert got[:2] == got[2:] and got[0].startswith("bank: methods=")
