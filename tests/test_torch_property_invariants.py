"""Twins of the CAPre property tests of tests/test_property_invariants.py
on the port (``repro_torch.core``), over randomly generated applications
(``repro_torch.core.corpus``), each also holding the port against the JAX
package; and the corpus itself against JAX's.

  * the analysis always terminates and every hint is a valid navigation
    path through the application type graph G_T (schema soundness);
  * conservative (exclude) paths are a subset of the include policy's;
  * caller-deduplicated hints are a subset of the full hints;
  * ``generate_app`` builds, for seeds 0-199 at its default sizes and for
    drawn seeds and sizes, the same app as JAX's, whose hints (both
    policies, every optimizer annotation), graphs, call sites, golden
    payload and lint findings equal JAX's; ``generate_corpus`` likewise.

Every comparison is exact.  The sharding-rule property test of that file
has its twin in tests/test_torch_shardings.py.
"""

import pytest

pytest.importorskip("hypothesis", reason="property tests need hypothesis")
from hypothesis import given, settings, strategies as st  # noqa: E402

from repro.core import corpus as jcorpus  # noqa: E402
from repro.core import hints as jhints  # noqa: E402
from repro.core import lint as jlint  # noqa: E402
from repro.core import opt as jopt  # noqa: E402
from repro.core import type_graph as jtype_graph  # noqa: E402
from repro_torch.core import lint  # noqa: E402
from repro_torch.core.corpus import generate_app, generate_corpus  # noqa: E402
from repro_torch.core.hints import analyze_application, generate, method_paths  # noqa: E402
from repro_torch.core.opt import optimize_report  # noqa: E402
from repro_torch.core.type_graph import (  # noqa: E402
    EXCLUDE_BRANCH_DEPENDENT,
    INCLUDE_BRANCH_DEPENDENT,
    CAPreAnalysis,
)
from torch_capre_canon import call_sites_canon, canon, graph_canon, report_canon  # noqa: E402

POLICIES = (INCLUDE_BRANCH_DEPENDENT, EXCLUDE_BRANCH_DEPENDENT)


def _same_analysis(app, japp) -> None:
    """One generated app in both packages: the AST, then per policy the
    report and its golden payload, the lint findings, and the call sites."""
    assert canon(app) == canon(japp)
    for policy in POLICIES:
        report = analyze_application(app, policy=policy)
        jreport = jhints.analyze_application(japp, policy=policy)
        assert report_canon(report) == report_canon(jreport), (app.name, policy)
        assert (lint.golden_payload({app.name: report})
                == jlint.golden_payload({japp.name: jreport}))
    analysis, janalysis = CAPreAnalysis(app), jtype_graph.CAPreAnalysis(japp)
    report = generate(analysis)
    optimize_report(report, app=app)
    jreport = jhints.generate(janalysis)
    jopt.optimize_report(jreport, app=japp)
    assert ([str(f) for f in lint.lint_report(app, analysis, report)]
            == [str(f) for f in jlint.lint_report(japp, janalysis, jreport)])
    assert call_sites_canon(analysis) == call_sites_canon(janalysis)


@settings(max_examples=30, deadline=None)
@given(
    seed=st.integers(0, 10_000),
    n_classes=st.integers(2, 12),
    mpc=st.integers(1, 4),
)
def test_analysis_terminates_and_hints_are_schema_valid(seed, n_classes, mpc):
    app = generate_app(seed, n_classes=n_classes, methods_per_class=mpc)
    report = analyze_application(app)
    assoc = app.type_graph()
    by_owner = {}
    for (owner, fld), (target, card) in assoc.items():
        by_owner.setdefault(owner, {})[fld] = (target, card)

    def owner_chain_ok(start_cls, steps):
        cur = start_cls
        for fld, card in steps:
            fields = {}
            t = cur
            while t is not None:  # include supertype fields
                fields.update(by_owner.get(t, {}))
                t = app.classes[t].supertype if t in app.classes else None
            assert fld in fields, f"hint step {fld} not a field of {cur}"
            target, decl_card = fields[fld]
            assert card == decl_card
            cur = target

    for key, hints in report.full_hints.items():
        owner = key.split(".")[0]
        for h in hints:
            owner_chain_ok(owner, h.steps)
    japp = jcorpus.generate_app(seed, n_classes=n_classes, methods_per_class=mpc)
    assert report_canon(report) == report_canon(jhints.analyze_application(japp))
    assert list(assoc.items()) == list(japp.type_graph().items())


@settings(max_examples=20, deadline=None)
@given(seed=st.integers(0, 10_000))
def test_exclude_policy_paths_subset_of_include(seed):
    app = generate_app(seed, n_classes=6, methods_per_class=3)
    graphs = CAPreAnalysis(app).analyze_all()
    jgraphs = jtype_graph.CAPreAnalysis(
        jcorpus.generate_app(seed, n_classes=6, methods_per_class=3)).analyze_all()
    assert list(graphs) == list(jgraphs)
    for key, g in graphs.items():
        excl = method_paths(g, EXCLUDE_BRANCH_DEPENDENT)
        incl = method_paths(g, INCLUDE_BRANCH_DEPENDENT)
        assert excl <= incl
        assert graph_canon(g) == graph_canon(jgraphs[key])
        assert excl == jhints.method_paths(jgraphs[key], EXCLUDE_BRANCH_DEPENDENT)
        assert incl == jhints.method_paths(jgraphs[key], INCLUDE_BRANCH_DEPENDENT)


@settings(max_examples=20, deadline=None)
@given(seed=st.integers(0, 10_000))
def test_dedup_hints_subset_of_full(seed):
    app = generate_app(seed, n_classes=8, methods_per_class=3)
    report = analyze_application(app)
    for key in report.hints:
        assert set(report.hints[key]) <= set(report.full_hints[key])
    jreport = jhints.analyze_application(
        jcorpus.generate_app(seed, n_classes=8, methods_per_class=3))
    assert report_canon(report) == report_canon(jreport)


def test_generate_app_equals_jax_over_200_seeds():
    """Seeds 0-199 at ``generate_app``'s default sizes."""
    for seed in range(200):
        _same_analysis(generate_app(seed), jcorpus.generate_app(seed))


@settings(max_examples=30, deadline=None)
@given(
    seed=st.integers(0, 1_000_000),
    n_classes=st.integers(1, 16),
    mpc=st.integers(1, 5),
    stmts=st.integers(1, 10),
)
def test_generate_app_equals_jax_at_drawn_sizes(seed, n_classes, mpc, stmts):
    kw = dict(n_classes=n_classes, methods_per_class=mpc, stmts_per_method=stmts)
    _same_analysis(generate_app(seed, **kw), jcorpus.generate_app(seed, **kw))


@pytest.mark.parametrize("n_apps,base_seed", [(6, 100), (4, 7)])
def test_generate_corpus_equals_jax(n_apps, base_seed):
    apps = generate_corpus(n_apps=n_apps, base_seed=base_seed)
    japps = jcorpus.generate_corpus(n_apps=n_apps, base_seed=base_seed)
    assert [a.name for a in apps] == [a.name for a in japps]
    assert len(apps) == n_apps
    for app, japp in zip(apps, japps):
        _same_analysis(app, japp)
