"""The port's CAPre analysis (``repro_torch.core``) and benchmark apps
(``repro_torch.apps``) against the JAX package's, on the CPU.

Twins of tests/test_capre_bank_example.py (the paper's running example:
Listing 1, Figures 2-3, the PH_m set of section 4.3), each also holding the
port's result against JAX's; then parity over the five catalog apps: the
AST and the schema, the IR of every method, the augmented type graphs and
recorded call sites, the hints of both branch policies with every optimizer
annotation, the ROP baseline, the hint trees and the (oid, rfo) order in
which the generated prefetch methods load the apps' data, and the ``put``
calls of every ``populate_*``; last, each port module's text against its
JAX twin's with the package renamed.  Nothing here is floating-point
arithmetic that may differ, so every comparison is exact.  Both packages run in one
process, with one hash seed, so sets are iterated alike in both.
"""

import ast
import dataclasses
import re
from pathlib import Path

import pytest

from repro.apps import bank as jbank
from repro.apps import kmeans as jkmeans
from repro.apps import oo7 as joo7
from repro.apps import pga as jpga
from repro.apps import wordcount as jwordcount
from repro.core import injection as jinjection
from repro.core import lower as jlower
from repro.core.hints import analyze_application as janalyze_application
from repro.core.rop import rop_hints as jrop_hints
from repro.core.rop import rop_referenced_fields as jrop_referenced_fields
from repro.core.type_graph import CAPreAnalysis as JCAPreAnalysis
from repro_torch.apps import bank, kmeans, oo7, pga, wordcount
from repro_torch.apps.bank import build_bank_app
from repro_torch.core import injection, lang
from repro_torch.core import lower
from repro_torch.core.hints import analyze_application
from repro_torch.core.lower import lower_method
from repro_torch.core.rop import rop_hints, rop_referenced_fields
from repro_torch.core.type_graph import (
    CAPreAnalysis,
    EXCLUDE_BRANCH_DEPENDENT,
    INCLUDE_BRANCH_DEPENDENT,
)
from torch_capre_canon import (
    RecordingStore,
    SerialRuntime,
    call_sites_canon,
    canon,
    graph_canon,
    report_canon,
    schema_canon,
)

# name: (port builder, JAX builder)
APPS = {
    "bank": (bank.build_bank_app, jbank.build_bank_app),
    "wordcount": (wordcount.build_wordcount_app, jwordcount.build_wordcount_app),
    "kmeans": (kmeans.build_kmeans_app, jkmeans.build_kmeans_app),
    "oo7": (oo7.build_oo7_app, joo7.build_oo7_app),
    "pga": (pga.build_pga_app, jpga.build_pga_app),
}
# name: (port populate, JAX populate, arguments); the default seeds, and a
# second seed
POPULATE = {
    "bank": (bank.populate_bank_store, jbank.populate_bank_store, {}),
    "bank-seed5": (bank.populate_bank_store, jbank.populate_bank_store,
                   {"n_transactions": 40, "n_companies": 5, "seed": 5}),
    "wordcount": (wordcount.populate_wordcount, jwordcount.populate_wordcount, {}),
    "wordcount-seed2": (wordcount.populate_wordcount, jwordcount.populate_wordcount,
                        {"n_collections": 2, "chunks_per_text": 8, "seed": 2}),
    "kmeans": (kmeans.populate_kmeans, jkmeans.populate_kmeans, {}),
    "kmeans-seed9": (kmeans.populate_kmeans, jkmeans.populate_kmeans,
                     {"n_vectors": 64, "n_collections": 2, "dims": 3, "seed": 9}),
    "oo7": (oo7.populate_oo7, joo7.populate_oo7, {}),
    "oo7-medium": (oo7.populate_oo7, joo7.populate_oo7, {"size": "medium", "seed": 1}),
    "pga": (pga.populate_pga, jpga.populate_pga, {}),
    "pga-seed4": (pga.populate_pga, jpga.populate_pga,
                  {"n_vertices": 50, "out_degree": 3, "seed": 4}),
}
POLICIES = (INCLUDE_BRANCH_DEPENDENT, EXCLUDE_BRANCH_DEPENDENT)


@pytest.fixture(scope="module")
def app():
    return build_bank_app()


@pytest.fixture(scope="module")
def japp():
    return jbank.build_bank_app()


# ---------------------------------------------------------------------------
# twins of tests/test_capre_bank_example.py
# ---------------------------------------------------------------------------


def test_application_type_graph_matches_figure_2a(app, japp):
    """Section 4.2.1 example associations of G_T."""
    assoc = app.type_graph()
    assert assoc[("BankManagement", "transactions")] == ("Transaction", lang.COLLECTION)
    assert assoc[("Transaction", "account")] == ("Account", lang.SINGLE)
    assert assoc[("Employee", "dept")] == ("Department", lang.SINGLE)
    assert assoc[("Account", "cust")] == ("Customer", lang.SINGLE)
    assert assoc[("Customer", "company")] == ("Company", lang.SINGLE)
    assert ("TransactionType", "typeID") not in assoc  # primitive: not in G_T
    assert list(assoc.items()) == list(japp.type_graph().items())


def test_ir_of_setalltranscustomers_matches_listing_2(app, japp):
    """The lowered IR follows the Listing 2 pattern: getfield transactions,
    iterator(), hasNext(), conditional branch, next(), getAccount(),
    getfield manager, setCustomer(), goto."""
    mir = lower_method(app, app.method("BankManagement", "setAllTransCustomers"))
    kinds = [i.itype for i in mir.instrs]
    assert kinds == [
        "getfield",  # v2 = getfield transactions : v1
        "iterator",  # v3 = iterator() : v2
        "hasnext",  # v4 = hasNext() : v3
        "conditionalbranch",
        "next",  # v5 = next() : v3
        "invokemethod",  # v6 = getAccount() : v5
        "getfield",  # v7 = getfield manager : v1
        "invokemethod",  # setCustomer() : v6, v7
        "goto",
    ]
    nxt = mir.instrs[4]
    assert nxt.has_loop_parent and not nxt.has_conditional_parent
    inv = mir.instrs[7]
    assert inv.used_vars == ("v6", "v7")
    jmir = jlower.lower_method(japp, japp.method("BankManagement", "setAllTransCustomers"))
    assert canon(mir) == canon(jmir)
    assert mir.dump() == jmir.dump()


def test_getaccount_branch_dependence_matches_figure_2b(app, japp):
    """In getAccount(): `type` is navigated in the condition (never branch
    dependent); `emp` is navigated in BOTH branches; `emp.dept` only in the
    else branch (branch-dependent); `account` is the returned navigation."""
    analysis = CAPreAnalysis(app)
    g = analysis.graph_of("Transaction.getAccount")
    root = g.this_root
    assert set(root.children) == {"type", "emp", "account"}
    assert not root.children["type"].branch_dependent
    assert not root.children["emp"].branch_dependent
    dept = root.children["emp"].children["dept"]
    assert dept.branch_dependent
    assert root.children["account"].is_return
    jg = JCAPreAnalysis(japp).graph_of("Transaction.getAccount")
    assert graph_canon(g) == graph_canon(jg)


def test_ph_m_exclude_policy_matches_paper_section_4_3(app, japp):
    """The PH_m printed in section 4.3, reproduced exactly under the
    conservative policy."""
    report = analyze_application(app, policy=EXCLUDE_BRANCH_DEPENDENT)
    got = report.hints_str("BankManagement.setAllTransCustomers")
    assert got == {
        "transactions[].type",
        "transactions[].emp",
        "transactions[].account.cust.company",
        "manager.company",
    }
    jreport = janalyze_application(japp, policy=EXCLUDE_BRANCH_DEPENDENT)
    assert report_canon(report) == report_canon(jreport)


def test_ph_m_include_policy_adds_branch_dependent_dept(app, japp):
    """CAPre's implementation choice (section 4.4): include branch-dependent
    navigations — the union of both branches adds transactions[].emp.dept."""
    report = analyze_application(app, policy=INCLUDE_BRANCH_DEPENDENT)
    got = report.hints_str("BankManagement.setAllTransCustomers")
    assert got == {
        "transactions[].type",
        "transactions[].emp.dept",
        "transactions[].account.cust.company",
        "manager.company",
    }
    jreport = janalyze_application(japp, policy=INCLUDE_BRANCH_DEPENDENT)
    assert report_canon(report) == report_canon(jreport)


def test_caller_dedup_empties_invoked_methods(app, japp):
    """Section 5.1.3: hints found in all callers are removed."""
    report = analyze_application(app)
    assert report.full_hints_str("Transaction.getAccount") != set()
    assert report.hints_str("Transaction.getAccount") == set()
    assert report.hints_str("Account.setCustomer") == set()
    assert report.hints_str("BankManagement.setAllTransCustomers") != set()
    jreport = janalyze_application(japp)
    for key in report.hints:
        assert report.hints_str(key) == jreport.hints_str(key), key
        assert report.full_hints_str(key) == jreport.full_hints_str(key), key


def test_rop_hints_depth_expansion(app, japp):
    """Section 3: ROP with depth 1 on Transaction predicts TransactionType,
    Account and Employee; depth 2 adds Department and Customer; collections
    are never predicted."""
    d1 = {str(h) for h in rop_hints(app, "Transaction", 1)}
    assert d1 == {"type", "account", "emp"}
    d2 = {str(h) for h in rop_hints(app, "Transaction", 2)}
    assert d2 == {"type", "account.cust", "emp.dept"}
    d3 = {str(h) for h in rop_hints(app, "Transaction", 3)}
    assert d3 == {"type", "account.cust.company", "emp.dept"}
    bm = {str(h) for h in rop_hints(app, "BankManagement", 5)}
    assert all("transactions" not in h for h in bm)
    assert "manager.company" in bm
    for depth in range(6):
        for cls in app.classes:
            assert ([h.steps for h in rop_hints(app, cls, depth)]
                    == [h.steps for h in jrop_hints(japp, cls, depth)]), (cls, depth)


def test_no_branch_dependent_stats(app, japp):
    report = analyze_application(app)
    s = report.stats
    assert s.n_methods == 8
    assert s.n_methods_no_bd == 5
    assert s.n_conditionals >= 2
    js = janalyze_application(japp).stats
    assert dataclasses.asdict(s) == dataclasses.asdict(js)
    assert (s.pct_methods_no_bd, s.pct_conditionals_no_bd, s.pct_loops_no_bd) == (
        js.pct_methods_no_bd, js.pct_conditionals_no_bd, js.pct_loops_no_bd)


# ---------------------------------------------------------------------------
# parity over the five catalog apps
# ---------------------------------------------------------------------------


def _both(name):
    port, jax_ = APPS[name]
    return port(), jax_()


@pytest.mark.parametrize("name", list(APPS))
def test_app_ast_and_schema_equal_jax(name):
    a, j = _both(name)
    assert canon(a) == canon(j)
    assert schema_canon(a) == schema_canon(j)
    for m in a.all_methods():
        assert a.is_overridden(m.owner, m.name) == j.is_overridden(m.owner, m.name)
    for cls in a.classes:
        assert a.subtypes(cls) == j.subtypes(cls)


@pytest.mark.parametrize("name", list(APPS))
def test_ir_of_every_method_equals_jax(name):
    a, j = _both(name)
    mir, jmir = lower.lower_application(a), jlower.lower_application(j)
    assert list(mir) == list(jmir)
    assert len(mir) == len(a.all_methods())
    for key in mir:
        assert canon(mir[key]) == canon(jmir[key]), key
        assert mir[key].dump() == jmir[key].dump(), key


@pytest.mark.parametrize("name", list(APPS))
def test_type_graphs_and_call_sites_equal_jax(name):
    a, j = _both(name)
    analysis, janalysis = CAPreAnalysis(a), JCAPreAnalysis(j)
    graphs, jgraphs = analysis.analyze_all(), janalysis.analyze_all()
    assert list(graphs) == list(jgraphs)
    for key in graphs:
        assert graph_canon(graphs[key]) == graph_canon(jgraphs[key]), key
    assert call_sites_canon(analysis) == call_sites_canon(janalysis)


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("name", list(APPS))
def test_hints_equal_jax(name, policy):
    """Every method's hints before and after the caller dedup, in order,
    with the optimizer's RFO depths, truncation and priority; and without
    the optimizer."""
    a, j = _both(name)
    for optimize in (True, False):
        report = analyze_application(a, policy=policy, optimize=optimize)
        jreport = janalyze_application(j, policy=policy, optimize=optimize)
        assert report_canon(report) == report_canon(jreport)
    assert any(report.hints.values())


@pytest.mark.parametrize("name", list(APPS))
def test_rop_equal_jax(name):
    a, j = _both(name)
    for cls in a.classes:
        assert rop_referenced_fields(a, cls) == jrop_referenced_fields(j, cls), cls
        for depth in (1, 2, 3, 8):
            assert ([(str(h), h.steps) for h in rop_hints(a, cls, depth)]
                    == [(str(h), h.steps) for h in jrop_hints(j, cls, depth)]), (cls, depth)


@pytest.mark.parametrize("name", list(POPULATE))
def test_populate_puts_equal_jax(name):
    """Every ``put`` (class, fields, locality group) and ``peek`` that a
    ``populate_*`` makes, in order, and the root it returns."""
    fn, jfn, kw = POPULATE[name]
    store, jstore = RecordingStore(), RecordingStore()
    root, jroot = fn(store, **kw), jfn(jstore, **kw)
    assert root == jroot
    assert store.calls == jstore.calls
    assert store.state() == jstore.state()
    assert len(store.records) > 10


def test_initial_centroids_equal_jax():
    for k, dims, seed in ((4, 10, 5), (3, 2, 0)):
        assert (kmeans.initial_centroids(k, dims, seed)
                == jkmeans.initial_centroids(k, dims, seed))


def _tree_canon(t) -> tuple:
    return (t.fld, t.card, t.rfo, t.prefix_bound, t.priority,
            tuple(_tree_canon(c) for c in t.ordered_children()))


# each catalog app's data: its entry of POPULATE
INJECT = {"bank": "bank", "wordcount": "wordcount-seed2", "kmeans": "kmeans-seed9",
          "oo7": "oo7", "pga": "pga-seed4"}


@pytest.mark.parametrize("name", list(INJECT))
def test_injection_access_order_equals_jax(name):
    """``generate_all``'s prefetch closures, run on each app's data from
    every object of the method's owner class (the first eight), ask the
    store for the same (oid, rfo) in the same order as JAX's; the merged
    hint trees are equal node for node."""
    a, j = _both(name)
    report, jreport = analyze_application(a), janalyze_application(j)
    gen, jgen = injection.generate_all(report), jinjection.generate_all(jreport)
    assert list(gen) == list(jgen) and gen
    for key, hints in report.hints.items():
        assert (_tree_canon(injection.build_hint_tree(hints))
                == _tree_canon(jinjection.build_hint_tree(jreport.hints[key]))), key
        assert (injection.tree_rfo_nodes(injection.build_hint_tree(hints))
                == jinjection.tree_rfo_nodes(jinjection.build_hint_tree(jreport.hints[key])))
    fn, jfn, kw = POPULATE[INJECT[name]]
    store, jstore = RecordingStore(), RecordingStore()
    fn(store, **kw)
    jfn(jstore, **kw)
    for key in gen:
        owner = key.split(".", 1)[0]
        roots = [oid for oid, r in store.records.items() if r.cls == owner][:8]
        for oid in roots:
            store.accesses.clear()
            jstore.accesses.clear()
            gen[key](store, SerialRuntime(), oid)
            jgen[key](jstore, SerialRuntime(), oid)
            assert store.accesses == jstore.accesses, (key, oid)
    assert store.state() == jstore.state()  # a prefetch writes nothing


def test_injection_on_bank_loads_the_hinted_closure(app):
    """setAllTransCustomers' prefetch from the root loads the root first,
    every transaction and each one's hinted closure, with the accounts (the
    update site) and only they read for ownership."""
    report = analyze_application(app)
    fn = injection.generate_all(report)["BankManagement.setAllTransCustomers"]
    store = RecordingStore()
    root = bank.populate_bank_store(store, n_transactions=6, seed=1)
    fn(store, SerialRuntime(), root)
    loaded = [store.records[oid].cls for oid, _rfo in store.accesses]
    assert loaded[0] == "BankManagement"
    assert loaded.count("Transaction") == 6
    rfo = {store.records[oid].cls for oid, r in store.accesses if r}
    assert rfo == {"Account"}
    assert set(loaded) == {"BankManagement", "Transaction", "TransactionType", "Employee",
                           "Department", "Account", "Customer", "Company"}


# ---------------------------------------------------------------------------
# the modules: each its JAX twin with the package renamed
# ---------------------------------------------------------------------------

SRC = Path(__file__).resolve().parent.parent / "src"
TWINS = [f"core/{m}.py" for m in ("lang", "ir", "lower", "type_graph", "hints", "opt",
                                   "rop", "injection", "corpus", "lint")] + [
    f"apps/{m}.py" for m in ("__init__", "bank", "wordcount", "kmeans", "oo7", "pga")]


@pytest.mark.parametrize("rel", TWINS)
def test_module_is_its_jax_twin_renamed(rel):
    """The port's module is its JAX twin's text with ``repro.core`` and
    ``repro.apps`` renamed, and imports nothing but the standard library
    and the port's own CAPre modules (no torch, no jax, nothing of
    ``repro``)."""
    text = (SRC / "repro_torch" / rel).read_text()
    jtext = (SRC / "repro" / rel).read_text()
    renamed = re.sub(r"\brepro\.(core|apps)\b", r"repro_torch.\1", jtext)
    assert text == renamed
    for node in ast.walk(ast.parse(text)):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module]
        else:
            continue
        for name in names:
            top = name.split(".")[0]
            assert top not in ("torch", "jax", "repro", "numpy"), name
            assert top != "repro_torch" or name.startswith(("repro_torch.core",
                                                            "repro_torch.apps")), name
