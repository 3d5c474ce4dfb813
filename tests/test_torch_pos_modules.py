"""The port's object store (``repro_torch.pos``), POS predictors and
replay harness (``repro_torch.predict``) and observability package
(``repro_torch.obs``) are the JAX package's text, on the CPU.

Each module is its JAX twin's text with the package renamed
(``re.sub(r"\\brepro\\b", "repro_torch", ...)``) and imports nothing but
the standard library and the port's host-side packages; the class the
port adds to a hand-written file, ``runtime.fault.StoreFaultDetector``, is
JAX's source, as are ``obs.Observability`` and the classes it builds on;
and importing them, replaying a workload, simulating load and exporting a
trace leave ``jax`` and ``repro`` out of ``sys.modules``.
"""

import ast
import inspect
import os
import re
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

SRC = Path(__file__).resolve().parent.parent / "src"
TWINS = [f"pos/{m}.py" for m in ("trace", "latency", "eviction", "placement", "store",
                                  "executor", "interp", "client", "__init__")] + [
    f"predict/{m}.py" for m in ("base", "rop", "static_capre", "markov", "hybrid",
                                "registry", "stream", "calibration", "evaluate",
                                "loadsim", "__init__")] + [
    f"obs/{m}.py" for m in ("export", "__init__")]
# the edits beside the renaming (a pattern and its replacement): three of
# JAX's docstrings name a change by its number in the project's history,
# which the port's copies leave out
EDITS = {"pos/placement.py": [(r"\n[A-Z]{2} \d+ made eviction a policy;",
                               "\nEviction is a policy (``eviction.py``);")],
         "obs/export.py": [(r"so [A-Z]{2} \d+'s demand-priority", "so the demand-priority")],
         "predict/loadsim.py": [(r"\(optionally one [A-Z]{2} \d+\n", "(optionally one\n")]}
HOST_PACKAGES = tuple(f"repro_torch.{p}" for p in ("core", "apps", "pos", "predict", "obs",
                                                   "runtime"))


@pytest.mark.parametrize("rel", TWINS)
def test_module_is_its_jax_twin_renamed(rel):
    """The port's module is its JAX twin's text with ``repro`` renamed
    ``repro_torch`` (and the edits listed above), and imports nothing but
    the standard library and the port's host-side packages (no torch, no
    jax, no numpy, nothing of ``repro``)."""
    text = (SRC / "repro_torch" / rel).read_text()
    jtext = (SRC / "repro" / rel).read_text()
    for pattern, new in EDITS.get(rel, ()):
        jtext, n = re.subn(pattern, new, jtext)
        assert n == 1, pattern
    assert text == re.sub(r"\brepro\b", "repro_torch", jtext)
    for node in ast.walk(ast.parse(text)):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module if node.module != "repro_torch"
                     else f"repro_torch.{a.name}" for a in node.names]
        else:
            continue
        for name in names:
            top = name.split(".")[0]
            assert top not in ("torch", "jax", "repro", "numpy"), name
            assert top != "repro_torch" or name.startswith(HOST_PACKAGES), name


def test_store_fault_detector_is_jax_source():
    from repro.runtime import fault as jfault
    from repro_torch.runtime import fault

    assert inspect.getsource(fault.StoreFaultDetector) == inspect.getsource(
        jfault.StoreFaultDetector)
    # what it builds on is JAX's too
    for name in ("HeartbeatMonitor", "StragglerDetector"):
        assert inspect.getsource(getattr(fault, name)) == inspect.getsource(
            getattr(jfault, name))


def test_observability_is_jax_source():
    import repro.obs as jobs
    import repro_torch.obs as obs

    assert inspect.getsource(obs.Observability) == inspect.getsource(jobs.Observability)
    for name in ("Registry", "Tracer", "Meter"):
        assert inspect.getsource(getattr(obs, name)) == inspect.getsource(
            getattr(jobs, name))


def test_pos_stack_imports_nothing_of_jax():
    """Importing the object store and every POS predictor, opening a
    session in each mode and running the bank app, then replaying it on
    the virtual clock, simulating two tenants, exporting a trace and
    loading a calibration leaves ``jax`` and ``repro`` out of
    ``sys.modules``; the registries of both packages name
    the same object-store and stream predictors."""
    code = textwrap.dedent("""
        import sys
        from repro_torch import predict
        from repro_torch.apps.bank import build_bank_app, populate_bank_store
        from repro_torch.obs import Observability
        from repro_torch.pos import POSClient
        from repro_torch.runtime.fault import StoreFaultDetector
        from repro_torch.obs import Tracer, chrome_trace, validate_chrome_trace
        from repro_torch.predict.calibration import load_calibration
        from repro_torch.predict.evaluate import _catalog, evaluate_workload, record_workload
        from repro_torch.predict.loadsim import run_loadsim
        c = POSClient(n_services=2)
        c.register(build_bank_app())
        root = populate_bank_store(c.store, n_transactions=4)
        c.store.attach_obs(Observability(tracing=True))
        for mode in (None, *predict.available("pos")):
            with c.session("bank", mode=mode) as s:
                s.execute(root, "auditAll")
                assert s.drain(10.0)
        wl = _catalog()["bank"]
        rows = evaluate_workload(wl, modes=("capre",), recorded=record_workload(wl))
        assert rows[0].recall >= 0.99
        assert run_loadsim(tenants=2, mix=("bank",)).rows()[-1]["tenant"] == "ALL"
        tracer = Tracer()
        tracer.predicted([1], t=0.0)
        tracer.drop_active(t=1.0)
        assert validate_chrome_trace(chrome_trace(tracer.spans(), clock="virtual")) == []
        assert not load_calibration("no-such-file.csv").fitted
        bad = sorted(m for m in sys.modules
                     if m == "jax" or m.startswith("jax.") or m == "repro"
                     or m.startswith("repro."))
        assert not bad, bad
        print("OK", predict.available("pos"), predict.available("stream"))
    """)
    env = dict(os.environ, PYTHONPATH=str(SRC))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       env=env, timeout=300)
    assert r.returncode == 0, r.stderr
    from repro import predict as jpredict

    want = f"OK {jpredict.available('pos')} {jpredict.available('stream')}"
    assert r.stdout.strip() == want
