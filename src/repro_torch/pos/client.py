"""dataClay-like client & Logic Module (paper section 6).

Application classes are registered with the Logic Module; CAPre intercepts
the registration, runs the static analysis, and generates + injects the
prefetching methods.  A ``Session`` then executes registered methods against
the store under a prefetching mode resolved through the ``repro_torch.predict``
registry:

  * ``None``           — no prefetching (the paper's baseline),
  * ``"capre"``        — hint-driven prefetching (this paper),
  * ``"rop"``          — Referenced-Objects Predictor at a configurable
                         fetch depth (schema-based baseline),
  * ``"markov-miner"`` — order-k trace mining (monitoring-based baseline),
  * ``"hybrid"``       — static collections + mined single chains,

plus anything else registered via ``repro_torch.predict.register``.
"""

from __future__ import annotations

import itertools
import time
from dataclasses import dataclass, field
from typing import Optional

from repro_torch.core import lang
from repro_torch.core.hints import AnalysisReport, analyze_application
from repro_torch.core.injection import generate_all
from repro_torch.core.lower import lower_application
from repro_torch.core.type_graph import INCLUDE_BRANCH_DEPENDENT

from .executor import PrefetchRuntime
from .interp import Interpreter
from .store import ObjectStore


@dataclass
class RegisteredApp:
    app: lang.Application
    report: AnalysisReport
    prefetch_methods: dict[str, object]
    lowering_time_s: float = 0.0
    analysis_time_s: float = 0.0


class LogicModule:
    """Schema registry; CAPre hooks the registration process here."""

    def __init__(self):
        self.registered: dict[str, RegisteredApp] = {}

    def register(
        self, app: lang.Application, policy: str = INCLUDE_BRANCH_DEPENDENT
    ) -> RegisteredApp:
        t0 = time.perf_counter()
        lower_application(app)  # the "compilation" (Wala IR generation)
        t1 = time.perf_counter()
        report = analyze_application(app, policy=policy)
        prefetch = generate_all(report)
        t2 = time.perf_counter()
        reg = RegisteredApp(
            app=app,
            report=report,
            prefetch_methods=prefetch,
            lowering_time_s=t1 - t0,
            analysis_time_s=t2 - t1,
        )
        self.registered[app.name] = reg
        return reg


#: how predicted oids become prefetch work: "batch" groups a prediction by
#: owning Data Service and submits one deduped, need-ordered batch task per
#: service (the default); "per-oid" is the historical one-task-per-object
#: dispatch, kept for A/B sweeps (``bench_predictors --dispatch``)
DISPATCH_MODES = ("batch", "per-oid")


@dataclass
class SessionConfig:
    mode: Optional[str] = None  # None or any repro_torch.predict registry name
    rop_depth: int = 1
    parallel_workers: int = 8
    dispatch: str = "batch"  # see DISPATCH_MODES
    # trace-mined predictors (markov-miner / hybrid)
    markov_order: int = 2
    markov_confidence: float = 0.25
    markov_table_capacity: int = 65536
    markov_fanout: int = 8
    markov_chain: int = 4
    warm_trace: Optional[list] = None  # recorded ObjectStore.trace to mine
    # static-optimizer signals (core.opt annotations on the hints):
    # rfo=False ignores read-for-ownership marks (prefetches never
    # dirty-allocate — the A/B control for the write-path experiment);
    # max_outstanding > 0 arms the runtime's admission control, shedding
    # batches below admission_threshold priority once that many tasks are
    # outstanding
    rfo: bool = True
    max_outstanding: int = 0
    admission_threshold: float = 0.0
    # observability label: spans and registry sources this session creates
    # carry it (the per-tenant label scheme the future loadgen item will
    # drive; see DESIGN.md section 3.7)
    session_label: str = ""


# Process-monotonic default session labels.  The old scheme,
# ``id(self) & 0xFFFF``, collides trivially: CPython reuses freed object
# addresses, so open/close loops hand successive sessions the *same* label
# and their registry sources silently overwrite each other.
_session_ids = itertools.count(1)


class Session:
    def __init__(self, store: ObjectStore, reg: RegisteredApp, config: SessionConfig = None):
        self.store = store
        self.reg = reg
        self.app = reg.app
        self.config = config or SessionConfig()
        if self.config.dispatch not in DISPATCH_MODES:
            raise ValueError(
                f"unknown dispatch mode {self.config.dispatch!r}; "
                f"expected one of {DISPATCH_MODES}"
            )
        self.runtime = PrefetchRuntime(
            parallel_workers=self.config.parallel_workers,
            max_outstanding=self.config.max_outstanding,
            admission_threshold=self.config.admission_threshold,
        )
        # the store drains registered runtimes in reset_runtime_state so
        # straggler prefetch tasks cannot leak across benchmark repetitions
        store.register_runtime(self.runtime)
        # wire this session into the store's observability context (if one
        # is attached): its runtime queue depths become a registry source,
        # and spans opened while it runs carry its label
        self.label = self.config.session_label or f"s{next(_session_ids):04d}"
        # Spans are attributed per-call: the label rides every
        # prefetch/demand recording through the dispatch path (predictor ->
        # store.prefetch_* -> Tracer), never by mutating shared tracer
        # state.  Two concurrent labeled sessions therefore get
        # correctly-interleaved attribution, and close() has nothing
        # global to restore.
        self._tenant_stall_hist = None
        if store.obs is not None:
            store.obs.registry.register_source(
                f"runtime/{self.label}", self.runtime.stats
            )
            if self.config.session_label:
                # pre-resolved per-tenant stall histogram (hot path records
                # directly; only explicitly-labeled sessions get one so
                # anonymous open/close churn can't grow the registry)
                self._tenant_stall_hist = store.obs.registry.histogram(
                    "tenant_stall_s", tenant=self.label
                )
        # Save whatever listeners are already installed (another session's
        # monitoring) instead of clobbering them: a predictor bound below
        # may overwrite them, and close() puts the saved ones back.  A
        # mode=None session leaves the store's hooks entirely alone.
        self._saved_listeners = (store.miss_listener, store.access_listener)
        self.predictor = None
        if self.config.mode is not None:
            from repro_torch import predict

            self.predictor = predict.make_pos_predictor(self.config.mode, config=self.config)
            self.predictor.bind(self)

    # -- injected prefetch scheduling (the paper's Listing 5 hook) -----------

    def on_method_entry(self, method_key: str, this_oid: int) -> None:
        if self.store.trace is not None:
            self.store.trace_method_entry(method_key, this_oid)
        if self.predictor is not None:
            self.predictor.on_method_entry(method_key, this_oid)

    # -- execution ---------------------------------------------------------------

    def execute(self, root_oid: int, method: str, *args):
        interp = Interpreter(self)
        return interp.execute(root_oid, method, args)

    def drain(self, timeout: float = 60.0) -> bool:
        return self.runtime.drain(timeout)

    def close(self) -> None:
        if self.predictor is not None:
            # removes only the listeners this session's predictor installed
            self.predictor.unbind()
        for attr, saved in zip(("miss_listener", "access_listener"), self._saved_listeners):
            if saved is None or getattr(self.store, attr) is not None:
                continue
            # never resurrect a hook whose predictor has since unbound
            # (sessions closed out of LIFO order): a dead miner's listener
            # would silently keep charging monitoring on every access
            owner = getattr(saved, "predictor", None)
            if owner is None or owner.session is not None:
                setattr(self.store, attr, saved)
        self.runtime.shutdown()
        self.store.unregister_runtime(self.runtime)
        if self.store.obs is not None:
            self.store.obs.registry.unregister_source(f"runtime/{self.label}")

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


class POSClient:
    """Convenience facade: one store + one Logic Module."""

    def __init__(self, n_services: int = 4, latency=None, cache_capacity: int = 0,
                 cache_policy: str = "lru", shared_budget: bool = False,
                 placement: str = "round-robin", replication: int = 1,
                 write_quorum: int = 1, hedge: bool = False,
                 hedge_delay: Optional[float] = None):
        from .latency import ZERO

        self.store = ObjectStore(
            n_services=n_services, latency=latency or ZERO, cache_capacity=cache_capacity,
            cache_policy=cache_policy, shared_budget=shared_budget,
            placement=placement, replication=replication,
            write_quorum=write_quorum, hedge=hedge, hedge_delay=hedge_delay,
        )
        self.logic_module = LogicModule()

    def register(self, app: lang.Application, policy: str = INCLUDE_BRANCH_DEPENDENT) -> RegisteredApp:
        return self.logic_module.register(app, policy)

    def session(self, app_name: str, mode: Optional[str] = None, rop_depth: int = 1,
                parallel_workers: int = 8, **overrides) -> Session:
        reg = self.logic_module.registered[app_name]
        cfg = SessionConfig(mode=mode, rop_depth=rop_depth,
                            parallel_workers=parallel_workers, **overrides)
        return Session(self.store, reg, cfg)
