"""Referenced-Objects Predictor behind the unified interface.

Schema-based prediction (paper sections 1-2): on every application-path
cache miss, eagerly fetch the object's referenced **single** associations
up to ``rop_depth`` levels — never collections.  The expansion depends only
on the schema, never on the running code, which is what makes it cheap
(no monitoring, no mined tables) and rigid (zero recall on collection-only
models like K-Means, the paper's Figure 14).

Online this preserves the historical ``Session(mode="rop")`` behavior
verbatim (miss listener -> BFS fan-out on the parallel pool).  Offline the
replay harness treats the *first* access to an oid as its cold-cache miss
and collects the same BFS frontier via ``peek``.
"""

from __future__ import annotations

from repro_torch.core.rop import rop_referenced_fields

from .base import Predictor, table_bytes


class Rop(Predictor):
    def __init__(self, config=None):
        super().__init__()
        self.depth = getattr(config, "rop_depth", 1) if config is not None else 1
        self._fields: dict[str, list[tuple[str, str]]] = {}
        self._issued: set[int] = set()

    def attach(self, store, reg) -> None:
        super().attach(store, reg)
        app = reg.app
        self._fields = {cls: rop_referenced_fields(app, cls) for cls in app.classes}
        self.overhead.table_bytes = table_bytes(
            sum(len(v) for v in self._fields.values())
        )

    def bind(self, session) -> None:
        super().bind(session)
        self._listen(session.store, "miss_listener", lambda oid: self.on_miss(oid))

    # -- the BFS expansion (shared online/offline) --------------------------

    def _frontier(self, root_oid: int, fetch) -> list[int]:
        """BFS over single associations to ``self.depth``; ``fetch`` is
        applied to every referenced oid and the full frontier returned."""
        out: list[int] = []
        frontier = [root_oid]
        for _ in range(self.depth):
            nxt: list[int] = []
            for o in frontier:
                rec = self.store.record(o)
                for fld, _target in self._fields.get(rec.cls, ()):
                    ref = rec.fields.get(fld)
                    if ref is None:
                        continue
                    fetch(ref)
                    out.append(ref)
                    nxt.append(ref)
            frontier = nxt
            if not frontier:
                break
        return out

    def on_miss(self, oid: int) -> list[int]:
        if oid in self._issued:
            return []
        self._issued.add(oid)
        self.overhead.monitor_events += 1
        if self.session is not None:
            store = self.session.store
            runtime = self.session.runtime
            label = getattr(self.session, "label", "")
            if self._dispatch_mode() == "batch":
                # collect the frontier via peek (schema walk, no I/O), then
                # one deduped, need-ordered request per Data Service
                def bfs_batch(root_oid: int) -> None:
                    out = self._frontier(root_oid, lambda _ref: None)
                    self.overhead.predictions += len(out)
                    store.prefetch_batch(out, runtime=runtime,
                                         origin=f"rop:miss-{root_oid}",
                                         session=label)

                runtime.fan_out(bfs_batch, [oid])
                return []

            def bfs(root_oid: int) -> None:
                fetched = self._frontier(
                    root_oid,
                    lambda ref: store.prefetch_access(ref, session=label))
                self.overhead.predictions += len(fetched)

            runtime.fan_out(bfs, [oid])
            return []
        out = self._frontier(oid, lambda _ref: None)
        self.overhead.predictions += len(out)
        return out

    def on_access(self, oid: int, cls: str) -> list[int]:
        # offline replay only: a cold unbounded cache misses exactly on the
        # first access to each oid (online, the store's miss listener fires)
        if self.session is None:
            return self.on_miss(oid)
        return []
