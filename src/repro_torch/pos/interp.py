"""AST interpreter: executes ``core.lang`` applications against the
distributed POS with full cost accounting.

This plays the role of the JVM running the (injected) application inside
dataClay's Data Services:

  * navigating an association redirects execution to the owning Data Service
    and ensures the object is in its memory (``ObjectStore.app_access``);
  * on entry to a registered method the injected scheduling submits the
    generated prefetch method to the background executor (Listing 5) — the
    ``Session`` decides per the configured prefetch mode;
  * primitive field reads touch the already-loaded payload; writes go
    through ``ObjectStore.app_write`` — write-allocate through the owning
    Data Service's cache, dirty bit, deferred write-back on eviction (what
    dominates OO7's t2 traversals under bounded caches);
  * dynamic dispatch resolves methods from the *runtime* class, so
    polymorphic schemas (OO7 assemblies) behave exactly like in Java.
"""

from __future__ import annotations

import itertools
import sys
from dataclasses import dataclass
from typing import Any, Optional

from repro_torch.core import lang
from .store import ExecutionContext, ObjectStore, PersistentObject

# Deeply recursive traversals (OO7, PGA's DFS) cost ~12 Python frames per
# interpreted call — the JVM equivalent is a large thread stack.  Pure-Python
# recursion in CPython 3.12+ does not consume C stack, so this is safe.
if sys.getrecursionlimit() < 200_000:
    sys.setrecursionlimit(200_000)


@dataclass(frozen=True)
class ObjRef:
    oid: int


class _Return(Exception):
    def __init__(self, value):
        self.value = value


class _Break(Exception):
    pass


class _Continue(Exception):
    pass


_volatile_ids = itertools.count(-1, -1)


class Interpreter:
    def __init__(self, session):
        self.session = session
        self.store: ObjectStore = session.store
        self.app: lang.Application = session.app
        self.volatile: dict[int, PersistentObject] = {}

    # -- object helpers ------------------------------------------------------

    def _is_volatile(self, oid: int) -> bool:
        return oid < 0

    def _record(self, oid: int) -> PersistentObject:
        if self._is_volatile(oid):
            return self.volatile[oid]
        return self.store.record(oid)

    def _access(self, ctx: ExecutionContext, oid: int) -> PersistentObject:
        if self._is_volatile(oid):
            return self.volatile[oid]
        return self.store.app_access(ctx, oid)

    # -- execution -----------------------------------------------------------

    def execute(self, root_oid: int, method: str, args: tuple = (), ctx: Optional[ExecutionContext] = None):
        if ctx is None:
            # the context carries the session's tenant identity so every
            # demand span / stall sample this thread produces is attributed
            # to the right tenant even under concurrent sessions
            ctx = ExecutionContext(
                self.store,
                session_label=getattr(self.session, "label", ""),
                stall_hist=getattr(self.session, "_tenant_stall_hist", None),
            )
        return self._invoke(ctx, ObjRef(root_oid), method, tuple(args))

    def _invoke(self, ctx: ExecutionContext, receiver: ObjRef, method: str, args: tuple):
        rec = self._access(ctx, receiver.oid)
        mdef = self.app.resolve_method(rec.cls, method)
        # --- the injected prefetch scheduling (Listing 5) ---
        self.session.on_method_entry(mdef.key, receiver.oid)
        env: dict[str, Any] = {"this": receiver}
        for (pname, _ptype), val in zip(mdef.params, args):
            env[pname] = val
        try:
            self._exec_block(ctx, env, mdef.body)
        except _Return as r:
            return r.value
        return None

    def _exec_block(self, ctx, env, stmts) -> None:
        for s in stmts:
            self._exec_stmt(ctx, env, s)

    def _exec_stmt(self, ctx, env, s) -> None:
        if isinstance(s, lang.Let):
            env[s.var] = self._eval(ctx, env, s.expr)
        elif isinstance(s, lang.ExprStmt):
            self._eval(ctx, env, s.expr)
        elif isinstance(s, lang.SetField):
            self._exec_setfield(ctx, env, s)
        elif isinstance(s, lang.If):
            branch = s.then if self._eval(ctx, env, s.cond) else s.els
            self._exec_block(ctx, env, branch)
        elif isinstance(s, lang.While):
            while self._eval(ctx, env, s.cond):
                try:
                    self._exec_block(ctx, env, s.body)
                except _Break:
                    break
                except _Continue:
                    continue
        elif isinstance(s, lang.ForEach):
            obj = self._eval(ctx, env, s.obj)
            rec = self._record(obj.oid)
            for e in list(rec.fields.get(s.field) or ()):
                self._access(ctx, e)
                env[s.var] = ObjRef(e)
                try:
                    self._exec_block(ctx, env, s.body)
                except _Break:
                    break
                except _Continue:
                    continue
        elif isinstance(s, lang.ForEachLocal):
            items = self._eval(ctx, env, s.iterable)
            for it in list(items or ()):
                env[s.var] = it
                try:
                    self._exec_block(ctx, env, s.body)
                except _Break:
                    break
                except _Continue:
                    continue
        elif isinstance(s, lang.Return):
            raise _Return(self._eval(ctx, env, s.expr) if s.expr is not None else None)
        elif isinstance(s, lang.Break):
            raise _Break()
        elif isinstance(s, lang.Continue):
            raise _Continue()
        else:  # pragma: no cover
            raise TypeError(f"unknown statement {type(s)}")

    def _exec_setfield(self, ctx, env, s: lang.SetField) -> None:
        obj = self._eval(ctx, env, s.obj)
        val = self._eval(ctx, env, s.value)
        rec = self._record(obj.oid)
        spec = self.app.field_spec(rec.cls, s.field)
        if spec.is_persistent:
            if spec.card == lang.COLLECTION:
                rec.fields[s.field] = [v.oid for v in (val or [])]
            else:
                rec.fields[s.field] = val.oid if isinstance(val, ObjRef) else val
        else:
            rec.fields[s.field] = val
        if not self._is_volatile(obj.oid):
            # a write is a demand access: it redirects execution to the
            # owning Data Service and write-allocates through its cache
            self.store.app_write(obj.oid, ctx)

    # -- expressions -----------------------------------------------------------

    def _eval(self, ctx, env, e):
        if isinstance(e, lang.This):
            return env["this"]
        if isinstance(e, lang.Var):
            return env[e.name]
        if isinstance(e, lang.Const):
            return e.value
        if isinstance(e, lang.Get):
            obj = self._eval(ctx, env, e.obj)
            rec = self._record(obj.oid)
            spec = self.app.field_spec(rec.cls, e.field)
            val = rec.fields.get(e.field)
            if not spec.is_persistent:
                return val
            if spec.card == lang.COLLECTION:
                return [ObjRef(o) for o in (val or [])]
            if val is None:
                return None
            self._access(ctx, val)
            return ObjRef(val)
        if isinstance(e, lang.Call):
            obj = self._eval(ctx, env, e.obj)
            args = tuple(self._eval(ctx, env, a) for a in e.args)
            return self._invoke(ctx, obj, e.method, args)
        if isinstance(e, lang.Compute):
            args = [self._eval(ctx, env, a) for a in e.args]
            return e.fn(*args)
        if isinstance(e, lang.New):
            oid = next(_volatile_ids)
            rec = PersistentObject(oid=oid, cls=e.cls, fields={})
            self.volatile[oid] = rec
            ref = ObjRef(oid)
            for fname, fexpr in e.inits.items():
                val = self._eval(ctx, env, fexpr)
                rec.fields[fname] = val.oid if isinstance(val, ObjRef) else val
            return ref
        raise TypeError(f"unknown expression {type(e)}")  # pragma: no cover
