"""Lowering from the OO application AST (``core.lang``) to the Wala-like IR
(``core.ir``) — the analogue of Wala producing an IR from Java source
(paper section 5.1.1, Listing 2).

``ForEach`` loops are lowered to the iterator()/hasNext()/conditionalbranch/
next()/goto pattern shown in the paper's Listing 2; the ``next()`` invocation
inside the loop is what Algorithm 1 recognizes as a collection association
navigation.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from . import ir, lang


@dataclass
class _Ctx:
    app: lang.Application
    instrs: list[ir.Instr] = field(default_factory=list)
    var_counter: int = 0
    # static types of variables (var id -> class name or None for primitives)
    var_types: dict[str, Optional[str]] = field(default_factory=dict)
    # local name -> var id
    env: dict[str, str] = field(default_factory=dict)
    branch_path: tuple[tuple[int, int, int], ...] = ()
    loop_path: tuple[int, ...] = ()
    cond_counter: int = 0
    loop_counter: int = 0
    this_var: str = "v1"

    def fresh(self, typ: Optional[str]) -> str:
        self.var_counter += 1
        v = f"v{self.var_counter}"
        self.var_types[v] = typ
        return v

    def emit(self, itype: str, params=None, def_var=None, used=()) -> ir.Instr:
        instr = ir.Instr(
            ii=len(self.instrs) + 1,
            itype=itype,
            params=params or {},
            def_var=def_var,
            used_vars=tuple(used),
            branch_path=self.branch_path,
            loop_path=self.loop_path,
        )
        self.instrs.append(instr)
        return instr


def lower_method(app: lang.Application, m: lang.MethodDef) -> ir.MethodIR:
    ctx = _Ctx(app=app)
    params: list[tuple[str, str, Optional[str]]] = []
    this = ctx.fresh(m.owner)
    ctx.env["this"] = this
    ctx.this_var = this
    params.append((this, "this", m.owner))
    for pname, ptype in m.params:
        v = ctx.fresh(ptype)
        ctx.env[pname] = v
        params.append((v, pname, ptype))
    _lower_block(ctx, m.body)
    return ir.MethodIR(owner=m.owner, name=m.name, params=tuple(params), instrs=ctx.instrs)


def lower_application(app: lang.Application) -> dict[str, ir.MethodIR]:
    return {m.key: lower_method(app, m) for m in app.all_methods()}


# ---------------------------------------------------------------------------


def _lower_block(ctx: _Ctx, stmts: list[lang.Stmt]) -> None:
    for s in stmts:
        _lower_stmt(ctx, s)


def _lower_stmt(ctx: _Ctx, s: lang.Stmt) -> None:
    if isinstance(s, lang.Let):
        v = _lower_expr(ctx, s.expr)
        ctx.env[s.var] = v
    elif isinstance(s, lang.ExprStmt):
        _lower_expr(ctx, s.expr)
    elif isinstance(s, lang.SetField):
        vo = _lower_expr(ctx, s.obj)
        vv = _lower_expr(ctx, s.value)
        owner = ctx.var_types.get(vo)
        spec = ctx.app.field_spec(owner, s.field) if owner else None
        ctx.emit(
            ir.PUTFIELD,
            params={
                "owner": owner,
                "field": s.field,
                "target": spec.target if spec else None,
                "card": spec.card if spec else lang.SINGLE,
                "persistent": bool(spec and spec.is_persistent),
            },
            used=(vo, vv),
        )
    elif isinstance(s, lang.If):
        vc = _lower_expr(ctx, s.cond)
        ctx.emit(ir.CONDBRANCH, params={"src": "if"}, used=(vc,))
        cid = ctx.cond_counter = ctx.cond_counter + 1
        saved = ctx.branch_path
        ctx.branch_path = saved + ((cid, 0, 2),)
        _lower_block(ctx, s.then)
        ctx.branch_path = saved + ((cid, 1, 2),)
        _lower_block(ctx, s.els)
        ctx.branch_path = saved
    elif isinstance(s, lang.While):
        lid = ctx.loop_counter = ctx.loop_counter + 1
        saved = ctx.loop_path
        ctx.loop_path = saved + (lid,)
        vc = _lower_expr(ctx, s.cond)
        ctx.emit(ir.CONDBRANCH, params={"src": "while"}, used=(vc,))
        _lower_block(ctx, s.body)
        ctx.emit(ir.GOTO, params={"src": "while"})
        ctx.loop_path = saved
    elif isinstance(s, lang.ForEach):
        _lower_foreach(ctx, s)
    elif isinstance(s, lang.ForEachLocal):
        vi = _lower_expr(ctx, s.iterable)
        lid = ctx.loop_counter = ctx.loop_counter + 1
        saved = ctx.loop_path
        ctx.loop_path = saved + (lid,)
        velem = ctx.fresh(None)
        ctx.emit(ir.COMPUTE, params={"label": "local-iter"}, def_var=velem, used=(vi,))
        ctx.env[s.var] = velem
        _lower_block(ctx, s.body)
        ctx.emit(ir.GOTO, params={"src": "foreach-local"})
        ctx.loop_path = saved
    elif isinstance(s, lang.Return):
        used = ()
        if s.expr is not None:
            used = (_lower_expr(ctx, s.expr),)
        ctx.emit(ir.RETURN, used=used)
    elif isinstance(s, lang.Break):
        ctx.emit(ir.BREAK)
    elif isinstance(s, lang.Continue):
        ctx.emit(ir.CONTINUE)
    else:  # pragma: no cover
        raise TypeError(f"unknown statement {type(s)}")


def _lower_foreach(ctx: _Ctx, s: lang.ForEach) -> None:
    """Listing-2 pattern: getfield -> iterator() -> hasNext()/condbranch ->
    next() inside the loop -> body -> goto."""
    vo = _lower_expr(ctx, s.obj)
    owner = ctx.var_types.get(vo)
    spec = ctx.app.field_spec(owner, s.field) if owner else None
    target = spec.target if spec else None
    vcoll = ctx.fresh(None)  # the collection itself is not an object node
    ctx.emit(
        ir.GETFIELD,
        params={
            "owner": owner,
            "field": s.field,
            "target": target,
            "card": lang.COLLECTION,
            "persistent": bool(spec and spec.is_persistent),
        },
        def_var=vcoll,
        used=(vo,),
    )
    viter = ctx.fresh(None)
    ctx.emit(ir.ITER_INIT, params={"of": s.field}, def_var=viter, used=(vcoll,))
    lid = ctx.loop_counter = ctx.loop_counter + 1
    saved = ctx.loop_path
    ctx.loop_path = saved + (lid,)
    vhn = ctx.fresh(None)
    ctx.emit(ir.ITER_HASNEXT, def_var=vhn, used=(viter,))
    ctx.emit(ir.CONDBRANCH, params={"src": "foreach"}, used=(vhn,))
    velem = ctx.fresh(target)
    ctx.emit(
        ir.ITER_NEXT,
        params={"owner": owner, "field": s.field, "target": target},
        def_var=velem,
        used=(viter,),
    )
    ctx.env[s.var] = velem
    _lower_block(ctx, s.body)
    ctx.emit(ir.GOTO, params={"src": "foreach"})
    ctx.loop_path = saved


def _lower_expr(ctx: _Ctx, e: lang.Expr) -> str:
    if isinstance(e, lang.This):
        return ctx.this_var
    if isinstance(e, lang.Var):
        if e.name not in ctx.env:
            raise NameError(f"undefined variable {e.name}")
        return ctx.env[e.name]
    if isinstance(e, lang.Const):
        v = ctx.fresh(None)
        ctx.emit(ir.CONST, params={"value": e.value}, def_var=v)
        return v
    if isinstance(e, lang.Get):
        vo = _lower_expr(ctx, e.obj)
        owner = ctx.var_types.get(vo)
        spec = ctx.app.field_spec(owner, e.field) if owner else None
        persistent = bool(spec and spec.is_persistent)
        target = spec.target if persistent else None
        card = spec.card if spec else lang.SINGLE
        v = ctx.fresh(target if (persistent and card == lang.SINGLE) else None)
        ctx.emit(
            ir.GETFIELD,
            params={
                "owner": owner,
                "field": e.field,
                "target": spec.target if spec else None,
                "card": card,
                "persistent": persistent,
            },
            def_var=v,
            used=(vo,),
        )
        return v
    if isinstance(e, lang.Call):
        vo = _lower_expr(ctx, e.obj)
        vargs = [_lower_expr(ctx, a) for a in e.args]
        owner = ctx.var_types.get(vo)
        is_user = owner is not None and owner in ctx.app.classes
        ret_type = None
        if is_user:
            try:
                ret_type = ctx.app.resolve_method(owner, e.method).ret_type
            except AttributeError:
                is_user = False
        v = ctx.fresh(ret_type)
        ctx.emit(
            ir.INVOKE,
            params={"owner": owner, "method": e.method, "is_user": is_user},
            def_var=v,
            used=tuple([vo] + vargs),
        )
        return v
    if isinstance(e, lang.Compute):
        vargs = [_lower_expr(ctx, a) for a in e.args]
        v = ctx.fresh(None)
        ctx.emit(ir.COMPUTE, params={"label": e.label, "fn": e.fn}, def_var=v, used=tuple(vargs))
        return v
    if isinstance(e, lang.New):
        v = ctx.fresh(e.cls)
        ctx.emit(ir.NEW, params={"cls": e.cls}, def_var=v)
        for fname, fexpr in e.inits.items():
            vv = _lower_expr(ctx, fexpr)
            spec = ctx.app.field_spec(e.cls, fname)
            ctx.emit(
                ir.PUTFIELD,
                params={"owner": e.cls, "field": fname, "target": spec.target,
                        "card": spec.card, "persistent": bool(spec and spec.is_persistent)},
                used=(v, vv),
            )
        return v
    raise TypeError(f"unknown expression {type(e)}")  # pragma: no cover
