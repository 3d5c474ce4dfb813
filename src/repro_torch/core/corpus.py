"""Seeded random application generator — our stand-in for the SF110 corpus
(paper section 4.4): a population of OO applications with varying schema
sizes, navigation patterns, conditionals, loops and branching instructions,
used to reproduce the Table 2 statistics and the Figure 8 analysis-time
distribution.

Generated applications are *analyzable* (schema-consistent navigations) but
not meant to be executed.
"""

from __future__ import annotations

import random

from . import lang
from .lang import (
    Application,
    Break,
    Call,
    ClassDef,
    Compute,
    Const,
    ExprStmt,
    FieldSpec,
    ForEach,
    Get,
    If,
    Let,
    MethodDef,
    Return,
    This,
    Var,
)


def generate_app(
    seed: int,
    n_classes: int = 8,
    methods_per_class: int = 3,
    stmts_per_method: int = 6,
) -> Application:
    rng = random.Random(seed)
    names = [f"C{i}" for i in range(n_classes)]
    classes: dict[str, ClassDef] = {}

    # --- schema ---------------------------------------------------------
    for name in names:
        fields = {}
        n_persistent = rng.randint(1, 3)
        for j in range(n_persistent):
            card = lang.COLLECTION if rng.random() < 0.3 else lang.SINGLE
            fields[f"f{j}"] = FieldSpec(f"f{j}", target=rng.choice(names), card=card)
        fields["p0"] = FieldSpec("p0")
        classes[name] = ClassDef(name, fields)

    # --- method bodies ----------------------------------------------------
    def nav_chain(cls: str, depth: int) -> tuple[lang.Expr, str]:
        """A chain of single-association navigations from this."""
        expr: lang.Expr = This()
        cur = cls
        for _ in range(depth):
            singles = [f for f in classes[cur].fields.values() if f.is_persistent and f.card == lang.SINGLE]
            if not singles:
                break
            f = rng.choice(singles)
            expr = Get(expr, f.name)
            cur = f.target
        return expr, cur

    def random_stmts(cls: str, depth_budget: int) -> list[lang.Stmt]:
        stmts: list[lang.Stmt] = []
        for _ in range(rng.randint(1, stmts_per_method)):
            roll = rng.random()
            if roll < 0.35:
                expr, _t = nav_chain(cls, rng.randint(1, 3))
                stmts.append(ExprStmt(expr))
            elif roll < 0.55:
                colls = [f for f in classes[cls].fields.values() if f.card == lang.COLLECTION]
                if colls and depth_budget > 0:
                    f = rng.choice(colls)
                    inner: list[lang.Stmt] = [ExprStmt(Get(Var("e"), "p0"))]
                    singles = [
                        g for g in classes[f.target].fields.values()
                        if g.is_persistent and g.card == lang.SINGLE
                    ]
                    if singles:
                        inner.append(ExprStmt(Get(Var("e"), rng.choice(singles).name)))
                    if rng.random() < 0.25:
                        inner.append(
                            If(Compute(lambda: False, (), "cond"), then=[Break()])
                        )
                    stmts.append(ForEach("e", This(), f.name, inner))
            elif roll < 0.8 and depth_budget > 0:
                # conditional: sometimes both branches access the same
                # navigation (the common case per the paper), sometimes not
                expr_a, _ = nav_chain(cls, 1)
                same = rng.random() < 0.6
                then = [ExprStmt(expr_a)]
                els = [ExprStmt(expr_a)] if same else random_stmts(cls, depth_budget - 1)
                stmts.append(If(Compute(lambda: True, (), "cond"), then=then, els=els))
            else:
                mcls = rng.choice(names)
                if classes[mcls].methods:
                    mname = rng.choice(list(classes[mcls].methods))
                    singles = [
                        f for f in classes[cls].fields.values()
                        if f.is_persistent and f.card == lang.SINGLE and f.target == mcls
                    ]
                    if singles:
                        stmts.append(ExprStmt(Call(Get(This(), singles[0].name), mname)))
        if not stmts:
            stmts.append(ExprStmt(Const(0)))
        return stmts

    for name in names:
        for k in range(rng.randint(1, methods_per_class)):
            classes[name].add_method(MethodDef(f"m{k}", params=(), body=random_stmts(name, 2)))

    return Application(name=f"synthetic_{seed}", classes=classes)


def generate_corpus(n_apps: int = 40, base_seed: int = 100) -> list[Application]:
    rng = random.Random(base_seed)
    apps = []
    for i in range(n_apps):
        apps.append(
            generate_app(
                seed=base_seed + i,
                n_classes=rng.randint(3, 30),
                methods_per_class=rng.randint(1, 6),
                stmts_per_method=rng.randint(3, 10),
            )
        )
    return apps
