"""Object-oriented application language (AST) for CAPre.

CAPre (Touma et al., FGCS 2019) analyzes Java applications through IBM Wala:
source -> AST + IR -> augmented method type graphs -> prefetching hints.

We reproduce the same pipeline with a small object-oriented AST that plays the
role of the Java source / Wala AST.  A single definition of an application is
used by BOTH:

  * ``core.lower``      -- lowers the AST to a Wala-like IR (``core.ir``) that
                           Algorithm 1 (``core.type_graph``) consumes, and
  * ``pos.interp``      -- executes the AST against the distributed persistent
                           object store, with latency accounting.

This guarantees the static analysis and the executed program can never drift
apart (the paper has the same property: Wala analyzes the bytecode that runs).

The language supports exactly the constructs the paper's analysis handles:
field navigations (single / collection associations), primitive field access,
method invocation (with dynamic dispatch), conditionals, loops with
break/continue/return, and opaque primitive computation.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Callable, Optional, Sequence

SINGLE = "single"
COLLECTION = "collection"


# ---------------------------------------------------------------------------
# Schema
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class FieldSpec:
    """A member field of a class.

    ``target`` is a class name for persistent associations and ``None`` for
    primitive fields.  ``card`` distinguishes single vs collection
    associations (paper section 4.2.1).
    """

    name: str
    target: Optional[str] = None
    card: str = SINGLE

    @property
    def is_persistent(self) -> bool:
        return self.target is not None


@dataclass
class ClassDef:
    name: str
    fields: dict[str, FieldSpec] = field(default_factory=dict)
    methods: dict[str, "MethodDef"] = field(default_factory=dict)
    supertype: Optional[str] = None

    def add_method(self, m: "MethodDef") -> "ClassDef":
        m.owner = self.name
        self.methods[m.name] = m
        return self


def fields_of(*specs: FieldSpec) -> dict[str, FieldSpec]:
    return {s.name: s for s in specs}


# ---------------------------------------------------------------------------
# Expressions
# ---------------------------------------------------------------------------


class Expr:
    pass


@dataclass
class This(Expr):
    pass


@dataclass
class Var(Expr):
    name: str


@dataclass
class Const(Expr):
    value: Any


@dataclass
class Get(Expr):
    """Field access ``obj.field``.

    If the field is a persistent association this is an association
    navigation; if it is primitive it is ignored by the analysis (paper:
    "instructions that involve fields of primitive types ... are not part of
    the graph").
    """

    obj: Expr
    field: str


@dataclass
class Call(Expr):
    """Method invocation ``obj.method(args...)`` with dynamic dispatch."""

    obj: Expr
    method: str
    args: tuple[Expr, ...] = ()


@dataclass
class Compute(Expr):
    """Opaque primitive computation.

    ``fn`` runs over the evaluated argument values at interpretation time.
    The static analysis treats it like arithmetic over primitives: it defines
    a non-persistent value and triggers no navigations.  ``label`` is only for
    debugging.
    """

    fn: Callable[..., Any]
    args: tuple[Expr, ...] = ()
    label: str = "compute"


@dataclass
class New(Expr):
    """Allocate a fresh (volatile) object of a persistent class.

    Used by update traversals; allocation itself is not a navigation.
    """

    cls: str
    inits: dict[str, Expr] = field(default_factory=dict)


# ---------------------------------------------------------------------------
# Statements
# ---------------------------------------------------------------------------


class Stmt:
    pass


@dataclass
class Let(Stmt):
    var: str
    expr: Expr


@dataclass
class SetField(Stmt):
    """``obj.field = value`` — a putfield.  Primitive stores mark the object
    dirty (write-back cost in the POS); reference stores rewire associations.
    putfield is not an association navigation (Table 3 does not include it),
    but evaluating ``obj`` may navigate.
    """

    obj: Expr
    field: str
    value: Expr


@dataclass
class ExprStmt(Stmt):
    expr: Expr


@dataclass
class If(Stmt):
    cond: Expr
    then: list[Stmt]
    els: list[Stmt] = field(default_factory=list)


@dataclass
class While(Stmt):
    cond: Expr
    body: list[Stmt]


@dataclass
class ForEach(Stmt):
    """Iterate a persistent collection association (``for (T x : obj.f)``).

    Lowered to the iterator()/hasNext()/next() IR pattern of the paper's
    Listing 2; ``next()`` inside the loop is the collection association
    navigation (Table 3).
    """

    var: str
    obj: Expr
    field: str
    body: list[Stmt] = dataclasses.field(default_factory=list)


@dataclass
class ForEachLocal(Stmt):
    """Iterate a *local* (non-persistent) Python iterable — e.g. a worklist.

    This is how data-dependent traversals (Bellman-Ford's queue) appear:
    the analysis sees a loop but no collection association navigation.
    """

    var: str
    iterable: Expr
    body: list[Stmt] = dataclasses.field(default_factory=list)


@dataclass
class Return(Stmt):
    expr: Optional[Expr] = None


@dataclass
class Break(Stmt):
    pass


@dataclass
class Continue(Stmt):
    pass


# ---------------------------------------------------------------------------
# Methods / applications
# ---------------------------------------------------------------------------


@dataclass
class MethodDef:
    name: str
    params: tuple[tuple[str, Optional[str]], ...] = ()
    body: list[Stmt] = field(default_factory=list)
    owner: str = ""  # set by ClassDef.add_method
    ret_type: Optional[str] = None

    @property
    def key(self) -> str:
        return f"{self.owner}.{self.name}"


@dataclass
class Application:
    name: str
    classes: dict[str, ClassDef]

    def method(self, owner: str, name: str) -> MethodDef:
        return self.classes[owner].methods[name]

    def subtypes(self, cls: str) -> list[str]:
        out = []
        for c in self.classes.values():
            t = c.supertype
            while t is not None:
                if t == cls:
                    out.append(c.name)
                    break
                t = self.classes[t].supertype if t in self.classes else None
        return out

    def is_overridden(self, owner: str, method: str) -> bool:
        """Dynamic-binding check of section 4.4: does any subtype of ``owner``
        override ``method``?  If so CAPre must not inline its type graph."""
        for sub in self.subtypes(owner):
            if method in self.classes[sub].methods:
                return True
        return False

    def resolve_method(self, runtime_cls: str, method: str) -> MethodDef:
        """Dynamic dispatch: walk the supertype chain from the runtime class."""
        t: Optional[str] = runtime_cls
        while t is not None:
            c = self.classes[t]
            if method in c.methods:
                return c.methods[method]
            t = c.supertype
        raise AttributeError(f"no method {method} on {runtime_cls}")

    def field_spec(self, cls: str, fname: str) -> FieldSpec:
        t: Optional[str] = cls
        while t is not None:
            c = self.classes[t]
            if fname in c.fields:
                return c.fields[fname]
            t = c.supertype
        raise AttributeError(f"no field {fname} on {cls}")

    def all_methods(self) -> list[MethodDef]:
        return [m for c in self.classes.values() for m in c.methods.values()]

    def type_graph(self) -> dict[tuple[str, str], tuple[str, str]]:
        """The application type graph G_T = (T, A) of section 4.2.1, as the
        association function A: (type, field) -> (target type, cardinality)."""
        assoc: dict[tuple[str, str], tuple[str, str]] = {}
        for c in self.classes.values():
            for f in c.fields.values():
                if f.is_persistent:
                    assoc[(c.name, f.name)] = (f.target, f.card)
        return assoc
