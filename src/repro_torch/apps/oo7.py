"""The OO7 benchmark (Carey, DeWitt, Naughton, SIGMOD'93) — paper section
7.2.1, Figure 9.

Data model: a Module owns a tree of ComplexAssemblies; the leaves are
BaseAssemblies referencing CompositeParts; each CompositePart has a
documentation Document and a graph of AtomicParts connected by Connections.

The assembly hierarchy is polymorphic (Assembly -> ComplexAssembly |
BaseAssembly with an overridden ``traverse``), which exercises CAPre's
overridden-method exclusion: the static analysis cannot inline
``sub.traverse()``, so each assembly level schedules its own prefetch at
runtime — exactly why the paper's OO7 gains (26-30%) are smaller than
Wordcount's (>50%).

Traversals implemented (section 7.2.1):
  * t1  — full traversal: DFS over the assembly hierarchy, then the atomic
          part graph of every referenced composite part (data access speed);
  * t2b — t1 plus an update of every atomic part (update speed: the write
          cost dominates and prefetching cannot help).
"""

from __future__ import annotations

import random

from repro_torch.core.lang import (
    Application,
    Call,
    ClassDef,
    Compute,
    Const,
    COLLECTION,
    ExprStmt,
    FieldSpec,
    ForEach,
    ForEachLocal,
    Get,
    If,
    Let,
    MethodDef,
    Return,
    SetField,
    This,
    Var,
    fields_of,
)


def build_oo7_app() -> Application:
    module = ClassDef(
        "Module",
        fields_of(
            FieldSpec("designRoot", target="ComplexAssembly"),
            FieldSpec("manual", target="Manual"),
            FieldSpec("id"),
        ),
    )
    manual = ClassDef("Manual", fields_of(FieldSpec("text")))

    assembly = ClassDef("Assembly", fields_of(FieldSpec("id")))
    assembly.add_method(MethodDef("traverse", params=(), ret_type=None, body=[Return(Const(0))]))

    complex_asm = ClassDef(
        "ComplexAssembly",
        fields_of(FieldSpec("subAssemblies", target="Assembly", card=COLLECTION)),
        supertype="Assembly",
    )
    # traverse(): for (Assembly sub : subAssemblies) sub.traverse();
    complex_asm.add_method(
        MethodDef(
            "traverse",
            params=(),
            body=[
                Let("acc", Const(0)),
                ForEach(
                    "sub",
                    This(),
                    "subAssemblies",
                    [Let("acc", Compute(lambda a, b: a + b, (Var("acc"), Call(Var("sub"), "traverse")), "add"))],
                ),
                Return(Var("acc")),
            ],
        )
    )

    base_asm = ClassDef(
        "BaseAssembly",
        fields_of(FieldSpec("components", target="CompositePart", card=COLLECTION)),
        supertype="Assembly",
    )
    base_asm.add_method(
        MethodDef(
            "traverse",
            params=(),
            body=[
                Let("acc", Const(0)),
                ForEach(
                    "cp",
                    This(),
                    "components",
                    [Let("acc", Compute(lambda a, b: a + b, (Var("acc"), Call(Var("cp"), "traverseCP")), "add"))],
                ),
                Return(Var("acc")),
            ],
        )
    )

    composite = ClassDef(
        "CompositePart",
        fields_of(
            FieldSpec("rootPart", target="AtomicPart"),
            FieldSpec("documentation", target="Document"),
            FieldSpec("parts", target="AtomicPart", card=COLLECTION),
            FieldSpec("buildDate"),
        ),
    )
    # traverseCP(): touch the documentation, then DFS over the atomic-part
    # graph starting from rootPart, following connections (single assocs).
    composite.add_method(
        MethodDef(
            "traverseCP",
            params=(),
            body=[
                ExprStmt(Get(Get(This(), "documentation"), "title")),
                Let("visited", Compute(lambda: set(), (), "newSet")),
                Return(Call(Get(This(), "rootPart"), "visitAtomic", (Var("visited"),))),
            ],
        )
    )

    document = ClassDef("Document", fields_of(FieldSpec("title"), FieldSpec("text")))

    atomic = ClassDef(
        "AtomicPart",
        fields_of(
            FieldSpec("to", target="Connection", card=COLLECTION),
            FieldSpec("partOf", target="CompositePart"),
            FieldSpec("x"),
            FieldSpec("y"),
            FieldSpec("docId"),
        ),
    )
    # visitAtomic(visited): DFS over connections; recursion is cut by the
    # static analysis (back edge) but each call re-schedules its own prefetch.
    atomic.add_method(
        MethodDef(
            "visitAtomic",
            params=(("visited", None),),
            body=[
                If(
                    Compute(lambda s, me: id_in(s, me), (Var("visited"), This()), "seen"),
                    then=[Return(Const(0))],
                ),
                ExprStmt(Compute(lambda s, me: s.add(me), (Var("visited"), This()), "mark")),
                Let("acc", Get(This(), "x")),
                ForEach(
                    "conn",
                    This(),
                    "to",
                    [
                        Let("nxt", Get(Var("conn"), "toPart")),
                        Let(
                            "acc",
                            Compute(
                                lambda a, b: a + b,
                                (Var("acc"), Call(Var("nxt"), "visitAtomic", (Var("visited"),))),
                                "add",
                            ),
                        ),
                    ],
                ),
                Return(Var("acc")),
            ],
        )
    )
    # t2b's per-part update: swap x and y and bump the build date.
    atomic.add_method(
        MethodDef(
            "updatePart",
            params=(),
            body=[
                Let("ox", Get(This(), "x")),
                SetField(This(), "x", Get(This(), "y")),
                SetField(This(), "y", Var("ox")),
            ],
        )
    )

    connection = ClassDef(
        "Connection",
        fields_of(FieldSpec("toPart", target="AtomicPart"), FieldSpec("length"), FieldSpec("ctype")),
    )

    bench = ClassDef("OO7Bench", fields_of(FieldSpec("module", target="Module")))
    # t1: full read traversal from the module.
    bench.add_method(
        MethodDef(
            "t1",
            params=(),
            body=[Return(Call(Get(Get(This(), "module"), "designRoot"), "traverse"))],
        )
    )
    # t2b: traverse and update every atomic part of every composite part.
    bench.add_method(
        MethodDef(
            "t2b",
            params=(),
            body=[
                ExprStmt(Call(Get(Get(This(), "module"), "designRoot"), "updateAll")),
            ],
        )
    )
    complex_asm.add_method(
        MethodDef(
            "updateAll",
            params=(),
            body=[ForEach("sub", This(), "subAssemblies", [ExprStmt(Call(Var("sub"), "updateAll"))])],
        )
    )
    base_asm.add_method(
        MethodDef(
            "updateAll",
            params=(),
            body=[
                ForEach(
                    "cp",
                    This(),
                    "components",
                    [ForEach("p", Var("cp"), "parts", [ExprStmt(Call(Var("p"), "updatePart"))])],
                )
            ],
        )
    )
    assembly.add_method(MethodDef("updateAll", params=(), body=[Return(None)]))
    # re-add so the override map sees traverse/updateAll on all three
    for c in (assembly, complex_asm, base_asm):
        for m in c.methods.values():
            m.owner = c.name

    return Application(
        name="oo7",
        classes={
            c.name: c
            for c in [module, manual, assembly, complex_asm, base_asm, composite, document, atomic, connection, bench]
        },
    )


def id_in(s: set, ref) -> bool:
    return ref in s


# ---------------------------------------------------------------------------
# Database generator (sizes follow the OO7 small/medium spirit, scaled so the
# wall-clock simulation stays in seconds)
# ---------------------------------------------------------------------------

SIZES = {
    # levels in the assembly tree, fan-out, composite parts per base
    # assembly, atomic parts per composite part
    "small": dict(levels=4, fanout=3, comps_per_base=4, atoms_per_comp=12),
    "medium": dict(levels=5, fanout=3, comps_per_base=5, atoms_per_comp=16),
}


def populate_oo7(store, size: str = "small", seed: int = 7) -> int:
    cfg = SIZES[size]
    rng = random.Random(seed)

    def make_composite(idx: int) -> int:
        # a composite part's traversal closure (parts + connections + doc)
        # is one locality group — T1/T6 walk it in full, so a locality-aware
        # placement keeps the whole subtree on one Data Service
        grp = f"cp{idx}"
        doc = store.put("Document", {"title": f"doc{idx}", "text": "x" * 16}, group=grp)
        n = cfg["atoms_per_comp"]
        atoms = [
            store.put("AtomicPart", {"x": float(i), "y": float(i) * 2, "docId": idx, "to": [], "partOf": None},
                      group=grp)
            for i in range(n)
        ]
        # connect the parts in a ring plus a few random chords (the OO7
        # atomic graph has out-degree 3)
        for i, a in enumerate(atoms):
            targets = {atoms[(i + 1) % n]}
            while len(targets) < 3:
                targets.add(atoms[rng.randrange(n)])
            conns = [
                store.put("Connection", {"toPart": t, "length": rng.random(), "ctype": "c"},
                          group=grp)
                for t in targets
            ]
            store.peek(a).fields["to"] = conns
        cp = store.put(
            "CompositePart",
            {"rootPart": atoms[0], "documentation": doc, "parts": atoms, "buildDate": idx},
            group=grp,
        )
        for a in atoms:
            store.peek(a).fields["partOf"] = cp
        return cp

    comp_counter = [0]

    def make_assembly(level: int) -> int:
        if level == cfg["levels"]:
            comps = []
            for _ in range(cfg["comps_per_base"]):
                comps.append(make_composite(comp_counter[0]))
                comp_counter[0] += 1
            return store.put("BaseAssembly", {"components": comps, "id": level})
        subs = [make_assembly(level + 1) for _ in range(cfg["fanout"])]
        return store.put("ComplexAssembly", {"subAssemblies": subs, "id": level})

    root_asm = make_assembly(1)
    man = store.put("Manual", {"text": "m" * 32})
    module = store.put("Module", {"designRoot": root_asm, "manual": man, "id": 0})
    return store.put("OO7Bench", {"module": module})
