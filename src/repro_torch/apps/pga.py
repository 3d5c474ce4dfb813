"""Princeton Graph Algorithms benchmark (paper section 7.2.4, Figure 15).

Data model: WeightedDirectedGraph ->> Vertex ->> WeightedEdge -> Vertex.

Two algorithms with deliberately different access structure:

  * **DFS** iterates the graph's vertex collection and recursively visits
    along edges — the static analysis sees the collections and prefetches
    them (the paper: "similar to WordCount; CAPre doubles ROP's gain");
  * **Bellman-Ford** (SPFA variant) drives the traversal from a *local
    worklist* seeded with the source vertex — the accessed objects depend on
    run-time relaxation order, so neither CAPre nor ROP can predict them
    (the paper: no significant improvement, but CAPre also adds ~no
    overhead, because it knows there is nothing to prefetch).
"""

from __future__ import annotations

from repro_torch.core.lang import (
    Application,
    Call,
    ClassDef,
    Compute,
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
    This,
    Var,
    While,
    fields_of,
)


def build_pga_app() -> Application:
    graph = ClassDef(
        "WeightedDirectedGraph",
        fields_of(FieldSpec("vertices", target="Vertex", card=COLLECTION), FieldSpec("name")),
    )
    vertex = ClassDef(
        "Vertex",
        fields_of(FieldSpec("edges", target="WeightedEdge", card=COLLECTION), FieldSpec("vid")),
    )
    edge = ClassDef(
        "WeightedEdge",
        fields_of(FieldSpec("toVertex", target="Vertex"), FieldSpec("weight")),
    )

    # ---- DFS ---------------------------------------------------------------
    vertex.add_method(
        MethodDef(
            "visit",
            params=(("marked", None),),
            body=[
                If(
                    Compute(lambda m, v: v in m, (Var("marked"), This()), "seen"),
                    then=[Return(Const0())],
                ),
                ExprStmt(Compute(lambda m, v: m.add(v), (Var("marked"), This()), "mark")),
                Let("acc", Const0()),
                ForEach(
                    "e",
                    This(),
                    "edges",
                    [
                        Let("w", Get(Var("e"), "weight")),
                        Let("nxt", Get(Var("e"), "toVertex")),
                        Let(
                            "acc",
                            Compute(
                                lambda a, w, sub: a + w + sub,
                                (Var("acc"), Var("w"), Call(Var("nxt"), "visit", (Var("marked"),))),
                                "add",
                            ),
                        ),
                    ],
                ),
                Return(Var("acc")),
            ],
        )
    )
    graph.add_method(
        MethodDef(
            "dfs",
            params=(),
            body=[
                Let("marked", Compute(lambda: set(), (), "newSet")),
                Let("acc", Const0()),
                ForEach(
                    "v",
                    This(),
                    "vertices",
                    [
                        Let(
                            "acc",
                            Compute(
                                lambda a, sub: a + sub,
                                (Var("acc"), Call(Var("v"), "visit", (Var("marked"),))),
                                "add",
                            ),
                        )
                    ],
                ),
                Return(Var("acc")),
            ],
        )
    )

    # ---- Bellman-Ford (SPFA): worklist-driven, data-dependent order --------
    graph.add_method(
        MethodDef(
            "bellmanFord",
            params=(("source", "Vertex"),),
            body=[
                Let("dist", Compute(lambda s: {s: 0.0}, (Var("source"),), "initDist")),
                Let("queue", Compute(lambda s: [s], (Var("source"),), "initQueue")),
                While(
                    Compute(lambda q: len(q) > 0, (Var("queue"),), "nonEmpty"),
                    [
                        Let("u", Compute(lambda q: q.pop(0), (Var("queue"),), "pop")),
                        ForEach(
                            "e",
                            Var("u"),
                            "edges",
                            [
                                Let("v2", Get(Var("e"), "toVertex")),
                                Let("w", Get(Var("e"), "weight")),
                                Let(
                                    "relaxed",
                                    Compute(
                                        _relax,
                                        (Var("dist"), Var("u"), Var("v2"), Var("w")),
                                        "relax",
                                    ),
                                ),
                                If(
                                    Var("relaxed"),
                                    then=[
                                        ExprStmt(
                                            Compute(
                                                lambda q, v: q.append(v), (Var("queue"), Var("v2")), "push"
                                            )
                                        )
                                    ],
                                ),
                            ],
                        ),
                    ],
                ),
                Return(Var("dist")),
            ],
        )
    )

    return Application(name="pga", classes={c.name: c for c in [graph, vertex, edge]})


def Const0():
    from repro_torch.core.lang import Const

    return Const(0)


def _relax(dist, u, v, w) -> bool:
    du = dist.get(u)
    if du is None:
        return False
    nd = du + w
    if nd < dist.get(v, float("inf")):
        dist[v] = nd
        return True
    return False


def populate_pga(store, n_vertices: int = 300, out_degree: int = 4, seed: int = 13):
    """Returns (graph_oid, source_vertex_oid)."""
    import random

    rng = random.Random(seed)
    # a vertex and its out-edges form one locality group: relaxing a vertex
    # touches all of them, so co-location spares the per-edge remote hops
    vertices = [store.put("Vertex", {"vid": i, "edges": []}, group=f"v{i}")
                for i in range(n_vertices)]
    for i, v in enumerate(vertices):
        edges = []
        # a ring edge keeps the graph connected; chords add density
        targets = {vertices[(i + 1) % n_vertices]}
        while len(targets) < out_degree:
            targets.add(vertices[rng.randrange(n_vertices)])
        for t in targets:
            edges.append(store.put("WeightedEdge", {"toVertex": t, "weight": rng.random()},
                                   group=f"v{i}"))
        store.peek(v).fields["edges"] = edges
    g = store.put("WeightedDirectedGraph", {"vertices": vertices, "name": "g"})
    return g, vertices[0]
