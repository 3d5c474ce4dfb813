"""K-Means benchmark (paper section 7.2.3, Figure 13).

Data model: VectorCollection ->> Vector, nothing else — crucially there are
**no single associations**, so ROP has literally nothing to prefetch
regardless of its fetch depth (the paper's Figure 14), while CAPre predicts
the vector collections and prefetches them in parallel.  The algorithm is
iterative; after the first pass the store is warm, so the paper's observed
9-15% improvement is structurally what this model produces.
"""

from __future__ import annotations

from repro_torch.core.lang import (
    Application,
    ClassDef,
    Compute,
    COLLECTION,
    Const,
    ExprStmt,
    FieldSpec,
    ForEach,
    Get,
    Let,
    MethodDef,
    Return,
    This,
    Var,
    While,
    fields_of,
)


def _nearest(dims, centroids):
    best, best_d = 0, float("inf")
    for i, c in enumerate(centroids):
        d = sum((a - b) ** 2 for a, b in zip(dims, c))
        if d < best_d:
            best, best_d = i, d
    return best


def _update_state(state, cluster, dims):
    sums, counts = state
    acc = sums[cluster]
    sums[cluster] = [a + b for a, b in zip(acc, dims)]
    counts[cluster] += 1
    return state


def _recompute(state, centroids):
    sums, counts = state
    return [
        [s / c for s in sums[i]] if (c := counts[i]) else centroids[i]
        for i in range(len(centroids))
    ]


def build_kmeans_app() -> Application:
    job = ClassDef(
        "KMeansJob",
        fields_of(
            FieldSpec("collections", target="VectorCollection", card=COLLECTION),
            FieldSpec("k"),
            FieldSpec("iters"),
        ),
    )
    job.add_method(
        MethodDef(
            "run",
            params=(("centroids", None),),
            body=[
                Let("it", Const(0)),
                While(
                    Compute(lambda it, self_iters: it < self_iters, (Var("it"), Get(This(), "iters")), "lt"),
                    [
                        Let(
                            "state",
                            Compute(
                                lambda cents: ([[0.0] * len(c) for c in cents], [0] * len(cents)),
                                (Var("centroids"),),
                                "zeroState",
                            ),
                        ),
                        ForEach(
                            "vc",
                            This(),
                            "collections",
                            [
                                ForEach(
                                    "v",
                                    Var("vc"),
                                    "vectors",
                                    [
                                        Let("dims", Get(Var("v"), "dims")),
                                        Let(
                                            "cl",
                                            Compute(_nearest, (Var("dims"), Var("centroids")), "nearest"),
                                        ),
                                        ExprStmt(
                                            Compute(
                                                _update_state,
                                                (Var("state"), Var("cl"), Var("dims")),
                                                "accumulate",
                                            )
                                        ),
                                    ],
                                )
                            ],
                        ),
                        Let(
                            "centroids",
                            Compute(_recompute, (Var("state"), Var("centroids")), "recompute"),
                        ),
                        Let("it", Compute(lambda i: i + 1, (Var("it"),), "inc")),
                    ],
                ),
                Return(Var("centroids")),
            ],
        )
    )

    vcoll = ClassDef(
        "VectorCollection", fields_of(FieldSpec("vectors", target="Vector", card=COLLECTION))
    )
    vector = ClassDef("Vector", fields_of(FieldSpec("dims")))

    return Application(
        name="kmeans", classes={c.name: c for c in [job, vcoll, vector]}
    )


def populate_kmeans(store, n_vectors: int = 800, n_collections: int = 4, dims: int = 10, seed: int = 3) -> int:
    import random

    rng = random.Random(seed)
    per = n_vectors // n_collections
    colls = []
    for ci in range(n_collections):
        # one locality group per collection: the iteration scans a whole
        # collection before moving on, so co-locating it keeps each scan
        # on a single Data Service
        vecs = [
            store.put("Vector", {"dims": [rng.random() for _ in range(dims)]},
                      group=f"coll{ci}")
            for _ in range(per)
        ]
        colls.append(store.put("VectorCollection", {"vectors": vecs}, group=f"coll{ci}"))
    return store.put("KMeansJob", {"collections": colls, "k": 4, "iters": 3})


def initial_centroids(k: int = 4, dims: int = 10, seed: int = 5):
    import random

    rng = random.Random(seed)
    return [[rng.random() for _ in range(dims)] for _ in range(k)]
