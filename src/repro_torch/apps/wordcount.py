"""Wordcount benchmark (paper section 7.2.2, Figure 11).

Data model: TextCollection ->> Text ->> Chunk (words live in the chunks);
each Text also references a TextStats single association (what gives ROP a
little to do).  Almost all data is reached through collections, which is why
the paper reports CAPre's largest improvement (>50%) here and why ROP
stagnates at depth 3.
"""

from __future__ import annotations

from collections import Counter

from repro_torch.core.lang import (
    Application,
    ClassDef,
    Compute,
    COLLECTION,
    ExprStmt,
    FieldSpec,
    ForEach,
    Get,
    Let,
    MethodDef,
    Return,
    This,
    Var,
    fields_of,
)


def build_wordcount_app() -> Application:
    job = ClassDef(
        "WCJob",
        fields_of(FieldSpec("collections", target="TextCollection", card=COLLECTION)),
    )
    job.add_method(
        MethodDef(
            "run",
            params=(),
            body=[
                Let("counts", Compute(lambda: Counter(), (), "newCounter")),
                ForEach(
                    "tc",
                    This(),
                    "collections",
                    [
                        ForEach(
                            "t",
                            Var("tc"),
                            "texts",
                            [
                                ExprStmt(Get(Get(Var("t"), "stats"), "lineCount")),
                                ForEach(
                                    "ch",
                                    Var("t"),
                                    "chunks",
                                    [
                                        ExprStmt(
                                            Compute(
                                                lambda c, words: c.update(words),
                                                (Var("counts"), Get(Var("ch"), "words")),
                                                "countWords",
                                            )
                                        )
                                    ],
                                ),
                            ],
                        )
                    ],
                ),
                Return(Var("counts")),
            ],
        )
    )

    text_collection = ClassDef(
        "TextCollection", fields_of(FieldSpec("texts", target="Text", card=COLLECTION))
    )
    text = ClassDef(
        "Text",
        fields_of(
            FieldSpec("chunks", target="Chunk", card=COLLECTION),
            FieldSpec("stats", target="TextStats"),
            FieldSpec("name"),
        ),
    )
    stats = ClassDef("TextStats", fields_of(FieldSpec("lineCount"), FieldSpec("charCount")))
    chunk = ClassDef("Chunk", fields_of(FieldSpec("words")))

    return Application(
        name="wordcount",
        classes={c.name: c for c in [job, text_collection, text, stats, chunk]},
    )


_WORDS = ("the quick brown fox jumps over the lazy dog lorem ipsum dolor sit amet "
          "consectetur adipiscing elit sed do eiusmod tempor incididunt ut labore").split()


def populate_wordcount(
    store,
    n_collections: int = 4,
    texts_per_collection: int = 2,
    chunks_per_text: int = 64,
    words_per_chunk: int = 32,
    seed: int = 11,
) -> int:
    """The paper's setup: files split into collections, distributed across the
    Data Services; the chunk count is the swept parameter."""
    import random

    rng = random.Random(seed)
    collections = []
    for ci in range(n_collections):
        texts = []
        for ti in range(texts_per_collection):
            # one locality group per text: the run scans each text's chunk
            # list end to end, so its closure belongs on one Data Service
            grp = f"t{ci}.{ti}"
            chunks = [
                store.put(
                    "Chunk",
                    {"words": [rng.choice(_WORDS) for _ in range(words_per_chunk)]},
                    group=grp,
                )
                for _ in range(chunks_per_text)
            ]
            st = store.put("TextStats", {"lineCount": chunks_per_text, "charCount": 0},
                           group=grp)
            texts.append(
                store.put("Text", {"chunks": chunks, "stats": st, "name": grp}, group=grp)
            )
        collections.append(store.put("TextCollection", {"texts": texts}))
    return store.put("WCJob", {"collections": collections})
