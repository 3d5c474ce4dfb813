"""Referenced-Objects Predictor (ROP) — the schema-based baseline.

Paper section 1/2: "each time an object is accessed, all the objects
referenced from it are likely to be accessed as well", expanded to a
configurable *fetch depth*.  Two properties the paper leans on:

  * ROP follows **single** associations only — "ROP approaches do not
    prefetch collections because the probability of bringing many unnecessary
    objects is very high";
  * ROP is schema-driven: the same expansion regardless of which method runs,
    which is exactly what makes it both cheap and rigid.
"""

from __future__ import annotations

from . import lang
from .hints import Hint, Steps


def rop_hints(app: lang.Application, type_name: str, depth: int) -> tuple[Hint, ...]:
    """Depth-limited expansion of single associations from ``type_name``
    over the application type graph G_T."""
    assoc = app.type_graph()
    out: list[Steps] = []

    def expand(t: str, steps: Steps, d: int, seen: tuple[str, ...]) -> None:
        if d == 0:
            return
        extended = False
        for (owner, fld), (target, card) in sorted(assoc.items()):
            if owner != t or card != lang.SINGLE:
                continue
            if target in seen:  # schema cycles: stop, ROP re-triggers at runtime
                continue
            extended = True
            nxt = steps + ((fld, lang.SINGLE),)
            out.append(nxt)
            expand(target, nxt, d - 1, seen + (target,))

        _ = extended

    expand(type_name, (), depth, (type_name,))
    # keep maximal paths only (loading a.b loads a on the way)
    maximal = [p for p in out if not any(q != p and q[: len(p)] == p for q in out)]
    return tuple(Hint(p) for p in sorted(maximal, key=str))


def rop_referenced_fields(app: lang.Application, type_name: str) -> list[tuple[str, str]]:
    """Direct single associations of a type: (field, target) — what ROP
    eagerly schedules each time an object of this type is loaded."""
    assoc = app.type_graph()
    return [
        (fld, target)
        for (owner, fld), (target, card) in sorted(assoc.items())
        if owner == type_name and card == lang.SINGLE
    ]
