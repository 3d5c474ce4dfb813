"""Wala-like Intermediate Representation (paper section 5.1.1).

Each IR instruction carries the five parts described in the paper:

  * ``ii``        — the instruction's index inside the IR,
  * ``itype``     — the instruction type (getfield, invokemethod, ...),
  * ``params``    — instruction parameters (accessed field, invoked method...),
  * ``def_var``   — the variable ID defined by the instruction (or None),
  * ``used_vars`` — previously-defined variable IDs used by the instruction,

plus the AST facts Algorithm 1 queries through getASTNode /
hasConditionalParent / hasLoopParent, which we materialize directly on the
instruction:

  * ``branch_path`` — enclosing conditional branches as a tuple of
                      ``(cond_id, branch_idx, n_branches)`` triples,
  * ``loop_path``   — enclosing loop statement IDs (innermost last).

Variable IDs follow Wala's convention loosely: ``v1`` is the self reference
``this``, ``v2..`` are the method parameters, then temporaries.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Optional

# Instruction types (paper Table 3 + the control instructions of Listing 2).
GETFIELD = "getfield"
PUTFIELD = "putfield"
ARRAYLOAD = "arrayload"
INVOKE = "invokemethod"
ITER_INIT = "iterator"  # invokemethod java/util/ArrayList.iterator()
ITER_HASNEXT = "hasnext"  # invokemethod java/util/Iterator.hasNext()
ITER_NEXT = "next"  # invokemethod java/util/Iterator.next()
RETURN = "return"
BREAK = "break"
CONTINUE = "continue"
CONDBRANCH = "conditionalbranch"
GOTO = "goto"
CONST = "const"
COMPUTE = "compute"
NEW = "new"

BRANCHING = (RETURN, BREAK, CONTINUE)


@dataclass
class Instr:
    ii: int
    itype: str
    params: dict[str, Any] = field(default_factory=dict)
    def_var: Optional[str] = None
    used_vars: tuple[str, ...] = ()
    branch_path: tuple[tuple[int, int, int], ...] = ()
    loop_path: tuple[int, ...] = ()

    # --- the AST queries used by Algorithm 1 -----------------------------
    @property
    def has_conditional_parent(self) -> bool:
        return len(self.branch_path) > 0

    @property
    def has_loop_parent(self) -> bool:
        return len(self.loop_path) > 0

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        use = ", ".join(self.used_vars)
        d = f"{self.def_var} = " if self.def_var else ""
        p = ", ".join(f"{k}={v}" for k, v in self.params.items() if k != "fn")
        return f"II{self.ii}: {d}{self.itype} <{p}> : {use}"


@dataclass
class MethodIR:
    owner: str
    name: str
    # params as (var_id, name, declared type or None); params[0] is `this`
    params: tuple[tuple[str, str, Optional[str]], ...]
    instrs: list[Instr]

    @property
    def key(self) -> str:
        return f"{self.owner}.{self.name}"

    @property
    def this_var(self) -> str:
        return self.params[0][0]

    def param_var(self, index: int) -> str:
        return self.params[index][0]

    def dump(self) -> str:
        head = f"IR of {self.key}({', '.join(p[1] for p in self.params[1:])})"
        return "\n".join([head] + ["  " + repr(i) for i in self.instrs])
