"""AST node definitions for the Stan subset."""

from __future__ import annotations

import dataclasses
from typing import Any, Optional


@dataclasses.dataclass
class Node:
    line: int = dataclasses.field(default=0, kw_only=True)
    col: int = dataclasses.field(default=0, kw_only=True)


# ----------------------------------------------------------------- expressions

@dataclasses.dataclass
class Num(Node):
    value: Any = None        # python int or float
    is_int: bool = False
    is_imag: bool = False    # imaginary literal: 4.0i -> complex(0, 4.0)


@dataclasses.dataclass
class Var(Node):
    name: str = ""


@dataclasses.dataclass
class StringLit(Node):
    value: str = ""


@dataclasses.dataclass
class BinOp(Node):
    op: str = ""
    left: Node = None
    right: Node = None


@dataclasses.dataclass
class UnaryOp(Node):
    op: str = ""
    operand: Node = None


@dataclasses.dataclass
class Ternary(Node):
    cond: Node = None
    if_true: Node = None
    if_false: Node = None


@dataclasses.dataclass
class Call(Node):
    name: str = ""
    args: list = dataclasses.field(default_factory=list)
    # for distribution-style calls: normal_lpdf(y | mu, sigma)
    bar_split: int = -1  # index in args where the '|' occurred (-1: none)


@dataclasses.dataclass
class Index(Node):
    base: Node = None
    indices: list = dataclasses.field(default_factory=list)  # Expr | Range | Colon


@dataclasses.dataclass
class Range(Node):
    lower: Optional[Node] = None
    upper: Optional[Node] = None


@dataclasses.dataclass
class Colon(Node):
    pass


@dataclasses.dataclass
class Transpose(Node):
    operand: Node = None


@dataclasses.dataclass
class ArrayLit(Node):
    elements: list = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class TupleLit(Node):
    """Tuple expression: (e1, e2, ...) with >= 2 elements."""

    elements: list = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class Member(Node):
    """Member access: tuple slot ``x.1`` or complex part ``z.real``."""

    base: Node = None
    field: str = ""          # "1", "2", ... | "real" | "imag"


@dataclasses.dataclass
class RowVectorLit(Node):
    elements: list = dataclasses.field(default_factory=list)


# ---------------------------------------------------------------------- types

@dataclasses.dataclass
class TypeSpec(Node):
    base: str = "real"          # int|real|vector|row_vector|matrix|simplex|...
    dims: list = dataclasses.field(default_factory=list)   # type dims (exprs)
    array_dims: list = dataclasses.field(default_factory=list)
    constraints: dict = dataclasses.field(default_factory=dict)  # lower/upper/offset/multiplier -> expr
    tuple_slots: Optional[list] = None  # list[TypeSpec] when base == "tuple"


# ----------------------------------------------------------------- statements

@dataclasses.dataclass
class Decl(Node):
    type: TypeSpec = None
    name: str = ""
    init: Optional[Node] = None


@dataclasses.dataclass
class Assign(Node):
    target: Node = None          # Var or Index
    op: str = "="                # =, +=, -=, *=, /=, .*=, ./=
    value: Node = None


@dataclasses.dataclass
class Sampling(Node):
    target: Node = None          # expression left of ~
    dist: str = ""
    args: list = dataclasses.field(default_factory=list)
    truncation: Optional[tuple] = None   # (lower expr | None, upper expr | None)


@dataclasses.dataclass
class TargetPlus(Node):
    value: Node = None


@dataclasses.dataclass
class For(Node):
    var: str = ""
    lower: Node = None
    upper: Node = None
    body: list = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class While(Node):
    cond: Node = None
    body: list = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class If(Node):
    cond: Node = None
    then: list = dataclasses.field(default_factory=list)
    orelse: list = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class Print(Node):
    args: list = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class Reject(Node):
    args: list = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class Break(Node):
    pass


@dataclasses.dataclass
class Continue(Node):
    pass


@dataclasses.dataclass
class Return(Node):
    value: Optional[Node] = None


# ---------------------------------------------------------------------- model

@dataclasses.dataclass
class FunctionDef(Node):
    return_type: str = "real"
    name: str = ""
    params: list = dataclasses.field(default_factory=list)  # (TypeSpec, name)
    body: list = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class Program(Node):
    functions: list = dataclasses.field(default_factory=list)
    data: list = dataclasses.field(default_factory=list)
    transformed_data: list = dataclasses.field(default_factory=list)
    parameters: list = dataclasses.field(default_factory=list)
    transformed_parameters: list = dataclasses.field(default_factory=list)
    model: list = dataclasses.field(default_factory=list)
    generated_quantities: list = dataclasses.field(default_factory=list)
