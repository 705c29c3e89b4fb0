"""Recursive-descent parser for the Stan modeling language subset."""

from __future__ import annotations

from . import ast_nodes as A
from .errors import StanCompileError
from .lexer import Token, tokenize

_TYPE_BASES = {
    "int", "real", "vector", "row_vector", "matrix", "simplex",
    "unit_vector", "ordered", "positive_ordered", "cholesky_factor_corr",
    "cholesky_factor_cov", "corr_matrix", "cov_matrix", "sum_to_zero_vector",
    "complex", "tuple",
    "complex_vector", "complex_row_vector", "complex_matrix",
}

# recognized Stan types this compiler does not implement; reported with a
# precise compile-time error instead of a confusing parse failure (the
# reference consumes them through BridgeStan, src/stan.rs:92-251)
_UNSUPPORTED_TYPE_BASES: set[str] = set()

_ASSIGN_OPS = {"=", "+=", "-=", "*=", "/=", ".*=", "./="}


class Parser:
    def __init__(self, tokens: list[Token]):
        self.tokens = tokens
        self.pos = 0

    # ------------------------------------------------------------- utilities

    def peek(self, k: int = 0) -> Token:
        return self.tokens[min(self.pos + k, len(self.tokens) - 1)]

    def next(self) -> Token:
        tok = self.tokens[self.pos]
        if tok.kind != "EOF":
            self.pos += 1
        return tok

    def at(self, kind: str, value=None, k: int = 0) -> bool:
        tok = self.peek(k)
        return tok.kind == kind and (value is None or tok.value == value)

    def expect(self, kind: str, value=None) -> Token:
        tok = self.peek()
        if not self.at(kind, value):
            want = value if value is not None else kind
            raise StanCompileError(
                f"expected {want!r}, found {tok.value!r}", tok.line, tok.col
            )
        return self.next()

    def error(self, msg: str) -> StanCompileError:
        tok = self.peek()
        return StanCompileError(msg, tok.line, tok.col)

    # --------------------------------------------------------------- program

    def parse_program(self) -> A.Program:
        prog = A.Program()
        while not self.at("EOF"):
            tok = self.peek()
            if self.at("KEYWORD", "functions"):
                self.next()
                prog.functions = self.parse_functions_block()
            elif self.at("KEYWORD", "data"):
                self.next()
                prog.data = self.parse_decl_block()
            elif self.at("KEYWORD", "transformed") and self.at("KEYWORD", "data", 1):
                self.next(); self.next()
                prog.transformed_data = self.parse_stmt_block()
            elif self.at("KEYWORD", "parameters"):
                self.next()
                prog.parameters = self.parse_decl_block()
            elif self.at("KEYWORD", "transformed") and self.at(
                "KEYWORD", "parameters", 1
            ):
                self.next(); self.next()
                prog.transformed_parameters = self.parse_stmt_block()
            elif self.at("KEYWORD", "model"):
                self.next()
                prog.model = self.parse_stmt_block()
            elif self.at("KEYWORD", "generated") and self.at(
                "KEYWORD", "quantities", 1
            ):
                self.next(); self.next()
                prog.generated_quantities = self.parse_stmt_block()
            else:
                raise StanCompileError(
                    f"expected a block keyword, found {tok.value!r}",
                    tok.line, tok.col,
                )
        return prog

    def parse_functions_block(self) -> list:
        self.expect("PUNCT", "{")
        funcs = []
        while not self.at("PUNCT", "}"):
            funcs.append(self.parse_function_def())
        self.expect("PUNCT", "}")
        return funcs

    def parse_function_def(self) -> A.FunctionDef:
        tok = self.peek()
        # return type: void | basic type (possibly array with [] suffix)
        if self.at("KEYWORD", "void"):
            ret = "void"
            self.next()
        else:
            ret_type = self.parse_type(
                allow_constraints=False, in_signature=True
            )
            ret = ret_type.base
        name = self.expect("IDENT").value
        self.expect("PUNCT", "(")
        params = []
        while not self.at("PUNCT", ")"):
            # optional `data` qualifier (marks data-only arguments for
            # Stan's autodiff-level checks; values here are concrete at
            # trace time anyway, so the qualifier only needs parsing)
            if self.peek().value == "data" and self.peek().kind in (
                "KEYWORD", "IDENT"
            ):
                self.next()
            ptype = self.parse_type(allow_constraints=False, in_signature=True)
            pname = self.expect("IDENT").value
            params.append((ptype, pname))
            if self.at("PUNCT", ","):
                self.next()
        self.expect("PUNCT", ")")
        body = self.parse_stmt_block()
        return A.FunctionDef(
            return_type=ret, name=name, params=params, body=body,
            line=tok.line, col=tok.col,
        )

    def parse_decl_block(self) -> list:
        self.expect("PUNCT", "{")
        decls = []
        while not self.at("PUNCT", "}"):
            decls.extend(self.parse_declaration())
        self.expect("PUNCT", "}")
        return decls

    def parse_stmt_block(self) -> list:
        self.expect("PUNCT", "{")
        stmts = []
        while not self.at("PUNCT", "}"):
            stmt = self.parse_statement()
            if isinstance(stmt, list):
                stmts.extend(stmt)
            else:
                stmts.append(stmt)
        self.expect("PUNCT", "}")
        return stmts

    # ------------------------------------------------------------------ types

    def _looks_like_type(self) -> bool:
        if self.at("KEYWORD", "array"):
            return True
        tok = self.peek()
        if tok.value in _UNSUPPORTED_TYPE_BASES:
            return True
        if tok.value == "tuple":
            # `tuple(` starts a type; anything else is an identifier use
            return self.peek(1).value == "("
        return tok.kind == "KEYWORD" and tok.value in _TYPE_BASES

    def parse_type(self, allow_constraints: bool = True,
                   in_signature: bool = False) -> A.TypeSpec:
        tok = self.peek()
        spec = A.TypeSpec(line=tok.line, col=tok.col)
        # array[dims] prefix (Stan 2.26+)
        if self.at("KEYWORD", "array"):
            self.next()
            self.expect("PUNCT", "[")
            while True:
                if in_signature and (self.at("PUNCT", "]") or self.at("OP", ",")):
                    spec.array_dims.append(None)
                else:
                    spec.array_dims.append(self.parse_expr())
                if self.at("PUNCT", ","):
                    self.next()
                    continue
                break
            self.expect("PUNCT", "]")
        base_tok = self.peek()
        if base_tok.value in _UNSUPPORTED_TYPE_BASES:
            raise StanCompileError(
                f"{base_tok.value!r} types are not supported by the "
                f"nutpie_tpu Stan compiler (use real/vector/matrix "
                f"decompositions; the reference handles these through "
                f"BridgeStan)",
                base_tok.line, base_tok.col,
            )
        if base_tok.kind != "KEYWORD" or base_tok.value not in _TYPE_BASES:
            raise StanCompileError(
                f"expected a type, found {base_tok.value!r}",
                base_tok.line, base_tok.col,
            )
        spec.base = base_tok.value
        self.next()
        # tuple(T1, T2, ...): recursive slot types (each may be an
        # array[...]-prefixed type itself)
        if spec.base == "tuple":
            self.expect("PUNCT", "(")
            spec.tuple_slots = []
            while True:
                spec.tuple_slots.append(
                    self.parse_type(
                        allow_constraints=allow_constraints,
                        in_signature=in_signature,
                    )
                )
                if self.at("PUNCT", ","):
                    self.next()
                    continue
                break
            self.expect("PUNCT", ")")
            return spec
        # constraints <lower=..., upper=...>
        if allow_constraints and self.at("OP", "<"):
            self.next()
            while True:
                key_tok = self.peek()
                if key_tok.kind not in ("KEYWORD", "IDENT") or key_tok.value not in (
                    "lower", "upper", "offset", "multiplier"
                ):
                    raise StanCompileError(
                        f"unknown constraint {key_tok.value!r}",
                        key_tok.line, key_tok.col,
                    )
                self.next()
                self.expect("OP", "=")
                spec.constraints[key_tok.value] = self.parse_expr(no_gt=True)
                if self.at("PUNCT", ","):
                    self.next()
                    continue
                break
            self.expect("OP", ">")
        # type dims: vector[N], matrix[R, C]
        if self.at("PUNCT", "[") and spec.base not in ("int", "real", "complex"):
            self.next()
            while True:
                if in_signature and (self.at("PUNCT", "]") or self.at("OP", ",")):
                    spec.dims.append(None)
                else:
                    spec.dims.append(self.parse_expr())
                if self.at("PUNCT", ","):
                    self.next()
                    continue
                break
            self.expect("PUNCT", "]")
        return spec

    def parse_declaration(self) -> A.Decl:
        tok = self.peek()
        spec = self.parse_type()
        name = self.expect("IDENT").value
        # legacy array syntax: real x[N, M];
        if self.at("PUNCT", "["):
            self.next()
            while True:
                spec.array_dims.append(self.parse_expr())
                if self.at("PUNCT", ","):
                    self.next()
                    continue
                break
            self.expect("PUNCT", "]")
        init = None
        if self.at("OP", "="):
            self.next()
            init = self.parse_expr()
        decls = [
            A.Decl(type=spec, name=name, init=init, line=tok.line, col=tok.col)
        ]
        # multi-declaration: real a = 1, b = 2;
        while self.at("PUNCT", ","):
            self.next()
            nm = self.expect("IDENT").value
            ini = None
            if self.at("OP", "="):
                self.next()
                ini = self.parse_expr()
            decls.append(
                A.Decl(type=spec, name=nm, init=ini, line=tok.line, col=tok.col)
            )
        self.expect("PUNCT", ";")
        return decls

    # ------------------------------------------------------------- statements

    def parse_statement(self) -> A.Node:
        tok = self.peek()
        if self._looks_like_type():
            return self.parse_declaration()
        if self.at("KEYWORD", "for"):
            return self.parse_for()
        if self.at("KEYWORD", "while"):
            self.next()
            self.expect("PUNCT", "(")
            cond = self.parse_expr()
            self.expect("PUNCT", ")")
            body = self.parse_body()
            return A.While(cond=cond, body=body, line=tok.line, col=tok.col)
        if self.at("KEYWORD", "if"):
            return self.parse_if()
        if self.at("KEYWORD", "break"):
            self.next(); self.expect("PUNCT", ";")
            return A.Break(line=tok.line, col=tok.col)
        if self.at("KEYWORD", "continue"):
            self.next(); self.expect("PUNCT", ";")
            return A.Continue(line=tok.line, col=tok.col)
        if self.at("KEYWORD", "return"):
            self.next()
            value = None
            if not self.at("PUNCT", ";"):
                value = self.parse_expr()
            self.expect("PUNCT", ";")
            return A.Return(value=value, line=tok.line, col=tok.col)
        if self.at("KEYWORD", "print") or self.at("KEYWORD", "reject") or \
                self.at("KEYWORD", "fatal_error"):
            kind = self.next().value
            self.expect("PUNCT", "(")
            args = []
            while not self.at("PUNCT", ")"):
                args.append(self.parse_expr())
                if self.at("PUNCT", ","):
                    self.next()
            self.expect("PUNCT", ")")
            self.expect("PUNCT", ";")
            cls = A.Print if kind == "print" else A.Reject
            return cls(args=args, line=tok.line, col=tok.col)
        if self.at("KEYWORD", "target"):
            self.next()
            if self.at("OP", "+="):
                self.next()
                value = self.parse_expr()
                self.expect("PUNCT", ";")
                return A.TargetPlus(value=value, line=tok.line, col=tok.col)
            raise self.error("expected '+=' after 'target'")
        # Stan constructs this compiler does not implement, refused with a
        # precise error where the parser would otherwise misread them
        if (self.at("IDENT", "jacobian") or self.at("KEYWORD", "jacobian")) \
                and self.at("OP", "+=", k=1):
            raise StanCompileError(
                "'jacobian +=' statements are not supported (write the "
                "log Jacobian into 'target +=')", tok.line, tok.col,
            )
        if (self.at("IDENT", "profile") or self.at("KEYWORD", "profile")) \
                and self.at("PUNCT", "(", k=1):
            raise StanCompileError(
                "profile blocks are not supported (remove the "
                "'profile(...)' wrapper and keep its statements)",
                tok.line, tok.col,
            )
        if self.at("PUNCT", "{"):
            # bare block: inline its statements
            stmts = self.parse_stmt_block()
            blk = A.If(
                cond=A.Num(value=1, is_int=True), then=stmts, orelse=[],
                line=tok.line, col=tok.col,
            )
            return blk
        # expression statement: assignment or sampling
        expr = self.parse_expr()
        if self.peek().kind == "OP" and self.peek().value in _ASSIGN_OPS:
            op = self.next().value
            value = self.parse_expr()
            self.expect("PUNCT", ";")
            return A.Assign(
                target=expr, op=op, value=value, line=tok.line, col=tok.col
            )
        if self.at("OP", "~"):
            self.next()
            name = self.expect("IDENT").value
            self.expect("PUNCT", "(")
            args = []
            while not self.at("PUNCT", ")"):
                args.append(self.parse_expr())
                if self.at("PUNCT", ","):
                    self.next()
            self.expect("PUNCT", ")")
            trunc = None
            if self.at("IDENT", "T") or self.at("KEYWORD", "T"):
                self.next()
                self.expect("PUNCT", "[")
                lo = None if self.at("PUNCT", ",") else self.parse_expr()
                self.expect("PUNCT", ",")
                up = None if self.at("PUNCT", "]") else self.parse_expr()
                self.expect("PUNCT", "]")
                trunc = (lo, up)
            self.expect("PUNCT", ";")
            return A.Sampling(
                target=expr, dist=name, args=args, truncation=trunc,
                line=tok.line, col=tok.col,
            )
        self.expect("PUNCT", ";")
        # bare expression statement (e.g. a function call): keep as print-less
        return A.Print(args=[expr], line=tok.line, col=tok.col)

    def parse_body(self) -> list:
        if self.at("PUNCT", "{"):
            return self.parse_stmt_block()
        stmt = self.parse_statement()
        return stmt if isinstance(stmt, list) else [stmt]

    def parse_for(self) -> A.For:
        tok = self.expect("KEYWORD", "for")
        self.expect("PUNCT", "(")
        var = self.expect("IDENT").value
        self.expect("KEYWORD", "in")
        lower = self.parse_expr()
        if self.at("PUNCT", ")"):
            raise StanCompileError(
                f"foreach loops 'for ({var} in ...)' over the elements of a "
                f"container are not supported (loop over indices, "
                f"'for (i in 1:size(...))')", tok.line, tok.col,
            )
        self.expect("OP", ":")
        upper = self.parse_expr()
        self.expect("PUNCT", ")")
        body = self.parse_body()
        return A.For(
            var=var, lower=lower, upper=upper, body=body,
            line=tok.line, col=tok.col,
        )

    def parse_if(self) -> A.If:
        tok = self.expect("KEYWORD", "if")
        self.expect("PUNCT", "(")
        cond = self.parse_expr()
        self.expect("PUNCT", ")")
        then = self.parse_body()
        orelse = []
        if self.at("KEYWORD", "else"):
            self.next()
            if self.at("KEYWORD", "if"):
                orelse = [self.parse_if()]
            else:
                orelse = self.parse_body()
        return A.If(cond=cond, then=then, orelse=orelse, line=tok.line, col=tok.col)

    # ------------------------------------------------------------ expressions
    # precedence (low to high): ?: || && ==,!= <,<=,>,>= +,- *,/,%,.*,./
    #                           unary-,+,! ^,.^ (right) postfix([] ') primary

    def parse_expr(self, no_gt: bool = False) -> A.Node:
        return self.parse_ternary(no_gt)

    def parse_ternary(self, no_gt: bool = False) -> A.Node:
        cond = self.parse_or(no_gt)
        if self.at("OP", "?"):
            tok = self.next()
            if_true = self.parse_expr()
            self.expect("OP", ":")
            if_false = self.parse_ternary(no_gt)
            return A.Ternary(
                cond=cond, if_true=if_true, if_false=if_false,
                line=tok.line, col=tok.col,
            )
        return cond

    def _binary(self, sub, ops, no_gt=False):
        left = sub(no_gt)
        while self.peek().kind == "OP" and self.peek().value in ops:
            if no_gt and self.peek().value == ">":
                break
            tok = self.next()
            right = sub(no_gt)
            left = A.BinOp(
                op=tok.value, left=left, right=right, line=tok.line, col=tok.col
            )
        return left

    def parse_or(self, no_gt=False):
        return self._binary(self.parse_and, {"||"}, no_gt)

    def parse_and(self, no_gt=False):
        return self._binary(self.parse_equality, {"&&"}, no_gt)

    def parse_equality(self, no_gt=False):
        return self._binary(self.parse_relational, {"==", "!="}, no_gt)

    def parse_relational(self, no_gt=False):
        ops = {"<", "<=", ">", ">="}
        return self._binary(self.parse_additive, ops, no_gt)

    def parse_additive(self, no_gt=False):
        return self._binary(self.parse_multiplicative, {"+", "-"}, no_gt)

    def parse_multiplicative(self, no_gt=False):
        return self._binary(self.parse_unary, {"*", "/", "%", ".*", "./"}, no_gt)

    def parse_unary(self, no_gt=False):
        tok = self.peek()
        if tok.kind == "OP" and tok.value in ("-", "+", "!"):
            self.next()
            operand = self.parse_unary(no_gt)
            return A.UnaryOp(
                op=tok.value, operand=operand, line=tok.line, col=tok.col
            )
        return self.parse_power(no_gt)

    def parse_power(self, no_gt=False):
        base = self.parse_postfix(no_gt)
        if self.peek().kind == "OP" and self.peek().value in ("^", ".^"):
            tok = self.next()
            exponent = self.parse_unary(no_gt)  # right associative
            return A.BinOp(
                op=tok.value, left=base, right=exponent,
                line=tok.line, col=tok.col,
            )
        return base

    def parse_postfix(self, no_gt=False):
        expr = self.parse_primary()
        while True:
            if self.at("PUNCT", "["):
                tok = self.next()
                indices = []
                while not self.at("PUNCT", "]"):
                    indices.append(self.parse_index_expr())
                    if self.at("PUNCT", ","):
                        self.next()
                self.expect("PUNCT", "]")
                expr = A.Index(
                    base=expr, indices=indices, line=tok.line, col=tok.col
                )
            elif self.at("OP", "'"):
                tok = self.next()
                expr = A.Transpose(operand=expr, line=tok.line, col=tok.col)
            elif self.at("OP", "."):
                tok = self.next()
                field = self.peek()
                if (field.kind == "REAL" and "." in field.value
                        and "e" not in field.value.lower()):
                    # chained slot access `x.2.1` lexes the `2.1` as one
                    # REAL token (and `x.1.real` lexes `1.` as REAL with a
                    # trailing dot); split into consecutive member accesses
                    first, second = field.value.split(".", 1)
                    if first.isdigit() and second.isdigit():
                        self.next()
                        expr = A.Member(
                            base=expr, field=first,
                            line=tok.line, col=tok.col,
                        )
                        expr = A.Member(
                            base=expr, field=second,
                            line=field.line, col=field.col,
                        )
                        continue
                    if first.isdigit() and second == "":
                        self.next()
                        expr = A.Member(
                            base=expr, field=first,
                            line=tok.line, col=tok.col,
                        )
                        nxt = self.peek()
                        if nxt.kind not in ("INT", "IDENT", "KEYWORD"):
                            raise StanCompileError(
                                "expected a tuple slot number or "
                                f"'real'/'imag' after '.', found "
                                f"{nxt.value!r}",
                                nxt.line, nxt.col,
                            )
                        self.next()
                        expr = A.Member(
                            base=expr, field=nxt.value,
                            line=nxt.line, col=nxt.col,
                        )
                        continue
                if field.kind not in ("INT", "IDENT", "KEYWORD"):
                    raise StanCompileError(
                        "expected a tuple slot number or 'real'/'imag' "
                        f"after '.', found {field.value!r}",
                        field.line, field.col,
                    )
                self.next()
                expr = A.Member(
                    base=expr, field=field.value, line=tok.line, col=tok.col
                )
            else:
                break
        return expr

    def parse_index_expr(self) -> A.Node:
        tok = self.peek()
        if self.at("OP", ":"):
            self.next()
            if self.at("PUNCT", ",") or self.at("PUNCT", "]"):
                return A.Colon(line=tok.line, col=tok.col)
            upper = self.parse_expr()
            return A.Range(lower=None, upper=upper, line=tok.line, col=tok.col)
        first = self.parse_expr()
        if self.at("OP", ":"):
            self.next()
            if self.at("PUNCT", ",") or self.at("PUNCT", "]"):
                return A.Range(lower=first, upper=None, line=tok.line, col=tok.col)
            upper = self.parse_expr()
            return A.Range(lower=first, upper=upper, line=tok.line, col=tok.col)
        return first

    def parse_primary(self) -> A.Node:
        tok = self.peek()
        if tok.kind == "INT":
            self.next()
            return A.Num(value=int(tok.value), is_int=True, line=tok.line, col=tok.col)
        if tok.kind == "REAL":
            self.next()
            return A.Num(
                value=float(tok.value), is_int=False, line=tok.line, col=tok.col
            )
        if tok.kind == "STRING":
            self.next()
            return A.StringLit(value=tok.value, line=tok.line, col=tok.col)
        if tok.kind == "IMAG":
            self.next()
            return A.Num(
                value=float(tok.value), is_int=False, is_imag=True,
                line=tok.line, col=tok.col,
            )
        if self.at("PUNCT", "("):
            self.next()
            expr = self.parse_expr()
            if self.at("PUNCT", ","):
                # tuple literal: (e1, e2, ...)
                elements = [expr]
                while self.at("PUNCT", ","):
                    self.next()
                    elements.append(self.parse_expr())
                self.expect("PUNCT", ")")
                return A.TupleLit(
                    elements=elements, line=tok.line, col=tok.col
                )
            self.expect("PUNCT", ")")
            return expr
        if self.at("PUNCT", "{"):
            self.next()
            elements = []
            while not self.at("PUNCT", "}"):
                elements.append(self.parse_expr())
                if self.at("PUNCT", ","):
                    self.next()
            self.expect("PUNCT", "}")
            return A.ArrayLit(elements=elements, line=tok.line, col=tok.col)
        if self.at("PUNCT", "["):
            self.next()
            elements = []
            while not self.at("PUNCT", "]"):
                elements.append(self.parse_expr())
                if self.at("PUNCT", ","):
                    self.next()
            self.expect("PUNCT", "]")
            return A.RowVectorLit(elements=elements, line=tok.line, col=tok.col)
        if self.at("KEYWORD", "target"):
            self.next()
            self.expect("PUNCT", "(")
            self.expect("PUNCT", ")")
            return A.Call(name="target", args=[], line=tok.line, col=tok.col)
        if tok.kind in ("IDENT", "KEYWORD"):
            # keywords like `lower` can appear as function args in theory;
            # treat identifiers and non-structural keywords as names
            self.next()
            if self.at("PUNCT", "("):
                self.next()
                args = []
                bar_split = -1
                while not self.at("PUNCT", ")"):
                    args.append(self.parse_expr())
                    if self.at("OP", "|"):
                        self.next()
                        bar_split = len(args)
                    elif self.at("PUNCT", ","):
                        self.next()
                self.expect("PUNCT", ")")
                return A.Call(
                    name=tok.value, args=args, bar_split=bar_split,
                    line=tok.line, col=tok.col,
                )
            return A.Var(name=tok.value, line=tok.line, col=tok.col)
        raise StanCompileError(
            f"unexpected token {tok.value!r}", tok.line, tok.col
        )


def parse(src: str) -> A.Program:
    return Parser(tokenize(src)).parse_program()
