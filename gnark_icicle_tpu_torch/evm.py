"""Execute exported Solidity verifiers: a Solidity-subset interpreter with
EVM precompiles backed by the host curve/pairing code.

Role parity: the reference shells out to gnark-solidity-checker, compiles
the exported contract with solc and runs proofs through a real EVM
(the reference's test/assert_solidity.go:1-96, backend/groth16/bn254/
solidity.go + backend/plonk/bn254/solidity.go templates). Without solc or
a network, this module interprets the emitted
contract SOURCE directly: a lexer + recursive-descent evaluator for the
exact Solidity subset the two templates use (uint256 checked arithmetic,
fixed memory arrays, bytes/bytes32, abi.encodePacked, sha256, for/if/
revert, tuple returns, and `assembly { staticcall }` blocks routed to
precompile implementations 0x05-0x08 over curves/bn254 + the host
pairing). Because it executes what the template EMITS — not what it
means — a wrong constant, swapped pair ordering, bad calldata index or
broken transcript byte layout fails the run, which is the assurance
gnark-solidity-checker provides upstream.

EVM semantics intentionally honored:
  - solidity >=0.8 checked arithmetic (overflow/underflow reverts);
  - precompile failures (points not on curve, coordinates >= p, bad
    pairing input length) make staticcall return 0 -> revert(0, 0);
  - ecpairing enforces the EIP-197 G2 subgroup check;
  - (0, 0) is the point at infinity for ecadd/ecmul/ecpairing inputs.

Copied from gnark_icicle_tpu/evm.py:1, so that the port imports nothing of
the JAX package: its precompiles run over the port's curves/bn254 and
pairing. tests/test_torch_solidity.py holds its results, reverts and
precompile bytes to the original's.
"""

from __future__ import annotations

import hashlib
import re


U256 = (1 << 256) - 1


class Revert(Exception):
    """EVM revert. `error` carries the custom error name ('' for bare)."""

    def __init__(self, error: str = ""):
        self.error = error
        super().__init__(f"revert {error or '(raw)'}")


class SizedInt(int):
    """uintN-cast value inside abi.encodePacked (N < 256)."""

    def __new__(cls, val, nbytes):
        self = super().__new__(cls, val)
        self.nbytes = nbytes
        return self


# ---------------------------------------------------------------------------
# lexer
# ---------------------------------------------------------------------------

_TOKEN_RE = re.compile(
    r"""
    (?P<ws>\s+|//[^\n]*)
  | (?P<hex>0x[0-9a-fA-F]+)
  | (?P<num>\d+)
  | (?P<str>"[^"]*")
  | (?P<id>[A-Za-z_$][A-Za-z0-9_$]*)
  | (?P<op><<|>>|==|!=|<=|>=|&&|\|\||\+\+|--|[-+*/%^!&|<>=?:;,.(){}\[\]~])
""",
    re.VERBOSE,
)


def tokenize(src: str):
    toks = []
    pos = 0
    while pos < len(src):
        m = _TOKEN_RE.match(src, pos)
        if m is None:
            raise SyntaxError(f"lex error at {src[pos:pos+30]!r}")
        pos = m.end()
        if m.lastgroup == "ws":
            continue
        toks.append((m.lastgroup, m.group()))
    toks.append(("eof", ""))
    return toks


# ---------------------------------------------------------------------------
# parser — produces nested tuples ("kind", ...)
# ---------------------------------------------------------------------------

_TYPES = {"uint256", "uint16", "uint8", "bytes", "bytes32", "bool"}
_LOCS = {"memory", "calldata"}
_MODS = {"public", "private", "internal", "external", "view", "pure"}


class Parser:
    def __init__(self, toks):
        self.toks = toks
        self.i = 0

    def peek(self, k=0):
        return self.toks[self.i + k]

    def next(self):
        t = self.toks[self.i]
        self.i += 1
        return t

    def expect(self, val):
        t = self.next()
        if t[1] != val:
            raise SyntaxError(f"expected {val!r}, got {t[1]!r} (#{self.i})")
        return t

    def accept(self, val):
        if self.peek()[1] == val:
            self.next()
            return True
        return False

    # -- type of the token at offset k starts a type? ----------------------
    def _is_type(self, k=0):
        return self.peek(k)[1] in _TYPES

    def parse_type(self):
        """Returns (base, array_len|None); consumes location keyword."""
        base = self.next()[1]
        n = None
        if self.accept("["):
            if self.peek()[1] != "]":
                n = self.parse_expr()  # constant-folded at decl time
            self.expect("]")
        if self.peek()[1] in _LOCS:
            self.next()
        return (base, n)

    # -- contract level ------------------------------------------------------
    def parse_contract(self):
        while self.peek()[1] != "contract":
            self.next()  # pragma / SPDX already stripped by comments; skip
        self.expect("contract")
        name = self.next()[1]
        self.expect("{")
        consts, funcs, errors = {}, {}, set()
        while self.peek()[1] != "}":
            t = self.peek()
            if t[1] == "error":
                self.next()
                errors.add(self.next()[1])
                self.expect("(")
                self.expect(")")
                self.expect(";")
            elif t[1] == "function":
                f = self.parse_function()
                funcs[f["name"]] = f
            elif t[1] in _TYPES:
                # uint256 private constant NAME = <literal expr>;
                self.parse_type()
                while self.peek()[1] in _MODS or self.peek()[1] == "constant":
                    self.next()
                cname = self.next()[1]
                self.expect("=")
                cval = self.parse_expr()
                self.expect(";")
                consts[cname] = cval
            else:
                raise SyntaxError(f"contract item? {t}")
        return {"name": name, "constants": consts, "functions": funcs,
                "errors": errors}

    def parse_function(self):
        self.expect("function")
        name = self.next()[1]
        self.expect("(")
        params = []
        while self.peek()[1] != ")":
            ty = self.parse_type()
            pname = self.next()[1]
            params.append((ty, pname))
            if not self.accept(","):
                break
        self.expect(")")
        n_ret = 0
        while self.peek()[1] != "{":
            if self.peek()[1] == "returns":
                self.next()
                self.expect("(")
                depth = 1
                n_ret = 1
                while depth:
                    t = self.next()[1]
                    if t == "(":
                        depth += 1
                    elif t == ")":
                        depth -= 1
                    elif t == "," and depth == 1:
                        n_ret += 1
            else:
                self.next()  # visibility/mutability
        body = self.parse_block()
        return {"name": name, "params": params, "body": body,
                "n_ret": n_ret}

    # -- statements ------------------------------------------------------
    def parse_block(self):
        self.expect("{")
        stmts = []
        while self.peek()[1] != "}":
            stmts.append(self.parse_stmt())
        self.expect("}")
        return ("block", stmts)

    def parse_stmt(self):
        t = self.peek()
        if t[1] == "{":
            return self.parse_block()
        if t[1] == "assembly":
            self.next()
            # capture the raw brace-matched token span
            self.expect("{")
            depth, parts = 1, []
            while depth:
                tok = self.next()
                if tok[1] == "{":
                    depth += 1
                elif tok[1] == "}":
                    depth -= 1
                    if depth == 0:
                        break
                parts.append(tok[1])
            return ("asm", " ".join(parts))
        if t[1] == "if":
            self.next()
            self.expect("(")
            cond = self.parse_expr()
            self.expect(")")
            then = self.parse_stmt()
            els = self.parse_stmt() if self.accept("else") else None
            return ("if", cond, then, els)
        if t[1] == "for":
            self.next()
            self.expect("(")
            init = self.parse_stmt()  # consumes its ';'
            cond = self.parse_expr()
            self.expect(";")
            # post: `i++` only
            var = self.next()[1]
            self.expect("++")
            self.expect(")")
            body = self.parse_stmt()
            return ("for", init, cond, ("incr", var), body)
        if t[1] == "return":
            self.next()
            if self.peek()[1] == ";":
                self.next()
                return ("return", None)
            e = self.parse_expr_or_tuple()
            self.expect(";")
            return ("return", e)
        if t[1] == "revert":
            self.next()
            ename = ""
            if self.peek()[0] == "id":
                ename = self.next()[1]
            self.expect("(")
            while self.peek()[1] != ")":
                self.next()
            self.expect(")")
            self.expect(";")
            return ("revert", ename)
        if t[1] in _TYPES:
            ty = self.parse_type()
            vname = self.next()[1]
            init = None
            if self.accept("="):
                init = self.parse_expr_or_tuple()
            self.expect(";")
            return ("decl", ty, vname, init)
        if t[1] == "(":
            # tuple decl `(uint256 a, uint256 b) = e;` or tuple assign
            self.next()
            if self._is_type():
                names = []
                while True:
                    self.parse_type()
                    names.append(self.next()[1])
                    if not self.accept(","):
                        break
                self.expect(")")
                self.expect("=")
                e = self.parse_expr_or_tuple()
                self.expect(";")
                return ("tdecl", names, e)
            lvs = [self.parse_expr()]
            while self.accept(","):
                lvs.append(self.parse_expr())
            self.expect(")")
            self.expect("=")
            e = self.parse_expr_or_tuple()
            self.expect(";")
            return ("tassign", lvs, e)
        # assignment or expression statement
        e = self.parse_expr()
        if self.accept("="):
            rhs = self.parse_expr_or_tuple()
            self.expect(";")
            return ("assign", e, rhs)
        self.expect(";")
        return ("expr", e)

    # -- expressions -------------------------------------------------------
    def parse_expr_or_tuple(self):
        e = self.parse_expr()
        if self.peek()[1] == ",":
            items = [e]
            while self.accept(","):
                items.append(self.parse_expr())
            return ("tuple", items)
        return e

    def parse_expr(self):
        return self.parse_ternary()

    def parse_ternary(self):
        c = self.parse_or()
        if self.accept("?"):
            a = self.parse_expr()
            self.expect(":")
            b = self.parse_expr()
            return ("ternary", c, a, b)
        return c

    def _binop_level(self, sub, ops):
        e = sub()
        while self.peek()[1] in ops:
            op = self.next()[1]
            e = ("bin", op, e, sub())
        return e

    def parse_or(self):
        return self._binop_level(self.parse_and, {"||"})

    def parse_and(self):
        return self._binop_level(self.parse_eq, {"&&"})

    def parse_eq(self):
        return self._binop_level(self.parse_rel, {"==", "!="})

    def parse_rel(self):
        return self._binop_level(self.parse_xor, {"<", ">", "<=", ">="})

    def parse_xor(self):
        return self._binop_level(self.parse_add, {"^"})

    def parse_add(self):
        return self._binop_level(self.parse_mul, {"+", "-"})

    def parse_mul(self):
        return self._binop_level(self.parse_shift, {"*", "/", "%"})

    def parse_shift(self):
        return self._binop_level(self.parse_unary, {"<<", ">>"})

    def parse_unary(self):
        if self.accept("!"):
            return ("not", self.parse_unary())
        if self.peek()[1] == "new":
            pass  # 'new' is an id token; handled in postfix via call form
        return self.parse_postfix()

    def parse_postfix(self):
        e = self.parse_atom()
        while True:
            t = self.peek()[1]
            if t == "(":
                self.next()
                args = []
                while self.peek()[1] != ")":
                    args.append(self.parse_expr())
                    if not self.accept(","):
                        break
                self.expect(")")
                e = ("call", e, args)
            elif t == "[":
                self.next()
                idx = self.parse_expr()
                self.expect("]")
                e = ("index", e, idx)
            elif t == ".":
                self.next()
                e = ("member", e, self.next()[1])
            else:
                return e

    def parse_atom(self):
        kind, val = self.next()
        if kind == "hex":
            return ("num", int(val, 16))
        if kind == "num":
            return ("num", int(val))
        if kind == "str":
            return ("str", val[1:-1])
        if kind == "id":
            if val == "new":
                # `new bytes(64)`
                self.expect("bytes")
                self.expect("(")
                n = self.parse_expr()
                self.expect(")")
                return ("newbytes", n)
            return ("var", val)
        if val == "(":
            e = self.parse_expr()
            if self.peek()[1] == ",":  # parenthesized tuple literal
                items = [e]
                while self.accept(","):
                    items.append(self.parse_expr())
                self.expect(")")
                return ("tuple", items)
            self.expect(")")
            return e
        if val == "[":
            items = []
            while self.peek()[1] != "]":
                items.append(self.parse_expr())
                if not self.accept(","):
                    break
            self.expect("]")
            return ("arraylit", items)
        raise SyntaxError(f"atom? {kind} {val!r}")


# ---------------------------------------------------------------------------
# precompiles (EVM addresses 0x05-0x08 on the BN254 host curve)
# ---------------------------------------------------------------------------

def _bn254():
    from .curves import bn254

    return bn254


def _g1_from_words(x, y):
    """EVM words -> host G1 point / None; raises ValueError when invalid."""
    bn = _bn254()
    p = bn.P
    if x >= p or y >= p:
        raise ValueError("coordinate >= p")
    if x == 0 and y == 0:
        return None
    pt = (x, y)
    if not bn.G1.is_on_curve(pt):
        raise ValueError("not on curve")
    return pt


def _precompile(addr: int, data: bytes) -> bytes | None:
    """Returns output bytes, or None = precompile failure (staticcall -> 0)."""
    bn = _bn254()
    try:
        if addr == 5:  # MODEXP (EIP-198)
            blen = int.from_bytes(data[0:32], "big")
            elen = int.from_bytes(data[32:64], "big")
            mlen = int.from_bytes(data[64:96], "big")
            rest = data[96:]
            rest = rest + b"\x00" * (blen + elen + mlen - len(rest))
            base = int.from_bytes(rest[:blen], "big")
            exp = int.from_bytes(rest[blen:blen + elen], "big")
            mod = int.from_bytes(rest[blen + elen:blen + elen + mlen], "big")
            out = 0 if mod == 0 else pow(base, exp, mod)
            return out.to_bytes(mlen, "big")
        if addr == 6:  # BN_ADD
            data = data + b"\x00" * (128 - len(data)) if len(data) < 128 else data
            w = [int.from_bytes(data[i:i + 32], "big") for i in range(0, 128, 32)]
            a = _g1_from_words(w[0], w[1])
            b = _g1_from_words(w[2], w[3])
            s = bn.G1.add(a, b)
            return b"".join(
                c.to_bytes(32, "big") for c in (s if s else (0, 0))
            )
        if addr == 7:  # BN_MUL
            data = data + b"\x00" * (96 - len(data)) if len(data) < 96 else data
            w = [int.from_bytes(data[i:i + 32], "big") for i in range(0, 96, 32)]
            a = _g1_from_words(w[0], w[1])
            s = bn.G1.scalar_mul(a, w[2]) if a is not None else None
            return b"".join(
                c.to_bytes(32, "big") for c in (s if s else (0, 0))
            )
        if addr == 8:  # BN_PAIRING (EIP-197)
            if len(data) % 192 != 0:
                return None
            from .curves.tower import Fp2

            pairs = []
            for off in range(0, len(data), 192):
                w = [int.from_bytes(data[off + i:off + i + 32], "big")
                     for i in range(0, 192, 32)]
                g1 = _g1_from_words(w[0], w[1])
                # Fp2 words arrive imaginary-first (EIP-197)
                for c in w[2:6]:
                    if c >= bn.P:
                        raise ValueError("fp2 coordinate >= p")
                if all(c == 0 for c in w[2:6]):
                    g2 = None
                else:
                    g2 = (Fp2(bn.TOWER, w[3], w[2]), Fp2(bn.TOWER, w[5], w[4]))
                    if not bn.G2.is_on_curve(g2):
                        raise ValueError("g2 not on curve")
                    if not bn.G2.in_subgroup(g2):
                        raise ValueError("g2 not in subgroup")
                if g1 is None or g2 is None:
                    continue  # pairing with infinity contributes 1
                pairs.append((g1, g2))
            ok = bn.BN254.pairing(pairs) if pairs else True
            return (1 if ok else 0).to_bytes(32, "big")
    except ValueError:
        return None
    return None


_STATICCALL_RE = re.compile(
    r"if iszero \( staticcall \( gas \( \) , (\w+) , (\w+) , "
    r"(0x[0-9a-fA-F]+|\d+) , (\w+) , (0x[0-9a-fA-F]+|\d+) \) \)"
)


# ---------------------------------------------------------------------------
# interpreter
# ---------------------------------------------------------------------------

class _Return(Exception):
    def __init__(self, value):
        self.value = value


class SolidityContract:
    """Parse once, call public functions with Python ints/lists."""

    def __init__(self, source: str):
        ast = Parser(tokenize(source)).parse_contract()
        self.name = ast["name"]
        self.functions = ast["functions"]
        self.errors = ast["errors"]
        self.constants = {}
        for cname, cexpr in ast["constants"].items():
            self.constants[cname] = self._eval(cexpr, [self.constants])

    # -- public API ---------------------------------------------------------
    def call(self, fn_name: str, *args):
        """Invoke a contract function. Raises Revert on failure."""
        return self._call_fn(self.functions[fn_name], list(args))

    def call_calldata(self, fn_name: str, data: bytes):
        """ABI-decode `data` (no selector) against the function's parameter
        types — static uint256[N] arrays only — then call. Exercises the
        exact calldata word layout the contract documents."""
        fn = self.functions[fn_name]
        args, off = [], 0
        for (base, alen), _ in fn["params"]:
            if alen is not None:
                n = self._eval(alen, [self.constants])
                args.append([
                    int.from_bytes(data[off + 32 * i: off + 32 * (i + 1)],
                                   "big")
                    for i in range(n)
                ])
                off += 32 * n
            else:
                args.append(int.from_bytes(data[off:off + 32], "big"))
                off += 32
        if off != len(data):
            raise Revert("")  # calldata size mismatch
        return self._call_fn(fn, args)

    # -- execution ------------------------------------------------------------
    def _call_fn(self, fn, args):
        if len(args) != len(fn["params"]):
            raise TypeError(f"{fn['name']} wants {len(fn['params'])} args")
        env = [self.constants, {}]
        for (_, pname), v in zip(fn["params"], args):
            env[-1][pname] = v
        try:
            self._exec(fn["body"], env)
        except _Return as r:
            return r.value
        return None

    def _exec(self, stmt, env):
        kind = stmt[0]
        if kind == "block":
            env.append({})
            try:
                for s in stmt[1]:
                    self._exec(s, env)
            finally:
                env.pop()
        elif kind == "decl":
            (base, alen), name, init = stmt[1], stmt[2], stmt[3]
            if init is not None:
                env[-1][name] = self._eval(init, env)
            elif alen is not None:
                env[-1][name] = [0] * self._eval(alen, env)
            elif base == "bytes":
                env[-1][name] = b""
            else:
                env[-1][name] = 0
        elif kind == "tdecl":
            vals = self._eval(stmt[2], env)
            for n, v in zip(stmt[1], vals):
                env[-1][n] = v
        elif kind == "tassign":
            vals = self._eval(stmt[2], env)
            for lv, v in zip(stmt[1], vals):
                self._store(lv, v, env)
        elif kind == "assign":
            self._store(stmt[1], self._eval(stmt[2], env), env)
        elif kind == "if":
            if self._eval(stmt[1], env):
                self._exec(stmt[2], env)
            elif stmt[3] is not None:
                self._exec(stmt[3], env)
        elif kind == "for":
            env.append({})
            try:
                self._exec(stmt[1], env)
                var = stmt[3][1]
                while self._eval(stmt[2], env):
                    self._exec(stmt[4], env)
                    self._store(("var", var), self._lookup(var, env) + 1, env)
            finally:
                env.pop()
        elif kind == "return":
            raise _Return(
                None if stmt[1] is None else self._eval(stmt[1], env)
            )
        elif kind == "revert":
            raise Revert(stmt[1])
        elif kind == "expr":
            self._eval(stmt[1], env)
        elif kind == "asm":
            self._exec_asm(stmt[1], env)
        else:
            raise RuntimeError(f"stmt? {kind}")

    def _exec_asm(self, text, env):
        m = _STATICCALL_RE.search(text)
        if m is None:
            raise RuntimeError(f"unsupported assembly: {text!r}")
        addr = int(m.group(1), 0)
        in_arr = self._lookup(m.group(2), env)
        in_size = int(m.group(3), 0)
        out_arr = self._lookup(m.group(4), env)
        out_size = int(m.group(5), 0)
        data = b"".join(int(w).to_bytes(32, "big") for w in in_arr)[:in_size]
        out = _precompile(addr, data)
        if out is None:
            raise Revert("")  # the template's revert(0, 0)
        out = out[:out_size].ljust(out_size, b"\x00")
        for i in range(out_size // 32):
            out_arr[i] = int.from_bytes(out[32 * i:32 * (i + 1)], "big")

    # -- lvalues / environment -----------------------------------------------
    def _lookup(self, name, env):
        for scope in reversed(env):
            if name in scope:
                return scope[name]
        raise NameError(name)

    def _store(self, lv, val, env):
        if lv[0] == "var":
            name = lv[1]
            for scope in reversed(env):
                if name in scope:
                    scope[name] = val
                    return
            raise NameError(name)
        if lv[0] == "index":
            arr = self._eval(lv[1], env)
            arr[self._eval(lv[2], env)] = val
            return
        raise RuntimeError(f"lvalue? {lv[0]}")

    # -- expressions -----------------------------------------------------------
    def _eval(self, e, env):
        kind = e[0]
        if kind == "num":
            return e[1]
        if kind == "str":
            return e[1]  # string literal: utf-8 bytes in encodePacked
        if kind == "var":
            return self._lookup(e[1], env)
        if kind == "tuple":
            return tuple(self._eval(x, env) for x in e[1])
        if kind == "arraylit":
            return [self._eval(x, env) for x in e[1]]
        if kind == "newbytes":
            return bytes(self._eval(e[1], env))
        if kind == "index":
            return self._eval(e[1], env)[self._eval(e[2], env)]
        if kind == "ternary":
            return (self._eval(e[2], env) if self._eval(e[1], env)
                    else self._eval(e[3], env))
        if kind == "not":
            return not self._eval(e[1], env)
        if kind == "bin":
            op = e[1]
            if op == "&&":
                return bool(self._eval(e[2], env)) and bool(
                    self._eval(e[3], env))
            if op == "||":
                return bool(self._eval(e[2], env)) or bool(
                    self._eval(e[3], env))
            a = self._eval(e[2], env)
            b = self._eval(e[3], env)
            if op == "==":
                return a == b
            if op == "!=":
                return a != b
            if op == "<":
                return a < b
            if op == ">":
                return a > b
            if op == "<=":
                return a <= b
            if op == ">=":
                return a >= b
            if op == "^":
                if isinstance(a, bytes):
                    return bytes(x ^ y for x, y in zip(a, b))
                return a ^ b
            if op == "+":
                r = a + b
            elif op == "-":
                r = a - b
            elif op == "*":
                r = a * b
            elif op == "/":
                if b == 0:
                    raise Revert("")
                r = a // b
            elif op == "%":
                if b == 0:
                    raise Revert("")
                r = a % b
            elif op == "<<":
                r = (a << b) & U256
                return r
            elif op == ">>":
                return a >> b
            else:
                raise RuntimeError(f"op? {op}")
            if r < 0 or r > U256:
                raise Revert("")  # solidity >=0.8 checked arithmetic
            return r
        if kind == "member":
            # only abi.encodePacked
            return ("builtin-member", e[1], e[2])
        if kind == "call":
            return self._call_expr(e[1], e[2], env)
        raise RuntimeError(f"expr? {kind}")

    def _call_expr(self, target, arg_exprs, env):
        # member call: abi.encodePacked(...)
        if target[0] == "member":
            base, attr = target[1], target[2]
            if base == ("var", "abi") and attr == "encodePacked":
                return b"".join(
                    self._pack(self._eval(a, env)) for a in arg_exprs
                )
            raise RuntimeError(f"member call? {attr}")
        if target[0] != "var":
            raise RuntimeError(f"call target? {target}")
        name = target[1]
        args = [self._eval(a, env) for a in arg_exprs]
        if name == "addmod":
            if args[2] == 0:
                raise Revert("")
            return (args[0] + args[1]) % args[2]
        if name == "mulmod":
            if args[2] == 0:
                raise Revert("")
            return (args[0] * args[1]) % args[2]
        if name == "sha256":
            return hashlib.sha256(args[0]).digest()
        if name == "keccak256":
            from .std.hash.mimc import keccak256 as _keccak

            return _keccak(args[0])
        if name == "uint256":
            v = args[0]
            return int.from_bytes(v, "big") if isinstance(v, bytes) else int(v)
        if name == "bytes32":
            v = args[0]
            return v if isinstance(v, bytes) else int(v).to_bytes(32, "big")
        if name == "uint8":
            return SizedInt(args[0], 1)
        if name == "uint16":
            return SizedInt(args[0], 2)
        if name in self.functions:
            return self._call_fn(self.functions[name], args)
        raise RuntimeError(f"unknown function {name}")

    @staticmethod
    def _pack(v):
        if isinstance(v, bytes):
            return v
        if isinstance(v, str):
            return v.encode()
        if isinstance(v, SizedInt):
            return int(v).to_bytes(v.nbytes, "big")
        if isinstance(v, bool):
            return bytes([1 if v else 0])
        if isinstance(v, int):
            return v.to_bytes(32, "big")
        raise RuntimeError(f"encodePacked? {type(v)}")


def strip_comments(src: str) -> str:
    """Drop // comments and the pragma/license header lines."""
    out = []
    for line in src.splitlines():
        if line.strip().startswith(("pragma", "// SPDX")):
            continue
        out.append(line)
    return "\n".join(out)


def load_contract(source: str) -> SolidityContract:
    return SolidityContract(strip_comments(source))
