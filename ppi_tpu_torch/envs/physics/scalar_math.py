"""A math namespace for the scalar physics program, dispatching on type.

The scalar-SoA program (``engine_soa``, the env callbacks) is written once
over this namespace and runs on three kinds of scalar:

  * a Python ``float`` -> ``math`` (model constants fold in float64, exactly
    as Python folds them before they meet a traced value in the JAX trace);
  * a ``numpy.float32`` -> ``math``, rounded back to float32: one lane of
    the program on the host in single precision (``render.
    trace_bic_trajectory``), each arithmetic operator numpy's f32 one;
  * a ``torch.Tensor`` of shape ``(N,)`` (or 0-dim) -> one torch op over all
    lanes: the eager plain version of the rollout kernel;
  * a ``Sym`` -> one line of CUDA C appended to an ``Emitter``: the code
    generator that writes the kernel's per-env body.

Comparisons that the program uses as numbers (``gt``, ``lt``) return 0/1
floats of the argument's kind; ``logical_and`` of two such flags, and a
flag times a value, are products (``0 * NaN`` is NaN, as in JAX). ``Sym``
overloads the arithmetic operators, so ``a * b + c`` in the program emits
two lines. Constants are written as
exact f32 hex literals with an ``f`` suffix, and only the ``f``-suffixed C
math functions are called, so every emitted operation is single precision.
``0.0 * x`` is emitted, never folded: a NaN has to reach the latch.
"""

import contextlib
import math
import re
import threading

import numpy as np
import torch


# ---- the symbolic scalar ----------------------------------------------------

def f32_literal(value: float) -> str:
    """The exact C literal of ``value`` rounded to f32 (a hex float)."""
    v = np.float32(value)
    if not np.isfinite(v):
        raise ValueError(f"non-finite constant {value!r} in the scalar program")
    text = float(v).hex() + "f"
    return f"({text})" if text.startswith("-") else text


# the text of an ``f32_literal``: a negative one is parenthesized
_LITERAL = re.compile(r"\(-0x[0-9a-f]\.[0-9a-f]+p[+-]\d+f\)"
                      r"|0x[0-9a-f]\.[0-9a-f]+p[+-]\d+f")


# what the program computes for while it runs (``owner``), per thread:
# several threads may generate bodies at once
_OWNER = threading.local()


@contextlib.contextmanager
def owner(tag):
    """Within the block, every line an ``Emitter`` emits is recorded as
    computed for ``tag`` (``Emitter.owners``): ``("body", b)``,
    ``("sphere", s)``, ``("pair", kind, i)`` (a contact pair of
    ``engine_soa.contact_forces_soa``), ``("mass", j)`` (the sum of a mass
    matrix entry in joint j's column) and ``("sum", j)`` (joint j's
    right-hand side: its passive torque and the sum of its terms). The
    innermost block wins. Over floats and tensors it does nothing, and no
    line changes: the split layout's subtree partition reads the record."""
    prev = getattr(_OWNER, "tag", None)
    _OWNER.tag = tag
    try:
        yield
    finally:
        _OWNER.tag = prev


class Emitter:
    """Collects the straight-line C body of one generated function.

    ``ops`` counts the f32 operations emitted: each arithmetic operator and
    each math or helper call is one, whatever its operands (a bare literal
    is none). ``owners`` maps each emitted name to the tag of the
    ``owner`` block it was emitted in (names emitted outside any are
    absent)."""

    def __init__(self):
        self.lines = []
        self.owners = {}
        self._n = 0
        self.ops = 0

    def emit(self, expr: str) -> "Sym":
        name = f"t{self._n}"
        self._n += 1
        self.lines.append(f"  const float {name} = {expr};")
        if not _LITERAL.fullmatch(expr):
            self.ops += 1
        tag = getattr(_OWNER, "tag", None)
        if tag is not None:
            self.owners[name] = tag
        return Sym(self, name)

    def input(self, name: str, c_expr: str) -> "Sym":
        """Bind a function argument (``q[0]``) to a local once."""
        self.lines.append(f"  const float {name} = {c_expr};")
        return Sym(self, name)


def c_function(signature: str, em: Emitter, outputs) -> str:
    """The C text of one generated function: ``em``'s lines, then each
    ``(lvalue, scalar)`` of ``outputs`` assigned."""
    body = "\n".join(em.lines + [f"  {lhs} = {_operand(v)};"
                                 for lhs, v in outputs])
    return f"PPI_QUAL {signature} {{\n{body}\n}}\n"


def _operand(x) -> str:
    if isinstance(x, Sym):
        return x.name
    if isinstance(x, (int, float)):
        return f32_literal(float(x))
    raise TypeError(f"cannot emit {type(x).__name__} into the kernel body")


class Sym:
    """One f32 value of the generated program, named by a C local."""

    __slots__ = ("em", "name")

    def __init__(self, em: Emitter, name: str):
        self.em = em
        self.name = name

    def _bin(self, op, a, b):
        return self.em.emit(f"{_operand(a)} {op} {_operand(b)}")

    def __add__(self, o): return self._bin("+", self, o)
    def __radd__(self, o): return self._bin("+", o, self)
    def __sub__(self, o): return self._bin("-", self, o)
    def __rsub__(self, o): return self._bin("-", o, self)
    def __mul__(self, o): return self._bin("*", self, o)
    def __rmul__(self, o): return self._bin("*", o, self)
    def __truediv__(self, o): return self._bin("/", self, o)
    def __rtruediv__(self, o): return self._bin("/", o, self)

    def __neg__(self):
        return self.em.emit(f"-{self.name}")

    def __bool__(self):
        raise TypeError("a symbolic scalar has no truth value: use "
                        "scalar_math.where instead of Python branching")


def _sym_of(*args):
    for a in args:
        if isinstance(a, Sym):
            return a
    return None


def _tensor_of(*args):
    for a in args:
        if isinstance(a, torch.Tensor):
            return a
    return None


def _call(fn: str, *args) -> Sym:
    s = _sym_of(*args)
    return s.em.emit(f"{fn}({', '.join(_operand(a) for a in args)})")


# ---- the namespace ------------------------------------------------------------

def _host(x, value):
    """A math function's ``value`` at a host scalar ``x``: a float, or a
    ``numpy.float32`` where ``x`` is one (the f64 result rounded once)."""
    return np.float32(value) if isinstance(x, np.float32) else value


def sqrt(x):
    if isinstance(x, Sym):
        return _call("sqrtf", x)
    if isinstance(x, torch.Tensor):
        return torch.sqrt(x)
    return _host(x, math.sqrt(x))


def sin(x):
    if isinstance(x, Sym):
        return _call("sinf", x)
    if isinstance(x, torch.Tensor):
        return torch.sin(x)
    return _host(x, math.sin(x))


def cos(x):
    if isinstance(x, Sym):
        return _call("cosf", x)
    if isinstance(x, torch.Tensor):
        return torch.cos(x)
    return _host(x, math.cos(x))


def abs(x):
    """``|x|`` (``jnp.abs``)."""
    if isinstance(x, Sym):
        return _call("fabsf", x)
    if isinstance(x, torch.Tensor):
        return torch.abs(x)
    return _host(x, math.fabs(x))


def exp(x):
    if isinstance(x, Sym):
        return _call("expf", x)
    if isinstance(x, torch.Tensor):
        return torch.exp(x)
    return _host(x, math.exp(x))


def maximum(a, b):
    """NaN-propagating elementwise max (``jnp.maximum``)."""
    if _sym_of(a, b) is not None:
        return _call("ppi_max", a, b)
    ta, tb = isinstance(a, torch.Tensor), isinstance(b, torch.Tensor)
    if ta and tb:
        return torch.maximum(a, b)
    if ta or tb:
        # a Python constant stays a kernel argument, not a host-to-device copy
        return torch.clamp(a, min=b) if ta else torch.clamp(b, min=a)
    return max(a, b)


def minimum(a, b):
    """NaN-propagating elementwise min (``jnp.minimum``)."""
    if _sym_of(a, b) is not None:
        return _call("ppi_min", a, b)
    ta, tb = isinstance(a, torch.Tensor), isinstance(b, torch.Tensor)
    if ta and tb:
        return torch.minimum(a, b)
    if ta or tb:
        return torch.clamp(a, max=b) if ta else torch.clamp(b, max=a)
    return min(a, b)


def clip(x, lo, hi):
    """``jnp.clip``: ``minimum(maximum(x, lo), hi)``."""
    return minimum(maximum(x, lo), hi)


def gt(a, b):
    """``a > b`` as a 0/1 float."""
    if _sym_of(a, b) is not None:
        return _call("ppi_gt", a, b)
    t = _tensor_of(a, b)
    if t is not None:
        return (a > b).to(t.dtype)
    return float(a > b)


def lt(a, b):
    """``a < b`` as a 0/1 float."""
    return gt(b, a)


def logical_and(a, b):
    """``a & b`` of two 0/1 floats (from ``gt``/``lt``), as their product:
    JAX's ``w * ((x > c) & (y < d))`` is the same number."""
    return a * b


def where(cond, a, b):
    """``cond ? a : b`` with ``cond`` a 0/1 float (from ``gt``)."""
    if _sym_of(cond, a, b) is not None:
        return _call("ppi_where", cond, a, b)
    if isinstance(cond, torch.Tensor):
        return torch.where(cond != 0, a, b)
    return a if cond else b


def sigmoid(x):
    if isinstance(x, Sym):
        return _call("ppi_sigmoid", x)
    if isinstance(x, torch.Tensor):
        return torch.sigmoid(x)
    return _host(x, 1.0 / (1.0 + math.exp(-x)))


def isfinite(x):
    """Finiteness as a 0/1 float."""
    if isinstance(x, Sym):
        return _call("ppi_isfinite", x)
    if isinstance(x, torch.Tensor):
        return torch.isfinite(x).to(x.dtype)
    return float(math.isfinite(x))


def zeros_like(x):
    if isinstance(x, Sym):
        return x.em.emit(f32_literal(0.0))
    if isinstance(x, torch.Tensor):
        return torch.zeros_like(x)
    return 0.0


# The C definitions behind the helper calls above; ``sqrtf``, ``sinf``,
# ``cosf``, ``fabsf`` and ``expf`` are the C library's (``math.h``, CUDA's
# device functions). ``ppi_max``/``ppi_min`` propagate NaN like XLA's
# max/min (CUDA's fmaxf does not). ``x - x == 0`` is false exactly for inf
# and NaN, without fast-math.
C_HELPERS = """\
PPI_QUAL float ppi_max(float a, float b) {
  return (a != a || b != b) ? a + b : (a > b ? a : b);
}
PPI_QUAL float ppi_min(float a, float b) {
  return (a != a || b != b) ? a + b : (a < b ? a : b);
}
PPI_QUAL float ppi_gt(float a, float b) { return a > b ? 1.0f : 0.0f; }
PPI_QUAL float ppi_where(float c, float a, float b) {
  return c != 0.0f ? a : b;
}
PPI_QUAL float ppi_sigmoid(float x) { return 1.0f / (1.0f + expf(-x)); }
PPI_QUAL float ppi_isfinite(float x) { return (x - x == 0.0f) ? 1.0f : 0.0f; }
"""
