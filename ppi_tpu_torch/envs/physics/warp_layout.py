"""The warp layout of the rollout kernel: its generated stages and tables.

The lane layout (``csrc/rollout.cu``) runs one rollout per thread: the
whole substep, Gauss-Jordan solve included, is one thread's dependent
chain. The warp layout (``csrc/rollout_warp.cu``) runs one rollout per
warp and splits each substep of ``engine_soa.substep_soa`` so that most of
it runs on all 32 lanes:

  * ``env_assemble`` -- lane 0's straight-line code, as in the lane
    layout: FK and velocity kinematics down to the first depth of the
    body tree from which on every depth holds two bodies or more, the
    passive torques and each right-hand side's first operand; it stores
    what the lanes read into the rollout's shared memory;
  * ``env_stages`` -- template stages (``_Templates``), each followed by a
    ``__syncwarp``: one per remaining depth (the digits' FK and velocity
    kinematics), then the world inertias, the Jacobian columns and the
    contact points, then ``I_w jw``, the bias wrenches and the contact
    pairs' forces, then each sphere's contact force;
  * the mass matrix and the right-hand side, summed across the lanes from
    the tables below: every lane sums some entries of M (upper triangle),
    lane j the right-hand side's entry j, each entry's terms in
    ``assemble_soa``'s order;
  * the solve (hand-written in the skeleton), lane c holding column c of
    the augmented matrix: its constant head (``_solve_head``: the steps
    whose pivot Python folds, from tables) then the register loop, then
    ``env_integrate`` (``engine_soa.integrate_soa``) on lane 0.

Every value is the one the lane layout computes, bit for bit: a template
instance runs the same ``engine_soa`` helper on the same values, with
Python folding its constants as the straight-line program does; each
table entry is summed by one lane in the program's order, and where the
program folds model constants in float64 (a term whose operands are all
Python floats, an entry that stays an exact 0.0, a constant diagonal of a
slide joint, the solve's steps while its pivot is a constant) the tables
carry the folded value as the straight-line code's f32 literal would.
``generate_stages`` raises where the program folds only part of a term,
which the tables cannot express.
"""

import dataclasses
import functools
import itertools
import re

from ppi_tpu_torch.envs.physics import scalar_math as sm
from ppi_tpu_torch.envs.physics.engine import HINGE
from ppi_tpu_torch.envs.physics.engine_soa import (
    Assembly, accumulate_force, bias_wrench_soa, contact_point_soa,
    contact_terms, fk_body_soa, gauss_jordan_step, integrate_soa,
    jacobian_column, m3_vec, passive_torque_soa, plane_contact_soa,
    segment_contact_soa, sphere_contact_soa, v3_dot, velocity_body_soa,
    world_inertia_soa)

LANES = 32
# flags of a mass-matrix op (PpiMassOp in csrc/rollout_warp.cu)
START, END, CONST, JW = 1, 2, 4, 8
# kinds of an op of the solve's constant head (PpiHeadOp)
HEAD_SYM, HEAD_LIT, HEAD_CONST = 0, 1, 2
_SHORT = 32767


def _const(x) -> bool:
    return not isinstance(x, sm.Sym)


def _dot_folds(a, b, what: str) -> bool:
    """True when Python folds ``v3_dot(a, b)`` whole (every operand a
    constant); False when it emits every product. A dot that folds some
    products and emits others has no table form."""
    both = [_const(x) and _const(y) for x, y in zip(a, b)]
    if any(both) and not all(both):
        raise NotImplementedError(f"the warp layout cannot sum {what}: "
                                  "Python folds only some of its products")
    return all(both)


class _Slots:
    """Float offsets in the rollout's shared memory of the values that
    lane 0 hands to the other lanes. A Sym is stored by ``env_assemble``
    right after its definition; a constant is stored once when the
    rollout starts (``const``: (offset, value))."""

    def __init__(self, base: int):
        self.base = base
        self.size = 0
        self._index = {}
        self._where = {}   # value -> the first offset that holds it
        self.stores = {}   # Sym name -> offsets to store it at
        self.const = []

    def _key(self, x):
        return x.name if isinstance(x, sm.Sym) else ("c", float(x).hex())

    def _put(self, x, off):
        self._where.setdefault(self._key(x), off)
        if isinstance(x, sm.Sym):
            self.stores.setdefault(x.name, []).append(off)
        else:
            self.const.append((off, float(x)))

    def known(self, x, off: int):
        """``x`` is already at ``off`` (the rollout's q, qd, tau)."""
        self._where[self._key(x)] = off

    def scalar(self, x) -> int:
        """An offset that holds ``x`` (a slot of a vector if one does)."""
        key = self._key(x)
        if key not in self._where:
            self._put(x, self.base + self.size)
            self.size += 1
        return self._where[key]

    def vec(self, v) -> int:
        """The offset of a 3-vector's three consecutive floats."""
        key = ("v",) + tuple(self._key(x) for x in v)
        if key not in self._index:
            off = self.base + self.size
            self.size += 3
            self._index[key] = off
            for i, x in enumerate(v):
                self._put(x, off + i)
        return self._index[key]


_PLACEHOLDERS = sm.Emitter()   # names the values the template stages make


class _Templates:
    """Per-instance computations of one stage spread over the lanes.

    An instance is one call of an ``engine_soa`` function (a body's world
    inertia, a Jacobian column, ...) traced over symbols: each of its
    inputs that is a symbol becomes a load from the rollout's shared
    memory, each f32 literal it emits a load from the instance's row of a
    constant table, and Python folds its constant operands exactly as the
    straight-line program does. Instances that emit the same code (with
    the literals taken out) share one generated function; the lanes run
    each function's instances in turn, lane i the instances i, i + 32, ...
    Each result that is a symbol becomes a placeholder symbol for the
    tables downstream; a result that Python folded stays a float."""

    def __init__(self, stage: int, names):
        self.stage = stage
        self.names = names   # an iterator of placeholder numbers
        self.groups = {}   # code key -> [(inputs, consts, outputs)]

    def call(self, fn, *args):
        """``fn(*args)`` for one instance; returns its results with every
        emitted value replaced by a placeholder (same nesting)."""
        em = sm.Emitter()
        inputs = []

        def bind(x):
            if isinstance(x, tuple):
                return tuple(bind(v) for v in x)
            if isinstance(x, sm.Sym):
                inputs.append(x)
                k = len(inputs) - 1
                return em.input(f"in{k}", f"sh[in[{k}]]")
            return x
        result = fn(*[bind(a) for a in args])
        consts, lines = [], []
        for line in em.lines:
            def lit(match):
                consts.append(float.fromhex(match.group(0).strip("()")
                                            .rstrip("f")))
                return f"kc[{len(consts) - 1}]"
            lines.append(re.sub(sm._LITERAL.pattern, lit, line)
                         if " = sh[in[" not in line else line)
        outputs, shape = [], []

        def unbind(x):
            if isinstance(x, tuple):
                return tuple(unbind(v) for v in x)
            if isinstance(x, sm.Sym):
                if x.name.startswith("in"):   # an input passed through
                    shape.append(("in", int(x.name[2:])))
                    return inputs[int(x.name[2:])]
                ph = sm.Sym(_PLACEHOLDERS, f"w{next(self.names)}")
                outputs.append((x.name, ph))
                shape.append(("out", x.name))
                return ph
            shape.append(("c",))
            return x
        result = unbind(result)
        key = (tuple(lines), tuple(shape), len(inputs))
        self.groups.setdefault(key, []).append((inputs, consts, outputs))
        return result

    def emit(self, slots, name: str):
        """(tables, C functions) of the stage: a function per group of
        instances that share their code, and ``name(sh, lane)`` running
        them all."""
        tables, functions, calls = [], [], []
        f = sm.f32_literal
        groups = [(key, inst) for key, inst in self.groups.items()
                  if inst[0][2]]   # Python folded the others whole
        for g, (key, instances) in enumerate(groups):
            lines, _, n_in = key
            outputs = instances[0][2]
            n_k, n_out = len(instances[0][1]), len(outputs)
            body = "\n".join(list(lines) + [
                f"  sh[out[{i}]] = {t};" for i, (t, _) in enumerate(outputs)])
            fn = f"ppi_s{self.stage}_g{g}"
            functions.append(
                f"PPI_QUAL void {fn}(float* sh, const short* in, "
                f"const float* kc, const short* out) {{\n{body}\n}}\n")
            ins = [_short(slots.scalar(x)) for inst in instances
                   for x in inst[0]]
            outs = []
            for inst in instances:
                for _, ph in inst[2]:
                    where = slots.stores.get(ph.name, [])
                    if len(where) != 1:
                        raise AssertionError(f"{ph.name}: stored at {where}")
                    outs.append(_short(where[0]))
            ks = [f(v) for inst in instances for v in inst[1]]
            for ctype, suffix, row in (("short", "in", ins),
                                       ("float", "k", ks),
                                       ("short", "out", outs)):
                tables.append(f"PPI_TABLE {ctype} {fn}_{suffix}[] = "
                              f"{{{', '.join(map(str, row)) or '0'}}};\n")
            calls.append(
                f"  for (int i = lane; i < {len(instances)}; i += PPI_LANES)\n"
                f"    {fn}(sh, {fn}_in + i * {n_in}, {fn}_k + i * {n_k}, "
                f"{fn}_out + i * {n_out});")
        functions.append(f"PPI_QUAL void {name}(float* sh, int lane) {{\n"
                         + "\n".join(calls) + "\n}\n")
        return tables, functions


@dataclasses.dataclass
class _MassOp:
    init: float = 0.0
    m: float = 0.0
    c: float = 0.0
    a: int = 0
    b: int = 0
    w: int = 0
    e: int = 0
    dst: int = 0
    dst_t: int = 0
    md: int = -1
    flags: int = 0


def _mass_entries(m, asm, slots):
    """Per entry (k, l) of the upper triangle, in ``assemble_soa``'s
    order: (constant value, None) for an entry that stays a Python float,
    else (its f32 initial value, [_MassOp]): the float64 fold of the
    constant terms ahead of its first emitted one, then one op a term."""
    terms = {}
    for b in range(m.nq):
        anc = sorted(m.ancestors[b])
        for ii, k in enumerate(anc):
            for l in anc[ii:]:
                terms.setdefault((k, l), []).append(b)
    out = {}
    for (k, l), bodies in terms.items():
        acc, ops = 0.0, None
        for b in bodies:
            jk, jl = asm.jv[b][k], asm.jv[b][l]
            op = _MassOp(m=m.mass[b], a=slots.vec(jk), b=slots.vec(jl))
            if _dot_folds(jk, jl, f"M[{k}][{l}]'s term of body {b}"):
                op.c = m.mass[b] * v3_dot(jk, jl)
                op.flags |= CONST
            if asm.jw[b][k] is not None and l in asm.iw_jw[b]:
                w, e = asm.jw[b][k], asm.iw_jw[b][l]
                if _dot_folds(w, e, f"M[{k}][{l}]'s rotational term"):
                    raise NotImplementedError(
                        f"M[{k}][{l}]: a constant rotational term")
                op.w, op.e = slots.vec(w), slots.vec(e)
                op.flags |= JW
            if op.flags == CONST and ops is None:
                acc = acc + op.c   # folded in float64, as the program does
                continue
            if ops is None:
                ops = []
                op.init = acc
            ops.append(op)
        if k == l:
            if ops is None:
                acc = acc + m.armature[k]
            else:
                ops.append(_MassOp(c=m.armature[k], flags=CONST))
        if ops is None:
            out[(k, l)] = (acc, None)
        else:
            ops[0].flags |= START
            ops[-1].flags |= END
            out[(k, l)] = (ops[0].init, ops)
    return out


def _schedule(entries, lanes: int = LANES):
    """Each lane's ops, the entries spread so that the longest lane is as
    short as it can be made greedily (longest entries first, each to the
    lane with the fewest ops so far)."""
    per_lane = [[] for _ in range(lanes)]
    for ops in sorted(entries, key=len, reverse=True):
        min(per_lane, key=len).extend(ops)
    steps = max(len(x) for x in per_lane)
    table = []
    for s in range(steps):
        for lane in range(lanes):
            table.append(per_lane[lane][s] if s < len(per_lane[lane])
                         else _MassOp())
    return table, steps


def _solve_head(entries, nq: int):
    """The solve's constant head: (k0, row table, op table), k0 the first
    step whose pivot is symbolic. In the steps before it the lane program
    (``solve_pd_scalar`` on the entries) folds: ``1.0 / pivot`` in float64,
    a row entry or a product whose operands are all Python floats, a cell
    that stays a Python float. Lane c's column c is held to that step by
    step, each constant as its f32 literal (as ``ppi_const_cells``):

      * row entry (k, c): ``col[k] * v`` with v the literal of ``1.0 /
        pivot`` (HEAD_SYM), or v itself, the folded ``aug[k][c] / pivot``
        (HEAD_CONST);
      * cell (i, c), i != k: ``col[i] - f * r`` with f broadcast from lane
        k (HEAD_SYM), ``col[i] - v`` with v the folded product (HEAD_LIT),
        or v, the folded cell (HEAD_CONST).

    From step k0 on no cell is a Python float (its pivot is symbolic, so
    is its row, so every product), and the skeleton's register loop
    computes what the program emits. Tables row-major over (k, c) and
    (k, i, c), c over the nq + 1 columns; row i == k of the ops unused."""
    width = nq + 1
    marker = sm.Emitter()   # the symbolic cells: only their kind matters
    aug = [[None] * width for _ in range(nq)]
    for k in range(nq):
        for l in range(k, nq):
            value, ops = entries.get((k, l), (0.0, None))
            aug[k][l] = aug[l][k] = (value if ops is None
                                     else sm.Sym(marker, "m"))
        aug[k][nq] = sm.Sym(marker, "rhs")
    rows, ops = [], []
    k = 0
    while k < nq and _const(aug[k][k]):
        inv_p = 1.0 / aug[k][k]
        row_k = [v * inv_p for v in aug[k]]
        rows += [(HEAD_CONST, r) if _const(r) else (HEAD_SYM, inv_p)
                 for r in row_k]
        for i in range(nq):
            f = aug[i][k]
            for c in range(width):
                if i == k or not (_const(f) and _const(row_k[c])):
                    ops.append((HEAD_SYM, 0.0))
                elif _const(aug[i][c]):
                    ops.append((HEAD_CONST, aug[i][c] - f * row_k[c]))
                else:
                    ops.append((HEAD_LIT, f * row_k[c]))
        gauss_jordan_step(aug, k)
        k += 1
    return k, rows, ops


def _rhs_tables(m, asm, slots):
    """(per joint, body ops, contact ops) of the right-hand side: lane j
    sums entry j, its body terms then its contact terms."""
    joints, body_ops, contact_ops = [], [], []
    for j in range(m.nq):
        if _const(asm.rhs[j]):
            raise NotImplementedError(f"rhs[{j}] starts from a constant")
        hinge = m.joint_types[j] == HINGE
        b0, c0 = len(body_ops), len(contact_ops)
        for b in range(m.nq):
            if j not in m.ancestors[b]:
                continue
            if _dot_folds(asm.jv[b][j], asm.f_bias[b], f"rhs[{j}], body {b}"):
                raise NotImplementedError(f"rhs[{j}]: a constant body term")
            op = [slots.vec(asm.jv[b][j]), slots.vec(asm.f_bias[b]), 0, 0, 0]
            if asm.jw[b][j] is not None:
                if _dot_folds(asm.jw[b][j], asm.n_bias[b],
                              f"rhs[{j}], body {b}'s torque"):
                    raise NotImplementedError(
                        f"rhs[{j}]: a constant torque term")
                op[2:] = [slots.vec(asm.jw[b][j]), slots.vec(asm.n_bias[b]),
                          1]
            body_ops.append(op)
        for s, sb in enumerate(asm.pt_body):
            if j not in m.ancestors[sb]:
                continue
            if hinge:
                if any(_const(p) and _const(o)
                       for p, o in zip(asm.pts[s], asm.poss[j])):
                    raise NotImplementedError(
                        f"rhs[{j}]: a constant lever of contact {s}")
            elif _dot_folds(asm.axes[j], asm.forces[s],
                            f"rhs[{j}], contact {s}"):
                raise NotImplementedError(
                    f"rhs[{j}]: a constant contact term")
            contact_ops.append([slots.vec(asm.pts[s]),
                                slots.vec(asm.forces[s])])
        joints.append([slots.scalar(asm.rhs[j]), slots.vec(asm.axes[j]),
                       slots.vec(asm.poss[j]), int(hinge), b0,
                       len(body_ops) - b0, c0, len(contact_ops) - c0])
    return joints, body_ops, contact_ops


def _with_stores(em, stores):
    """``em``'s lines with each Sym's shared-memory stores right after the
    line that defines it (short live ranges for lane 0's registers)."""
    out = []
    for line in em.lines:
        out.append(line)
        hit = re.match(r"  const float (\w+) = ", line)
        if hit:
            out += [f"  sh[{off}] = {hit.group(1)};"
                    for off in stores.get(hit.group(1), ())]
    return out


def _table(ctype: str, name: str, rows, fmt) -> str:
    """A C table; an empty one gets a dummy row (C has no empty arrays)."""
    body = ",\n".join(f"  {{{fmt(r)}}}" for r in rows) or "  {0}"
    return f"PPI_TABLE {ctype} {name}[] = {{\n{body}\n}};\n"


def _short(x: int) -> int:
    if not -_SHORT <= x <= _SHORT:
        raise ValueError(f"offset {x} does not fit the tables' shorts")
    return x


def _first_staged_depth(width) -> int:
    """The first depth of the body tree (``width``: bodies a depth) whose
    kinematics run as template stages, every deeper depth too: the first
    from which on every depth holds two bodies or more (the digits). Where
    that leaves every depth on lane 0 (the deepest holds one body: a pen's
    hinges under its slides), the split that costs least, counting a body
    on lane 0 as one and a stage as two (its loads and ``__syncwarp``
    cost about one body's kinematics), the deepest of equals."""
    wide = len(width)
    while wide > 0 and width[wide - 1] >= 2:
        wide -= 1
    if wide < len(width):
        return wide
    cost = [sum(width[:p]) + sum(1 + -(-w // LANES) for w in width[p:])
            for p in range(len(width) + 1)]
    return max(p for p, c in enumerate(cost) if c == min(cost))


def _kinematics(m, q, qd, slots, names):
    """Every body's FK and velocity kinematics (``fk_body_soa``,
    ``velocity_body_soa``): on lane 0 down to ``_first_staged_depth``,
    each deeper depth a template stage, its bodies across the lanes.
    Returns (rots, poss, axes, coms, omega, v_o, alpha, a_c) and the
    stages."""
    nq = m.nq
    depth = []
    for b in range(nq):
        depth.append(0 if m.parents[b] < 0 else depth[m.parents[b]] + 1)
    wide = _first_staged_depth([depth.count(d)
                                for d in range(max(depth) + 1)])
    zero = (0.0, 0.0, 0.0)
    rots, poss, axes, coms, omega, v_o, alpha, a_o, a_c = (
        [None] * nq for _ in range(9))
    stages = {}

    def body(b, r_p, p_p, offset, q_b, qd_b, w_p, vo_p, al_p, ao_p):
        r_b, p_b, a_w, com = fk_body_soa(m, b, r_p, p_p, offset, q_b)
        return (r_b, p_b, a_w, com) + velocity_body_soa(
            m, b, qd_b, w_p, vo_p, al_p, ao_p, p_p, p_b, a_w, com)

    for b in range(nq):
        p = m.parents[b]
        args = ((m.identity3, zero, m.offset_pos[b], q[b], qd[b], zero, zero,
                 zero, zero) if p < 0 else
                (rots[p], poss[p], m.offset_pos[b], q[b], qd[b], omega[p],
                 v_o[p], alpha[p], a_o[p]))
        if depth[b] < wide:
            res = body(b, *args)
        else:
            stage = stages.setdefault(depth[b], _Templates(
                f"k{depth[b]}", names))
            res = stage.call(functools.partial(body, b), *args)
            for x in res:
                if len(x) == 3:
                    slots.vec(x)
                else:
                    for y in x:
                        slots.scalar(y)
        (rots[b], poss[b], axes[b], coms[b], omega[b], v_o[b], _, alpha[b],
         a_o[b], a_c[b]) = res
    return (rots, poss, axes, coms, omega, v_o, alpha, a_c), [
        stages[d] for d in sorted(stages)]


def _lane0_and_stages(m, q, qd, tau, slots):
    """Lane 0's part of ``assemble_soa`` (FK and velocity kinematics down
    to the digits, the passive torques: it emits them) and the template
    stages that compute the rest across the lanes: one per depth of the
    digits (FK and velocity kinematics); the world inertias, the Jacobian
    columns and the contact points; then ``I_w jw``, the bias wrenches and
    each contact pair's force; then each sphere's contact force, its pairs'
    terms summed in ``contact_forces_soa``'s order. Returns an
    ``Assembly`` (without the entries) whose values made by the stages are
    placeholders, and the stages in order."""
    nq = m.nq
    names = itertools.count()
    (rots, poss, axes, coms, omega, v_o, alpha, a_c), levels = _kinematics(
        m, q, qd, slots, names)
    passive = passive_torque_soa(m, q, qd)
    rhs0 = tuple(tau[j] + passive[j] for j in range(nq))

    first, second, third = (_Templates(i, names) for i in (1, 2, 3))
    pts, vels, pt_body = [], [], []
    for s, sb in enumerate(m.sphere_body):
        p, v = first.call(functools.partial(contact_point_soa, m, s),
                          rots[sb], poss[sb], v_o[sb], omega[sb])
        slots.vec(p)
        slots.vec(v)
        pts.append(p)
        vels.append(v)
        pt_body.append(sb)
    i_world = []
    for b in range(nq):
        i_w = first.call(functools.partial(world_inertia_soa, m, b), rots[b])
        for x in i_w:
            slots.scalar(x)
        i_world.append(i_w)
    jv = [[None] * nq for _ in range(nq)]
    jw = [[None] * nq for _ in range(nq)]
    for b in range(nq):
        for j in sorted(m.ancestors[b]):
            if m.joint_types[j] == HINGE:
                jv[b][j] = first.call(
                    lambda a, o, c, j=j: jacobian_column(m, j, a, o, c)[0],
                    axes[j], poss[j], coms[b])
                slots.vec(jv[b][j])
                jw[b][j] = axes[j]
            else:   # the axis itself, no operation
                jv[b][j], jw[b][j] = jacobian_column(m, j, axes[j], poss[j],
                                                     coms[b])
    iw_jw, f_bias, n_bias = [], [], []
    for b in range(nq):
        iw_jw.append({j: second.call(m3_vec, i_world[b], jw[b][j])
                      for j in sorted(m.ancestors[b])
                      if jw[b][j] is not None})
        for v in iw_jw[b].values():
            slots.vec(v)
        f, n = second.call(functools.partial(bias_wrench_soa, m, b),
                           i_world[b], omega[b], alpha[b], a_c[b])
        slots.vec(f)
        slots.vec(n)
        f_bias.append(f)
        n_bias.append(n)
    pairs = {"plane": [], "sphere": [], "segment": []}
    for si, pi in m.pair_sphere_plane:
        pairs["plane"].append((second.call(functools.partial(
            plane_contact_soa, m, si, pi), pts[si], vels[si]), None))
    for ai, bi in m.pair_sphere_sphere:
        pairs["sphere"].append((second.call(functools.partial(
            sphere_contact_soa, m, ai, bi), pts[ai], pts[bi], vels[ai],
            vels[bi]), None))
    for si, ea, eb in m.pair_sphere_segment:
        pairs["segment"].append(second.call(functools.partial(
            segment_contact_soa, m, si, ea, eb), pts[ea], pts[eb], pts[si],
            vels[ea], vels[eb], vels[si]))
    for kind in pairs.values():
        for f, t in kind:
            slots.vec(f)
            if t is not None:
                slots.scalar(t)
    forces = []
    for terms in contact_terms(m):
        force = (0.0, 0.0, 0.0)
        if terms:
            kinds = [k for k, _, _ in terms]
            force = third.call(
                lambda *ft, kinds=kinds: functools.reduce(
                    lambda acc, i: accumulate_force(acc, kinds[i], *ft[i]),
                    range(len(kinds)), (0.0, 0.0, 0.0)),
                *[pairs[pk][i] if pk == "segment" else pairs[pk][i][:1]
                  for _, pk, i in terms])
            slots.vec(force)
        forces.append(force)
    asm = Assembly(None, rhs0, None, poss, axes, jv, jw, iw_jw, f_bias,
                   n_bias, pts, pt_body, forces)
    return asm, levels + [first, second, third]


def generate_stages(m, prologue, h: float, action_dim: int,
                    project: bool):
    """(defines, tables, functions) of the warp header for the
    ``SoaModel`` ``m``: ``prologue(em, with_tau=True)`` binds the inputs
    as the lane generator's does. Shared memory of one rollout, in
    floats: q, qd, tau, the action, q_prev (with a projection), the mass
    diagonal, the augmented matrix (row stride nq + 1), the slots."""
    nq = m.nq
    if nq + 1 > LANES:
        raise ValueError(f"the warp layout takes nq + 1 <= {LANES} "
                         f"columns, not {nq + 1}")
    width = nq + 1
    off = {"Q": 0, "QD": nq, "TAU": 2 * nq, "ACT": 3 * nq}
    off["QPREV"] = off["ACT"] + action_dim
    off["MDIAG"] = off["QPREV"] + (nq if project else 0)
    off["AUG"] = off["MDIAG"] + nq
    slots = _Slots(off["AUG"] + nq * width)

    em = sm.Emitter()
    mm, q, qd, tau = prologue(em, with_tau=True)
    for j in range(nq):
        for x, at in ((q[j], "Q"), (qd[j], "QD"), (tau[j], "TAU")):
            slots.known(x, off[at] + j)
    asm, stages = _lane0_and_stages(mm, q, qd, tau, slots)
    entries = _mass_entries(mm, asm, slots)
    solve_from, head_rows, head_ops = _solve_head(entries, nq)
    const_cells, sym_ops, mdiag = [], [], [None] * nq
    for k in range(nq):
        for l in range(k, nq):
            value, ops = entries.get((k, l), (0.0, None))
            if ops is None:
                const_cells += [(k * width + l, value)] + (
                    [(l * width + k, value)] if l != k else [])
                if k == l:
                    mdiag[k] = value
                continue
            ops[-1].dst, ops[-1].dst_t = k * width + l, l * width + k
            if k == l:
                ops[-1].md = k
            sym_ops.append(ops)
    mass_table, mass_steps = _schedule(sym_ops)
    joints, body_ops, contact_ops = _rhs_tables(mm, asm, slots)
    stage_tables, stage_functions = [], []
    calls = []
    for i, stage in enumerate(stages, 1):
        t, fns = stage.emit(slots, f"env_stage_{i}")
        stage_tables += t
        stage_functions += fns
        calls.append(f"  PPI_EACH_LANE(l) env_stage_{i}(sh, l);\n"
                     "  PPI_SYNC();")
    stage_functions.append("PPI_QUAL void env_stages(float* sh) {\n"
                           + "\n".join(calls) + "\n}\n")
    size = slots.base + slots.size
    for x in (size, len(body_ops), len(contact_ops)):
        _short(x)

    em.lines = _with_stores(em, slots.stores)
    assemble = sm.c_function(
        "void env_assemble(const float* q, const float* qd, "
        "const float* tau, const float* dyn, float* sh)", em, [])

    em = sm.Emitter()
    q = tuple(em.input(f"q_{j}", f"q[{j}]") for j in range(nq))
    qd = tuple(em.input(f"qd_{j}", f"qd[{j}]") for j in range(nq))
    qdd = tuple(em.input(f"qdd_{j}", f"sh[{off['AUG'] + j * width + nq}]")
                for j in range(nq))
    md = tuple(em.input(f"md_{j}", f"sh[{off['MDIAG'] + j}]")
               if mdiag[j] is None and mm.friction_loss[j] > 0.0
               else mdiag[j] for j in range(nq))
    q2, qd2 = integrate_soa(mm, q, qd, qdd, md, h)
    integrate = sm.c_function(
        "void env_integrate(float* q, float* qd, const float* sh)", em,
        [(f"q[{j}]", q2[j]) for j in range(nq)]
        + [(f"qd[{j}]", qd2[j]) for j in range(nq)])

    f = sm.f32_literal
    tables = [
        _table("PpiConstSlot", "ppi_const_slots", slots.const,
               lambda r: f"{r[0]}, {f(r[1])}"),
        _table("PpiConstSlot", "ppi_const_cells", const_cells,
               lambda r: f"{r[0]}, {f(r[1])}"),
        _table("PpiMassOp", "ppi_mass_ops", mass_table,
               lambda o: f"{f(o.init)}, {f(o.m)}, {f(o.c)}, {o.a}, {o.b}, "
                         f"{o.w}, {o.e}, {o.dst}, {o.dst_t}, {o.md}, "
                         f"{o.flags}"),
        _table("PpiRhsJoint", "ppi_rhs_joint", joints,
               lambda r: ", ".join(map(str, r))),
        _table("PpiRhsBody", "ppi_rhs_body", body_ops,
               lambda r: ", ".join(map(str, r))),
        _table("PpiRhsContact", "ppi_rhs_contact", contact_ops,
               lambda r: ", ".join(map(str, r))),
    ]
    defines = [f"#define PPI_SH_{k} {v}" for k, v in off.items()] + [
        f"#define PPI_SH_SIZE {size}",
        f"#define PPI_N_CONST_SLOTS {len(slots.const)}",
        f"#define PPI_N_CONST_CELLS {len(const_cells)}",
        f"#define PPI_MASS_STEPS {mass_steps}"]
    if solve_from:   # a body whose first pivot is symbolic has no head
        defines.append(f"#define PPI_SOLVE_FROM {solve_from}")
        tables += [_table("PpiHeadOp", name, rows,
                          lambda r: f"{f(r[1])}, {r[0]}")
                   for name, rows in (("ppi_head_rows", head_rows),
                                      ("ppi_head_ops", head_ops))]
    return defines, tables + stage_tables, [assemble, *stage_functions,
                                            integrate]
