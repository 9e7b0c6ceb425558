"""The split layout of the rollout kernel: one rollout's program over warps.

The lane layout (``csrc/rollout.cu``) runs a whole rollout on one thread,
so one warp scheduler issues its straight-line substep alone: a few
thousand f32 operations whose dependences are shallow (door-v0's longest
chain is 89 of its 4,199) while the SM's other three schedulers sit idle.
The split layout (``csrc/rollout_split.cu``) spreads each rollout's
program over K <= 4 warps of one block, one *stream* a warp, while every
warp still carries 32 rollouts in lock step as the lane layout does.

This module takes the lane layout's own emitted program (the ``Emitter``
lines of ``env_substep`` and ``env_reward``, every value with its
expression) and list-schedules its DAG into K streams and P *phases*
separated by a barrier of the block:

  * every live op runs on exactly one stream (a literal line, which costs
    nothing, is repeated wherever it is used);
  * a value that another stream reads is stored by its producer to shared
    memory at ``sh[slot * 32 + lane]`` and loaded by the consumer in a
    later phase, after the barrier; a slot is reused only in a phase after
    its last load;
  * q and qd live in slots of their own across substeps and steps; the
    torque runs on every stream (tau and the action stay in each warp's
    registers); the reward, when it is split, ends on stream 0, which
    holds the step's NaN latch;
  * a value a stream uses again in a later phase is carried in ``reg[i]``
    (a local array the compiler keeps in registers), indices reused by
    liveness.

The model: the cost of a schedule is, over its phases, the largest
stream's ops (``WEIGHTS``, in issue slots) plus ``EXCHANGE`` for every
shared-memory load and store of all the streams (the SM's shared-memory
pipe serves every warp) plus ``BARRIER`` a barrier. ``plan_body`` tries
every K from 2 to ``MAX_STREAMS`` and keeps the cheapest; ``streams``
forces K for a study. The constants were fitted to H100 runs of variants
of this generator (PERF.md section 6): exchanges and phases, not the ops,
decide whether a split pays. The search takes seconds in Python, so
``cached_body`` keeps its result on disk under a hash of the program.

The subtree partition (``plan_partition``), for a body whose env opts in
(``scalar_split_partition = "subtree"``: relocate-v0, cheetah,
walker2d, walker~walk, humanoid-standup, pen-v0-hand; a tree that is one
chain has nothing to partition in this mode and is refused), places
the substep by the model's body tree instead: the scalar program records
what each line computes for while it emits (``scalar_math.owner``: a
body, a contact sphere or pair, a sum of the mass matrix or right-hand
side), each tree's root chain and each subtree hanging off it gets a
warp (``subtree_groups``), a body's kinematics, Jacobian columns and mass
and force terms and its contacts run on its warp, and only what feeds
another warp crosses: the frames at a subtree's root (or a copy computed
again where that is cheaper, ``_replicate``), the terms of the sums that
gather several warps and the accelerations. The mass matrix is
ancestor-sparse (``engine_soa.assemble_soa``), so a subtree's own entries
stay on its warp; an entry whose terms come from several warps keeps the
lane program's chain on the solve's warp, its terms sent, never regrouped
into partial sums. Phases follow from the dependences that cross warps
(``_phases``); the search over the solve's warp and the replication keeps
the plan the model prices lowest.

The chain cut (``plan_partition``'s "chain" mode, for an env with
``scalar_split_partition = "chain"``: fetch-push, hopper, pen-v0,
reacher) serves a tree whose work sits on one chain of bodies, which the
subtree partition keeps on one warp (fetch-push's arm, pen-v0's pen) or
refuses (hopper's and reacher's trees are one chain each):
the heaviest group that is a chain is cut into contiguous segments over
the warps the groups leave free (``chain_cuts``), each segment a warp, the
frames at a segment's top copied or sent from the warp above as a
subtree's are; the search runs over every cut too, and skips a choice
whose lower bound cannot beat the best plan found so far.

Each stream's share of a phase is one generated function; the device runs
stream w on warp w inside a warp-uniform ``if``/``else`` chain with
``PPI_BARRIER`` between phases, and the host-C build runs the phases in
order and each phase's streams in order (``ppi_sub_fns``,
``ppi_rew_fns``). Every value is computed by the expression the lane
layout computes it with, on the same operands, so with ``-fmad=false``
the split kernel gives the lane kernel's bits.
"""

import dataclasses
import hashlib
import heapq
import itertools
import json
import os
import re
import threading
from pathlib import Path

from ppi_tpu_torch.envs.physics import scalar_math as sm

LANES = 32
MAX_STREAMS = 4   # an SM's warp schedulers
SHARED_BYTES = 232448   # the shared memory one block may use (227 KB)
# issue slots of one emitted op (an IEEE division, square root, sine or
# cosine expands to a short routine)
WEIGHTS = {"+": 1, "-": 1, "*": 1, "neg": 1, "/": 8, "sqrtf": 8,
           "sinf": 24, "cosf": 24, "expf": 10, "fabsf": 1, "ppi_max": 4,
           "ppi_min": 4, "ppi_gt": 2, "ppi_where": 2, "ppi_isfinite": 3,
           "ppi_sigmoid": 14}
EXCHANGE = 0.65   # a shared-memory load or store, in issue slots
BARRIER = 100   # a barrier of the block, in issue slots
CAP = 32   # the most a tree of single-reader ops weighs (``_trees``)

_LINE = re.compile(r"  const float (\w+) = (.*);")
_NAME = re.compile(r"\b([A-Za-z_]\w*)\b")
_CALL = re.compile(r"(\w+)\(")
_BINARY = re.compile(r" ([-+*/]) ")
_ARRAY = re.compile(r"(\w+)\[(\d+)\]")
_TEMP = re.compile(r"t\d+")


def op_weight(expr: str) -> int:
    """Issue slots of one emitted expression (0 for a bare literal)."""
    if sm._LITERAL.fullmatch(expr):
        return 0
    call = _CALL.match(expr)
    if call:
        return WEIGHTS[call.group(1)]
    if expr.startswith("-"):
        return WEIGHTS["neg"]
    return WEIGHTS[_BINARY.search(expr).group(1)]


@dataclasses.dataclass
class Program:
    """One generated function's DAG: its inputs (name -> C array and
    index, e.g. ``("q", 0)``) and the slot of each that lives in one, its
    live ops in emission order (name, expression, weight, the ops and the
    inputs each reads, whether it is a bare literal) and its outputs
    ((slot, name or literal) pairs)."""
    inputs: dict
    input_slot: dict
    names: list
    exprs: list
    weights: list
    preds: list
    reads: list
    literal: list
    outputs: list


def parse(em: sm.Emitter, outputs, in_slots) -> Program:
    """The DAG of ``em``'s lines with ``outputs``: (slot, scalar) pairs,
    each scalar a ``Sym`` of ``em`` or a constant. ``in_slots`` maps an
    input array that lives in slots (``q``, ``qd``) to its first slot; an
    output that is the input its slot already holds is dropped. Ops no
    output reaches are dropped, as the compiler drops them from the lane
    layout."""
    inputs, index, rows = {}, {}, []
    for line in em.lines:
        m = _LINE.fullmatch(line)
        if m is None:
            raise ValueError(f"not an emitted line: {line!r}")
        name, expr = m.groups()
        arr = _ARRAY.fullmatch(expr)
        if arr and not _TEMP.fullmatch(name):
            inputs[name] = (arr.group(1), int(arr.group(2)))
            continue
        index[name] = len(rows)
        rows.append((name, expr))
    input_slot = {name: in_slots[arr] + j
                  for name, (arr, j) in inputs.items() if arr in in_slots}
    outs = []
    for slot, x in outputs:
        x = x.name if isinstance(x, sm.Sym) else sm.f32_literal(x)
        if input_slot.get(x) == slot:
            continue
        if x in inputs:
            raise NotImplementedError(
                f"output {x!r} is an input held elsewhere: the split layout "
                "does not move values between slots")
        outs.append((slot, x))
    live = [False] * len(rows)
    stack = [index[x] for _, x in outs if x in index]
    while stack:
        v = stack.pop()
        if live[v]:
            continue
        live[v] = True
        stack.extend(index[t] for t in _NAME.findall(rows[v][1])
                     if t in index)
    return _program([rows[v] for v in range(len(rows)) if live[v]], inputs,
                    input_slot, outs)


def _program(rows, inputs, input_slot, outs) -> Program:
    """The ``Program`` of (name, expression) ``rows`` in an order that
    defines every name before it is read."""
    new = {name: i for i, (name, _) in enumerate(rows)}
    prog = Program(inputs, input_slot, [], [], [], [], [], [], outs)
    for name, expr in rows:
        toks = _NAME.findall(expr)
        prog.names.append(name)
        prog.exprs.append(expr)
        prog.weights.append(op_weight(expr))
        prog.literal.append(bool(sm._LITERAL.fullmatch(expr)))
        prog.preds.append(sorted({new[t] for t in toks if t in new}))
        prog.reads.append(sorted({t for t in toks if t in inputs}))
    return prog


@dataclasses.dataclass
class Schedule:
    """K streams, P phases; for each op its stream and phase (-1 for a
    literal), and each (phase, stream)'s ops in order."""
    k: int
    phases: int
    stream: list
    phase: list
    order: dict


def _bottom_levels(prog: Program):
    succ_max = [0] * len(prog.names)
    level = [0] * len(prog.names)
    for v in range(len(prog.names) - 1, -1, -1):
        level[v] = prog.weights[v] + succ_max[v]
        for u in prog.preds[v]:
            succ_max[u] = max(succ_max[u], level[v])
    return level


def _trees(prog: Program, succs, cap: float):
    """Each op's tree: an op whose value has one reader and is no output
    joins its reader's tree while the ops it gathers weigh at most
    ``cap``. A tree's ready ops go home to the stream that ran its first
    op, so few values inside a tree cross streams."""
    n = len(prog.names)
    out = {x for _, x in prog.outputs}
    weight = list(prog.weights)
    joins = [False] * n
    for v in range(n):
        if (len(succs[v]) == 1 and prog.names[v] not in out
                and weight[v] <= cap):
            joins[v] = True
            weight[succs[v][0]] += weight[v]
    tree = list(range(n))
    for v in range(n - 1, -1, -1):
        if joins[v]:
            tree[v] = tree[succs[v][0]]
    return tree


def schedule(prog: Program, k: int) -> Schedule:
    """List-schedule ``prog`` into ``k`` streams, phase by phase.

    An op is ready for a stream in a phase when its operands all come from
    earlier phases, or when its operands of this phase all come from that
    stream (only it may take it then); an op with operands of this phase
    from two streams waits for the next phase. A ready op of an earlier
    phase waits in the queue of its *home*: the stream that ran its tree
    (``_trees``), else the one that holds most of its operands (of those,
    the one sent least so far). In a phase the least-loaded stream takes,
    of its own two queues, the op whose weighted path to an output is
    longest. No stream takes an op another stream has queued, so a narrow
    stretch (the solve) stays on one stream without a barrier between its
    steps. A stream with both queues empty waits; the phase ends when
    every stream waits."""
    n = len(prog.names)
    level = _bottom_levels(prog)
    succs = [[] for _ in range(n)]
    pending = [0] * n
    preds = [[u for u in prog.preds[v] if not prog.literal[u]]
             for v in range(n)]
    for v in range(n):
        if prog.literal[v]:
            continue
        for u in preds[v]:
            succs[u].append(v)
            pending[v] += 1
    stream, phase = [-1] * n, [-1] * n
    have = [set() for _ in range(k)]   # ops whose values each stream holds
    home = [[] for _ in range(k)]
    total = [0] * k   # the ops sent home to each stream so far
    tree = _trees(prog, succs, CAP)
    owner = {}

    def go_home(v):
        if tree[v] in owner:
            heapq.heappush(home[owner[tree[v]]], (-level[v], v))
            return
        held = [sum(1 for u in preds[v] if u in have[s]) for s in range(k)]
        s = max(range(k), key=lambda x: (held[x], -total[x], -x))
        total[s] += prog.weights[v]
        heapq.heappush(home[s], (-level[v], v))

    for v in range(n):
        if not prog.literal[v] and pending[v] == 0:
            go_home(v)
    left = sum(1 for v in range(n) if not prog.literal[v])
    order, p = {}, 0
    while left:
        load = [0] * k
        waiting = [False] * k
        local = [[] for _ in range(k)]
        later = []
        while not all(waiting):
            s = min((x for x in range(k) if not waiting[x]),
                    key=lambda x: (load[x], x))
            heaps = [h for h in (local[s], home[s]) if h]
            if not heaps:
                waiting[s] = True
                continue
            v = heapq.heappop(min(heaps))[1]
            owner.setdefault(tree[v], s)
            stream[v], phase[v] = s, p
            order.setdefault((p, s), []).append(v)
            load[s] += prog.weights[v] + sum(1 for u in preds[v]
                                             if u not in have[s])
            have[s].update(preds[v])
            have[s].add(v)
            left -= 1
            for u in succs[v]:
                pending[u] -= 1
                if pending[u]:
                    continue
                here = {stream[x] for x in preds[u] if phase[x] == p}
                if len(here) == 1 and owner.get(tree[u], s) in here:
                    heapq.heappush(local[here.pop()], (-level[u], u))
                else:
                    later.append(u)
        for s in range(k):
            for _, v in local[s]:
                go_home(v)
        for u in later:
            go_home(u)
        p += 1
    return Schedule(k, max(p, 1), stream, phase, order)


@dataclasses.dataclass
class Layout:
    """Where each value lives. Per (phase, stream): the bindings at the top
    of its function (``(name, C expression)``: a slot load, a carry
    register, an input array, a literal), its stores (``(slot, name)``)
    and its carries out (``(reg, name)``); ``slots`` the slots a lane
    uses past ``base``, ``regs`` the carry registers a thread uses;
    ``cost`` the model's issue slots."""
    binds: dict
    stores: dict
    carries: dict
    slots: int
    regs: int
    cost: int


def layout(prog: Program, sched: Schedule, base: int,
           final_barrier: bool) -> Layout:
    """Bind every value ``sched``'s functions read.

    An output is stored by its value's producer (a literal's, by stream 0
    in the last phase). A stream loads a value of another stream at its
    first use, and an input that lives in a slot (q_j, qd_j) there too
    unless the output that overwrites that slot is stored in that phase or
    before, in which case it loads it in the last phase before (in the
    storing phase itself on the storing stream) and carries it. A
    cross-stream value takes the lowest slot free since before its store:
    free once the phase of its last load has passed. ``final_barrier``:
    whether the barrier after the last phase counts (the substep's; the
    reward's last phase needs none)."""
    k, P = sched.k, sched.phases
    index = {name: v for v, name in enumerate(prog.names)}
    keys = [(p, s) for p in range(P) for s in range(k)]
    binds = {key: [] for key in keys}
    stores = {key: [] for key in keys}
    carries = {key: [] for key in keys}
    reads = {key: set() for key in keys}
    for v, name in enumerate(prog.names):
        if prog.literal[v]:
            continue
        key = (sched.phase[v], sched.stream[v])
        reads[key].update(prog.names[u] for u in prog.preds[v])
        reads[key].update(prog.reads[v])
    out_at = []   # (phase, stream, slot, name or literal text)
    for slot, x in prog.outputs:
        v = index.get(x)
        key = ((sched.phase[v], sched.stream[v])
               if v is not None and not prog.literal[v] else (P - 1, 0))
        out_at.append((*key, slot, x))
        if v is not None:
            reads[key].add(x)
    overwritten = {slot: (p, s) for p, s, slot, _ in out_at}
    per = [{} for _ in range(k)]
    for (p, s), names in reads.items():
        for x in names:
            per[s].setdefault(x, []).append(p)
    loads, intervals = {}, [[] for _ in range(k)]
    for s in range(k):
        for x, ps in sorted(per[s].items()):
            ps.sort()
            v = index.get(x)
            if v is not None and prog.literal[v]:
                for p in ps:
                    binds[(p, s)].append((x, prog.exprs[v]))
                continue
            if v is None and x not in prog.input_slot:
                arr, j = prog.inputs[x]
                for p in ps:
                    binds[(p, s)].append((x, f"{arr}[{j}]"))
                continue
            if v is not None and sched.stream[v] == s:
                at = sched.phase[v]
            elif v is not None:
                at = ps[0]
                loads.setdefault(x, []).append((s, at))
            else:
                slot = prog.input_slot[x]
                at = ps[0]
                if slot in overwritten:
                    p_w, s_w = overwritten[slot]
                    at = min(at, p_w if s_w == s else p_w - 1)
                    if at < 0:
                        raise ValueError(f"{x} is read in the phase that "
                                         "overwrites its slot")
                binds[(at, s)].append((x, f"sh[{slot * LANES}]"))
            later = [p for p in ps if p > at]
            if later:
                intervals[s].append((at, later[-1], x, later))
    free_after = []
    for x in sorted(loads, key=lambda y: (sched.phase[index[y]], index[y])):
        v = index[x]
        start, end = sched.phase[v], max(p for _, p in loads[x])
        pick = next((i for i, f in enumerate(free_after) if f < start), None)
        if pick is None:
            pick = len(free_after)
            free_after.append(end)
        else:
            free_after[pick] = end
        stores[(start, sched.stream[v])].append((base + pick, x))
        for s, p in loads[x]:
            binds[(p, s)].append((x, f"sh[{(base + pick) * LANES}]"))
    for p, s, slot, x in out_at:
        stores[(p, s)].append((slot, x))
    regs = 0
    for s in range(k):
        free = []   # [last phase of the occupant, reg]
        for at, last, x, later in sorted(intervals[s]):
            pick = next((i for i, (f, _) in enumerate(free) if f <= at),
                        None)
            if pick is None:
                pick = len(free)
                free.append([last, pick])
            free[pick][0] = last
            reg = free[pick][1]
            carries[(at, s)].append((reg, x))
            for p in later:
                binds[(p, s)].append((x, f"reg[{reg}]"))
        regs = max(regs, len(free))
    cost = 0
    for p in range(P):
        cost += max(sum(prog.weights[v] for v in sched.order.get((p, s), ()))
                    for s in range(k))
        cost += EXCHANGE * sum(
            sum(1 for _, e in binds[(p, s)] if e.startswith("sh["))
            + len(stores[(p, s)]) for s in range(k))
    if k > 1:
        cost += BARRIER * (P if final_barrier else P - 1)
    return Layout(binds, stores, carries, len(free_after), regs, cost)


def relabel(sched: Schedule, first: int) -> Schedule:
    """``sched`` with streams ``first`` and 0 swapped."""
    swap = {first: 0, 0: first}
    return Schedule(sched.k, sched.phases,
                    [swap.get(s, s) if s >= 0 else s for s in sched.stream],
                    sched.phase,
                    {(p, swap.get(s, s)): ops
                     for (p, s), ops in sched.order.items()})


@dataclasses.dataclass
class Plan:
    """A program's schedule and its layout."""
    prog: Program
    sched: Schedule
    lay: Layout


def plan(prog: Program, k: int, base: int, final_barrier: bool,
         end_on_zero: bool = False) -> Plan:
    """``prog`` scheduled into ``k`` streams and laid out; with
    ``end_on_zero`` the stream that computes the (one) output is stream
    0."""
    sched = schedule(prog, k)
    if end_on_zero and prog.outputs:
        v = {name: i for i, name in enumerate(prog.names)}.get(
            prog.outputs[0][1])
        if v is not None and not prog.literal[v]:
            sched = relabel(sched, sched.stream[v])
    return Plan(prog, sched, layout(prog, sched, base, final_barrier))


# ---- the subtree partition ---------------------------------------------------

# the caps tried for ``_copies``: the most the ops another warp would
# send a value from may weigh for the reading warp to compute them itself
# (past a few hundred the solve's warp copies every term it sums)
REPLICATE_CAPS = (0, 64, 256)


@dataclasses.dataclass(frozen=True)
class Tree:
    """What the subtree partition reads of a model: each body's parent,
    each contact sphere's body, and each contact pair's spheres by kind
    (``engine_soa.contact_forces_soa``'s "plane", "sphere" and "segment"
    pairs, the plane itself left out)."""
    parents: tuple
    sphere_body: tuple
    pairs: dict

    @classmethod
    def of(cls, m) -> "Tree":
        """The tree of an ``engine_soa.SoaModel``."""
        return cls(tuple(int(p) for p in m.parents),
                   tuple(int(b) for b in m.sphere_body),
                   {"plane": tuple((int(s),) for s, _ in m.pair_sphere_plane),
                    "sphere": tuple(tuple(int(x) for x in r)
                                    for r in m.pair_sphere_sphere),
                    "segment": tuple(tuple(int(x) for x in r)
                                     for r in m.pair_sphere_segment)})


def subtree_groups(parents) -> list:
    """The bodies of each warp: a tree's root chain (its root down to the
    first body with more than one child, that body included) is one group
    and each subtree that hangs off it another; a tree that is a chain is
    one group."""
    n = len(parents)
    children = [[] for _ in range(n)]
    for b, p in enumerate(parents):
        if p >= 0:
            children[p].append(b)

    def below(b):
        out = [b]
        for c in children[b]:
            out += below(c)
        return sorted(out)

    groups = []
    for root in (b for b in range(n) if parents[b] < 0):
        chain = [root]
        while len(children[chain[-1]]) == 1:
            chain.append(children[chain[-1]][0])
        groups.append(chain)
        groups += [below(c) for c in children[chain[-1]]]
    return groups


def _merge(groups, weight) -> list:
    """``groups`` with the two of least ``weight`` (of their bodies) merged
    until at most ``MAX_STREAMS`` are left."""
    groups = [list(g) for g in groups]
    while len(groups) > MAX_STREAMS:
        groups.sort(key=lambda g: (sum(weight[b] for b in g), g))
        groups = [sorted(groups[0] + groups[1])] + groups[2:]
    return sorted(groups)


def _assign(prog, owners, tree, groups, solve):
    """Each op's warp and kind ("mass" and "sum" for the sums of the mass
    matrix and the right-hand side, else None): a body's op on its group's
    warp, a sphere's on its body's, a contact pair's on the warp of its
    sphere deepest in its tree (the first of equals), a sum of joint j on
    j's warp when every body below j is there, and every other op (the
    sums that gather terms from several warps, the solve, the
    integration) on warp ``solve``."""
    group = {b: g for g, members in enumerate(groups) for b in members}
    depth = [0] * len(tree.parents)
    for b, p in enumerate(tree.parents):
        depth[b] = depth[p] + 1 if p >= 0 else 0
    closed = [True] * len(tree.parents)
    for b, p in enumerate(tree.parents):
        while p >= 0:   # p is an ancestor of b: p's sums gather b's terms
            closed[p] = closed[p] and group[b] == group[p]
            p = tree.parents[p]
    warp, kind = [], []
    for name in prog.names:
        tag = owners.get(name, (None,))
        if tag[0] == "body":
            w = group[tag[1]]
        elif tag[0] == "sphere":
            w = group[tree.sphere_body[tag[1]]]
        elif tag[0] == "pair":
            body = max((tree.sphere_body[x]
                        for x in tree.pairs[tag[1]][tag[2]]),
                       key=lambda b: depth[b])
            w = group[body]
        elif tag[0] in ("mass", "sum") and closed[tag[1]]:
            w = group[tag[1]]
        else:
            w = solve
        warp.append(w)
        kind.append(tag[0] if tag[0] in ("mass", "sum") else None)
    return warp, kind


def _copies(prog, warp, cap) -> list:
    """For each warp, the ops of other warps that it computes again: those
    that a value it reads from another warp needs, where they weigh at
    most ``cap``."""
    n = len(prog.names)
    copies = [set() for _ in range(max(warp) + 1)]
    for v in range(n):
        if prog.literal[v]:
            continue
        for u in prog.preds[v]:
            h = warp[v]
            if prog.literal[u] or warp[u] == h or u in copies[h]:
                continue
            need, stack, weight = set(), [u], 0
            while stack and weight <= cap:   # past the cap: sent
                x = stack.pop()
                if x in need or prog.literal[x] or warp[x] == h \
                        or x in copies[h]:
                    continue
                need.add(x)
                weight += prog.weights[x]
                stack.extend(prog.preds[x])
            if weight <= cap:
                copies[h] |= need
    return copies


def _replicate(prog, warp, kind, copies):
    """``prog`` with each op of ``copies[h]`` (``_copies``) computed again
    on warp h: a copy of the op (its name with ``_w`` and the warp's
    number), the same expression on the copies of its operands, so the
    same bits. Returns (program, warp, kind)."""
    if not any(copies):
        return prog, warp, kind
    n = len(prog.names)
    index = {name: v for v, name in enumerate(prog.names)}

    def renamed(expr, h):
        return _NAME.sub(lambda m: (f"{m.group(1)}_w{h}"
                                    if index.get(m.group(1)) in copies[h]
                                    else m.group(1)), expr)

    # the new program's rows, (op, warp) each: an op, then its copies; a
    # copy weighs and reads what its original does, its operands the
    # copies on its warp where there are some (so each row's operands stay
    # in ascending order)
    rows, at, copy_at = [], [0] * n, [{} for _ in copies]
    names, exprs, preds = [], [], []
    for v in range(n):
        for h in [warp[v]] + [h for h, c in enumerate(copies) if v in c]:
            here = copy_at[h]
            if h == warp[v]:
                at[v] = len(rows)
                names.append(prog.names[v])
            else:
                here[v] = len(rows)
                names.append(f"{prog.names[v]}_w{h}")
            rows.append((v, h))
            ps = prog.preds[v]
            preds.append([here.get(u, at[u]) for u in ps])
            exprs.append(renamed(prog.exprs[v], h)
                         if any(u in here for u in ps) else prog.exprs[v])
    ops = [v for v, _ in rows]
    out = Program(prog.inputs, prog.input_slot, names, exprs,
                  [prog.weights[v] for v in ops], preds,
                  [prog.reads[v] for v in ops],
                  [prog.literal[v] for v in ops], prog.outputs)
    return out, [h for _, h in rows], [kind[v] for v in ops]


def _phases(prog, warp, kind, solve) -> tuple:
    """The phases of ``prog`` on fixed warps, without and with
    ``rhs_late``: warp ``solve``'s ops as early as their operands allow (a
    value of another warp one phase after its producer's), with
    ``rhs_late`` its right-hand-side sums that read another warp's terms
    no earlier than the phase after its mass-matrix sums, so that the
    solve's elimination of the matrix runs while the other warps compute
    those terms; then its sums and every other warp's ops as late as
    their readers allow (a sum adds one term an op: late, it lets the
    warps that send its terms send them late). Returns the two
    ``Schedule``s."""
    n = len(prog.names)
    ops = [v for v in range(n) if not prog.literal[v]]
    # each op's operands and readers that are ops, with whether the value
    # crosses warps
    preds = [()] * n
    succs = [[] for _ in range(n)]
    literal = prog.literal
    for v in ops:
        here = warp[v]
        preds[v] = edges = [(u, warp[u] != here) for u in prog.preds[v]
                            if not literal[u]]
        for u, cross in edges:
            succs[u].append((v, cross))
    late = [v for v in reversed(ops) if warp[v] != solve
            or kind[v] is not None]

    def earliest(release):
        at = [0] * n
        for v in ops:
            t = release.get(v, 0)
            for u, cross in preds[v]:
                if at[u] + cross > t:
                    t = at[u] + cross
            at[v] = t
        return at

    def schedule_(at):
        last = max(at[v] for v in ops)
        for v in late:
            t = last
            for u, cross in succs[v]:
                if at[u] - cross < t:
                    t = at[u] - cross
            at[v] = t
        used = sorted({at[v] for v in ops})
        renumber = {p: i for i, p in enumerate(used)}
        stream, phase, order = [-1] * n, [-1] * n, {}
        for v in ops:
            stream[v], phase[v] = warp[v], renumber[at[v]]
            order.setdefault((phase[v], stream[v]), []).append(v)
        return Schedule(max(warp) + 1, len(used), stream, phase, order)

    at = earliest({})
    mass = [at[v] for v in ops if warp[v] == solve and kind[v] == "mass"]
    first = max(mass, default=0) + 1
    release = {v: first for v in ops if warp[v] == solve and kind[v] == "sum"
               and any(cross for _, cross in preds[v])}
    return schedule_(list(at)), schedule_(earliest(release))


def chain_cuts(groups, weight, parents) -> list:
    """The groupings of the ``"chain"`` partition: ``groups`` with the
    heaviest of them (by its bodies' ``weight``) that is a chain of two
    bodies or more (each the parent of the next) cut into contiguous
    segments, every cut from one segment up to the warps ``MAX_STREAMS``
    leaves free, each grouping sorted; ``groups`` alone where no group is
    such a chain."""
    chains = [g for g in groups if len(g) > 1
              and all(parents[b] == a for a, b in zip(g, g[1:]))]
    if not chains:
        return [groups]
    chain = max(chains, key=lambda g: (sum(weight[b] for b in g), g))
    rest = [g for g in groups if g is not chain]
    out = []
    for segs in range(1, min(len(chain), MAX_STREAMS - len(rest)) + 1):
        for cut in itertools.combinations(range(1, len(chain)), segs - 1):
            ends = (0, *cut, len(chain))
            out.append(sorted(rest + [chain[a:b] for a, b in
                                      zip(ends, ends[1:])]))
    return out


def _warp_bound(prog, warp, copies) -> int:
    """The least cost ``layout`` can give ``prog`` on ``warp`` with
    ``copies`` (``_copies``), before its phases are known: the largest
    warp's weight, its copies' included, and the two barriers of the
    fewest phases that split a substep."""
    per = [0] * (max(warp) + 1)
    for v, w in enumerate(warp):
        per[w] += prog.weights[v]
    for w, ops in enumerate(copies):
        per[w] += sum(prog.weights[v] for v in ops)
    return max(per) + 2 * BARRIER


def _phase_bound(prog, sched: Schedule) -> int:
    """The least cost ``layout`` can give ``sched``: each phase's largest
    warp's weight and a barrier a phase (the exchanges left out)."""
    work = [[0] * sched.k for _ in range(sched.phases)]
    for v, s in enumerate(sched.stream):
        if s >= 0:
            work[sched.phase[v]][s] += prog.weights[v]
    return sum(max(row) for row in work) + BARRIER * sched.phases


def plan_partition(prog: Program, owners: dict, tree: Tree, base: int,
                   mode: str = "subtree", prune=None):
    """The partition of the substep ``prog`` by the body tree (its ops'
    owner tags ``owners``, ``scalar_math.Emitter.owners``): one warp a
    group of ``subtree_groups`` (past ``MAX_STREAMS`` groups the lightest
    merged, ``_merge``); in ``mode`` "chain" each grouping of
    ``chain_cuts`` in turn, the heaviest chain of bodies cut into segments
    over the free warps. For each grouping, the search over the warp that
    runs the solve, the replication cap (``REPLICATE_CAPS``) and
    ``rhs_late`` (``_phases``) keeps the plan the model prices lowest (of
    equal costs, the first in that order). A choice that ``layout``
    refuses is skipped; ``report["cost_by_choice"]`` holds its error's
    text in place of a cost (its key names the grouping first in "chain"
    mode). ``prune`` (by default where more than one grouping is
    searched) skips a choice whose lower bound (``_warp_bound``,
    ``_phase_bound``) cannot beat the best plan found so far, and records
    the bound in its place; the plan kept is the same. Returns (plan,
    report). Raises ``ValueError`` in "subtree" mode on a tree of fewer
    than two groups (a chain): with nothing to put beside its one warp
    there is no partition; and where no choice lays out."""
    if mode not in ("subtree", "chain"):
        raise ValueError(f"mode must be 'subtree' or 'chain', not {mode!r}")
    found = subtree_groups(tree.parents)
    if mode == "subtree" and len(found) < 2:
        raise ValueError(
            f"the subtree partition needs a fork in the body tree: this "
            f"tree gives {len(found)} group (a chain), which would put "
            f"every op on one warp; list-schedule it (partition=None)")
    weight = [0] * len(tree.parents)
    for v, name in enumerate(prog.names):
        tag = owners.get(name, (None,))
        if tag[0] == "body":
            weight[tag[1]] += prog.weights[v]
    groups = _merge(found, weight)
    groupings = (chain_cuts(groups, weight, tree.parents)
                 if mode == "chain" else [groups])
    if prune is None:
        prune = len(groupings) > 1
    # every (grouping, solve) in the enumeration's order, with the rank
    # of its first choice there; pruned, the cheapest bound first
    tasks = []
    for gi, grouping in enumerate(groupings):
        name = ("|".join(",".join(map(str, g)) for g in grouping) + "_"
                if mode == "chain" else "")
        for solve in range(len(grouping)):
            warp, kind = _assign(prog, owners, tree, grouping, solve)
            tasks.append((_warp_bound(prog, warp, ()) if prune else 0,
                          (gi, solve), name, grouping, solve, warp, kind))
    if prune:
        tasks.sort(key=lambda t: t[:2])
    best, costs = None, {}

    def beaten(bound, rank):
        return prune and best is not None and (bound, rank) > best[2]

    for bound, rank, name, grouping, solve, warp, kind in tasks:
        if beaten(bound, rank + (0, 0)):
            costs.update({f"{name}solve{solve}_cap{cap}_rhs{r}":
                          f"pruned: bound {bound}"
                          for cap in REPLICATE_CAPS for r in (0, 1)})
            continue
        for ci, cap in enumerate(REPLICATE_CAPS):
            copies = _copies(prog, warp, cap)
            keys = [f"{name}solve{solve}_cap{cap}_rhs{r}" for r in (0, 1)]
            low = _warp_bound(prog, warp, copies) if prune else 0
            if beaten(low, rank + (ci, 0)):
                for key in keys:
                    costs[key] = f"pruned: bound {low}"
                continue
            prog2, warp2, kind2 = _replicate(prog, warp, kind, copies)
            for rhs_late, sched in enumerate(_phases(prog2, warp2, kind2,
                                                     solve)):
                if sched.phases < 2:   # all on one warp: the lane layout
                    continue
                key, at = keys[rhs_late], rank + (ci, rhs_late)
                if prune:
                    low = _phase_bound(prog2, sched)
                    if beaten(low, at):
                        costs[key] = f"pruned: bound {low}"
                        continue
                # Where the solve's warp copies every value it would read
                # from another warp (each weighs at most the cap: at 256,
                # a small second tree such as hammer-v0's nail, whose mass
                # block is its own), the whole substep runs on that warp
                # in phase 0, which stores the tree root's new q. The
                # originals of the copies are left with no reader, so
                # ``_phases`` puts them in the last phase, where they would
                # read that q's slot after its overwrite. ``layout``
                # refuses the read; the choice is the lane program on one
                # warp with dead ops beside it, and is skipped.
                try:
                    lay = layout(prog2, sched, base, True)
                except ValueError as err:
                    costs[key] = str(err)
                    continue
                costs[key] = lay.cost
                if best is None or (lay.cost, at) < best[2]:
                    best = (Plan(prog2, sched, lay),
                            dict(solve_warp=solve, replicate_cap=cap,
                                 rhs_late=bool(rhs_late),
                                 copies=sum(map(len, copies)),
                                 groups=grouping),
                            (lay.cost, at))
    if best is None:
        raise ValueError(
            f"no choice of the {mode} partition lays out: all "
            f"{len(costs)} choices failed, the first with: "
            f"{next(iter(costs.values()), 'no choice has two phases')}")
    plan_, report, _ = best
    outs = set(plan_.prog.outputs)
    crossing = {x for st in plan_.lay.stores.values() for slot, x in st
                if (slot, x) not in outs}
    # each phase's op weight on each warp: how long each warp works
    order, k = plan_.sched.order, plan_.sched.k
    weights = [[sum(plan_.prog.weights[v] for v in order.get((p, s), ()))
                for s in range(k)] for p in range(plan_.sched.phases)]
    report.update(mode=mode, groupings=len(groupings), phase_weights=weights,
                  exchanged=len(crossing),
                  loads=sum(1 for binds in plan_.lay.binds.values()
                            for _, e in binds if e.startswith("sh[")),
                  cost_by_choice=costs)
    return plan_, report


def _function(prefix, plan_, p, s):
    prog, lay = plan_.prog, plan_.lay
    lines = [f"  const float {x} = {e};" for x, e in lay.binds[(p, s)]]
    lines += [f"  const float {prog.names[v]} = {prog.exprs[v]};"
              for v in sorted(plan_.sched.order.get((p, s), ()))]
    lines += [f"  sh[{slot * LANES}] = {x};" for slot, x in
              lay.stores[(p, s)]]
    lines += [f"  reg[{r}] = {x};" for r, x in lay.carries[(p, s)]]
    if not lines:
        return None
    name = f"{prefix}_{p}_{s}"
    return name, (f"PPI_QUAL void {name}(PPI_PHASE_ARGS) {{\n"
                  + "\n".join(lines) + "\n}\n")


def emit(prefix: str, plan_: Plan, width: int, clock0: int,
         final_barrier: bool):
    """(phase functions, device sequencer, host table) of ``plan_`` in a
    group of ``width`` streams: the
    sequencer ``{prefix}(w, sh, tau, act, dyn, consts)`` runs stream w's
    share of each phase with ``PPI_BARRIER(clock0 + p)`` after it (after
    the last phase ``PPI_MARK`` where ``final_barrier`` is false); the
    host table ``ppi_{prefix}_fns[phase][stream]`` holds the functions
    (NULL where a stream has nothing to do)."""
    k, P = plan_.sched.k, plan_.sched.phases
    funcs, table, seq = [], [], []
    regs = max(plan_.lay.regs, 1)
    seq.append(f"PPI_QUAL void {prefix}(int w, PPI_SEQ_ARGS) {{")
    seq.append(f"  float reg[{regs}];")
    for p in range(P):
        row, chain = [], []
        for s in range(k):
            f = _function(prefix, plan_, p, s)
            if f is None:
                row.append("NULL")
                continue
            funcs.append(f[1])
            row.append(f[0])
            chain.append(f"if (w == {s}) {f[0]}(PPI_PHASE_CALL);")
        if chain:
            seq.append("  " + " else ".join(chain))
        last = p == P - 1
        if last and not final_barrier:
            seq.append(f"  PPI_MARK({clock0 + p});")
        else:
            seq.append(f"  PPI_BARRIER({clock0 + p});")
        row += ["NULL"] * (width - k)
        table.append("  {" + ", ".join(row) + "}")
    seq.append("}")
    host = (f"static const PpiPhaseFn ppi_{prefix}_fns[{P}][{width}] = {{\n"
            + ",\n".join(table) + "};")
    return funcs, "\n".join(seq) + "\n", host


def plan_body(em_sub, q2, qd2, em_rew, r, nq: int, substeps: int,
              torque_ops: int, streams=None, tree=None,
              partition: str = "subtree") -> dict:
    """The split layout of one body, planned: its report (the streams,
    phases, slots and carry registers chosen, the model's cost a step for
    each number of streams, the substep's and the reward's plans, and with
    ``tree`` the partition's report).

    ``em_sub`` emitted one substep (q2, qd2 its new state), ``em_rew`` the
    reward ``r``. Slots: q at 0..nq-1, qd at nq..2nq-1, the reward at 2nq,
    then the substep's and the reward's own. K, from 2 (one stream is the
    lane layout) to ``MAX_STREAMS``, is the one whose step costs least in
    the model (substeps x the substep, the reward into at most K streams,
    the torque on every stream), or ``streams``. With ``tree`` (a
    ``Tree``) the substep is the subtree partition's (``plan_partition``,
    from ``em_sub``'s owner tags) and K its number of groups; the reward
    is list-scheduled either way."""
    if streams and tree is not None:
        raise ValueError("the subtree partition chooses its own warps")
    slot_q, slot_qd, slot_r = 0, nq, 2 * nq
    in_slots = {"q": slot_q, "qd": slot_qd}
    sub = parse(em_sub, [(slot_q + j, q2[j]) for j in range(nq)]
                + [(slot_qd + j, qd2[j]) for j in range(nq)], in_slots)
    rew = parse(em_rew, [(slot_r, r)], in_slots)
    base = 2 * nq + 1
    best, report, part_report = None, {}, None
    if tree is not None:
        part, part_report = plan_partition(sub, em_sub.owners, tree, base,
                                           partition)
        ks = [part.sched.k]
    else:
        ks = [streams] if streams else range(2, MAX_STREAMS + 1)
    rews = [plan(rew, kr, 0, False, True) for kr in range(1, max(ks) + 1)]
    for k in ks:
        ps = part if tree is not None else plan(sub, k, base, True)
        pr = min(rews[:k], key=lambda x: x.lay.cost)
        pr = Plan(rew, pr.sched, layout(rew, pr.sched, base + ps.lay.slots,
                                        False))
        step = substeps * ps.lay.cost + pr.lay.cost + torque_ops
        report[k] = step
        if best is None or step < best[0]:
            best = (step, k, ps, pr)
    step, k, ps, pr = best
    return {"streams": k, "reward_streams": pr.sched.k,
            "substep_phases": ps.sched.phases,
            "reward_phases": pr.sched.phases,
            "slots": base + ps.lay.slots + pr.lay.slots,
            "regs": max(ps.lay.regs, pr.lay.regs),
            "substep_cost": ps.lay.cost, "reward_cost": pr.lay.cost,
            "step_cost": step, "step_cost_by_streams": report,
            "substep_plan": ps, "reward_plan": pr,
            "slot_q": slot_q, "slot_qd": slot_qd, "slot_r": slot_r,
            "partition": part_report}


def emit_body(info: dict):
    """(defines, text) of ``plan_body``'s plan: the phase functions, the
    device sequencers ``env_sub`` and ``env_rew`` and the host tables.
    Raises where a group's slots exceed the shared memory of a block."""
    k, ps, pr = info["streams"], info["substep_plan"], info["reward_plan"]
    if info["slots"] * LANES * 4 > SHARED_BYTES:
        raise ValueError(f"the split layout needs {info['slots'] * LANES * 4}"
                         f" B of shared memory a group, more than the "
                         f"{SHARED_BYTES} B a block may use")
    f_sub, seq_sub, host_sub = emit("env_sub", ps, k, 0, True)
    f_rew, seq_rew, host_rew = emit("env_rew", pr, k, ps.sched.phases,
                                    False)
    defines = [f"#define PPI_K {k}",
               f"#define PPI_SLOT_Q {info['slot_q']}",
               f"#define PPI_SLOT_QD {info['slot_qd']}",
               f"#define PPI_SLOT_R {info['slot_r']}",
               f"#define PPI_SLOTS {info['slots']}",
               f"#define PPI_REGS {max(info['regs'], 1)}",
               f"#define PPI_SUB_PHASES {ps.sched.phases}",
               f"#define PPI_REW_PHASES {pr.sched.phases}"]
    text = "\n".join([
        *f_sub, *f_rew,
        "#ifdef __CUDACC__", seq_sub, seq_rew, "#else", host_sub, host_rew,
        "#endif", ""])
    return defines, text


def cached_body(cache: Path, em_sub, q2, qd2, em_rew, r, nq: int,
                substeps: int, torque_ops: int, tree=None,
                partition: str = "subtree"):
    """``emit_body(plan_body(...))``, kept in ``cache`` under the sha256 of
    the two programs, their outputs, the partition's tree and owner tags
    (with ``tree``) and the generator's own source (this module and
    ``scalar_math``): the search runs once per body and generator, not
    once per process. The text is the same either way."""
    key = hashlib.sha256()
    for module in (__file__, sm.__file__):
        key.update(Path(module).read_bytes())
    outs = [x.name if isinstance(x, sm.Sym) else sm.f32_literal(x)
            for x in (*q2, *qd2, r)]
    part = None if tree is None else [partition, dataclasses.asdict(tree),
                                      sorted(em_sub.owners.items())]
    key.update(json.dumps([em_sub.lines, em_rew.lines, outs, nq, substeps,
                           torque_ops, part]).encode())
    path = cache / f"{key.hexdigest()}.json"
    if path.exists():
        got = json.loads(path.read_text())
        return got["defines"], got["text"]
    defines, text = emit_body(plan_body(em_sub, q2, qd2, em_rew, r, nq,
                                        substeps, torque_ops, tree=tree,
                                        partition=partition))
    cache.mkdir(parents=True, exist_ok=True)
    # a temporary of this process and thread: two may plan one body at once
    tmp = path.with_name(f".{path.name}.{os.getpid()}."
                         f"{threading.get_ident()}")
    tmp.write_text(json.dumps({"defines": defines, "text": text}))
    os.replace(tmp, path)
    return defines, text
