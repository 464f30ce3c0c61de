"""Dense vectorized NFA on torch tensors: the port's pattern hot path.

Port of the JAX package's ``ops/dense_nfa.py`` for its event-time
step: chains of plain stream, count (``<3:5>``, Kleene ``<1:>``) and
logical (``and``/``or``, over one stream or several) nodes under an
``every``, non-every or whole-chain group-every head, patterns and
strict-contiguity sequences, an optional ``within``, float and integer
captures and first/[0]/[last] refs, and its timer step: absent nodes
(``not X for t``) and ``and not`` sides, killed by a matching event in
the event step and fired by ``make_time_step`` when their deadline
passes.  Per-partition NFA state lives on the device as a dict of
tensors under the JAX engine's keys:

- ``active`` ``[P+1, S, I]`` bool: pending instance lanes per node;
- ``first_ts`` ``[P+1, S, I]`` int32: within anchors, relative ms since
  ``base_ts`` (0 = unset);
- ``counts`` ``[P+1, S, I]`` int32: captures so far at a count node, the
  bitmask of matched sides at a logical node;
- ``regs`` ``[P+1, S, I, max(R, 1)]`` float32: the float capture
  registers of each pending instance;
- ``iregs`` ``[P+1, S, I, 2*RI]`` int32 (only with integer captures):
  INT/LONG capture registers as hi/lo pairs;
- ``overflow`` ``[P+1]`` int32: instances dropped for want of a free lane;
- ``deadline`` ``[P+1, S, I]`` int32 (only with absent ``for`` specs):
  absent deadlines, relative ms (0 = unset).

Row ``P`` is the reference's scratch row; no step writes it.  Each
engine runs one of two steps, picked at compile time by
``planner/kernels.route_dense_step`` (``engine.step_kind``):

- ``"batch"``: a capture-free every-chain of plain stream nodes with at
  most 32 lanes and no reset on emit.  The batch is sorted stably by
  partition on the host (``partition_segments``), staged in one put,
  and stepped in one ``kernels/dense_batch.batch_step``: the CUDA kernel
  on a card walks each partition's events in batch order against its
  state row, in place; its plain torch version on the CPU steps the
  collision rounds.
- ``"general"``: everything else the port admits.  The batch is staged
  in one put, split into collision rounds (each partition at most once
  a round), and each round runs ``make_general_step``: the JAX
  package's XLA step in torch ops, register file included.

Matches come back through ``DeferredDenseEmit``: after the count gate
each step's matched rows are compacted on the device
(``compact_matches``), already ordered and typed, and only they cross,
through ``core/emit_queue.fetch_coalesced``; they reach the host as
``MatchColumns``.

Timestamps ride int32 relative lanes re-anchored before they approach
the int32 range; LONG attributes ride hi/lo int32 pairs; DOUBLE is kept
as float32.  That is the JAX engine's lane layout, which is what makes
the two bit-identical.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
without a card they raise rather than run on the CPU.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from siddhi_tpu_torch.core.emit_queue import PendingEmit, fetch_coalesced
from siddhi_tpu_torch.core.exceptions import (
    DeviceUncompilableError,
    KernelUnavailableError,
    SiddhiAppCreationError,
    SiddhiAppRuntimeError,
)
from siddhi_tpu_torch.core.ingest_stage import staged_put
from siddhi_tpu_torch.kernels import probe
from siddhi_tpu_torch.kernels.dense_batch import MAX_INSTANCES, batch_step
from siddhi_tpu_torch.kernels.dense_step import (
    F32_MIN_NORMAL,
    MAX_INSTANCES as PACKED_MAX_INSTANCES,
    build_packed_nfa,
    candidate_env,
    flush_subnormals,
)
from siddhi_tpu_torch.kernels.plane_pack import unpack_state
from siddhi_tpu_torch.observability.trace import (
    STAGE_INGEST_PUT,
    STAGE_INGEST_SEGMENTS,
    STAGE_STEP_LAUNCH,
    STAGE_STEP_ROUND,
)
from siddhi_tpu_torch.ops.nfa import NFABuilder, Node, PatternScope
from siddhi_tpu_torch.planner.expr import CompiledExpression, ExpressionCompiler
from siddhi_tpu_torch.planner.kernels import route_dense_step
from siddhi_tpu_torch.query_api import (
    AttrType,
    CountStateElement,
    StateInputStream,
    Variable,
)
from siddhi_tpu_torch.query_api.definition import StreamDefinition


@dataclass
class RegSlot:
    ref: str
    attr: str
    last: bool  # False: first captured event; True: last captured event
    index: int
    integer: bool = False  # True: hi/lo int32 pair in the iregs bank


# integer (INT/LONG) values ride hi/lo int32 pairs: hi = v >> 32 (signed),
# lo = (v & 0xffffffff) - 2^31 (bias-signed, so SIGNED int32 comparison of
# lo equals UNSIGNED comparison of the raw low word) — (hi, lo)
# lexicographic signed order == int64 signed order, bit-exact at any
# magnitude
_INT_TYPES = (AttrType.INT, AttrType.LONG)


def _i64_split_const(v: int) -> Tuple[np.int32, np.int32]:
    v = int(v)
    return (np.int32(v >> 32), np.int32((v & 0xFFFFFFFF) - 2**31))


def _i64_join(hi: np.ndarray, lo: np.ndarray) -> np.ndarray:
    return ((hi.astype(np.int64) << 32)
            | (lo.astype(np.int64) + 2**31).astype(np.uint32))


def resolve_device(device=None) -> torch.device:
    """``cuda`` unless the caller names a device; a CUDA device with no
    card raises instead of running on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SiddhiAppCreationError(
            "no CUDA device is available; pass device='cpu' to run the "
            "port's plain versions on the CPU")
    return dev


class DenseScope(PatternScope):
    """Filter/selector scope resolving captured refs to register slots."""

    def __init__(self, ref_defs, stream_to_ref, cand_def, alloc: "RegAllocator",
                 cand_ref=None):
        super().__init__(ref_defs, stream_to_ref, cand_def, cand_ref=cand_ref)
        self.alloc = alloc

    def resolve(self, var: Variable):
        key, t = super().resolve(var)
        if key.startswith("__cand."):
            return key, t
        # captured reference -> register slot key
        ref, idx, attr, _t = self.used_captures[key]
        integer = t in _INT_TYPES
        if idx in (None, 0):
            slot = self.alloc.slot(ref, attr, last=False, integer=integer)
        elif idx == -1:
            slot = self.alloc.slot(ref, attr, last=True, integer=integer)
        else:
            raise SiddhiAppCreationError(
                f"dense NFA supports only first/[0]/[last] capture refs, got index {idx}"
            )
        prefix = "__ireg" if integer else "__reg"
        return f"{prefix}.{slot.index}", t


class RegAllocator:
    """Two banks: float32 value slots (``regs``) and integer hi/lo pair
    slots (``iregs``) — indexed independently."""

    def __init__(self):
        self.slots: Dict[Tuple[str, str, bool], RegSlot] = {}
        self._n_float = 0
        self._n_int = 0

    def slot(self, ref: str, attr: str, last: bool,
             integer: bool = False) -> RegSlot:
        k = (ref, attr, last)
        if k not in self.slots:
            idx = self._n_int if integer else self._n_float
            self.slots[k] = RegSlot(ref, attr, last, idx, integer)
            if integer:
                self._n_int += 1
            else:
                self._n_float += 1
        return self.slots[k]

    @property
    def n(self) -> int:
        return self._n_float

    @property
    def n_int(self) -> int:
        return self._n_int


_FLOAT_TYPES = (AttrType.FLOAT, AttrType.DOUBLE)
_ANY = CountStateElement.ANY  # an unbounded count's max


def _flush_const(c):
    """A constant where it meets a float32 lane: the reference's weakly
    typed scalar becomes float32 there, a zero of its sign when that is
    subnormal.  Integers and booleans pass."""
    if isinstance(c, (float, np.floating)):
        f = np.float32(c)
        if f != 0 and abs(f) < F32_MIN_NORMAL:
            return type(c)(np.copysign(0.0, f))
    return c


class DenseExprCompiler(ExpressionCompiler):
    """Dense-filter compiler: integer (INT/LONG) leaves ride hi/lo int32
    pairs (``<key>|hi`` / ``<key>|lo`` env lanes); comparisons between
    integer leaves compile to bit-exact paired compares at any
    magnitude.  Every other integer use (arithmetic) raises.

    Float lanes follow the reference's XLA on the CPU, which flushes
    float32 subnormals to zeros of their sign: the filter envs hold
    flushed float columns and registers (``candidate_env``,
    ``flush_subnormals`` over the register file once a step, so each
    lane is flushed once, not at every leaf); the compiler flushes a
    constant where it meets a lane and the result of float arithmetic
    on lanes.  Arithmetic between two constants stays numpy float64, as
    in the reference's trace."""

    PAIR_TYPES = _INT_TYPES

    @staticmethod
    def _meet(a, b):
        # a constant meeting a lane becomes float32 there
        if isinstance(a, torch.Tensor) and not isinstance(b, torch.Tensor):
            return a, _flush_const(b)
        if isinstance(b, torch.Tensor) and not isinstance(a, torch.Tensor):
            return _flush_const(a), b
        return a, b

    def _c_ArithmeticOp(self, e):
        c = super()._c_ArithmeticOp(e)
        if c.type not in _FLOAT_TYPES:
            return c

        def fn(env):
            x = c.fn(env)
            return flush_subnormals(x) if isinstance(x, torch.Tensor) else x

        return CompiledExpression(fn, c.type)

    def _i64_parts(self, e, var_only=False):
        """Integer leaf -> (hi_fn, lo_fn) env readers, else None.
        ``var_only`` skips constants: an integer LITERAL against a float
        lane (``[v > 100]``) stays on the ordinary float compare."""
        from siddhi_tpu_torch.query_api import Constant

        if (not var_only and isinstance(e, Constant)
                and e.type in _INT_TYPES and e.value is not None):
            hi, lo = _i64_split_const(e.value)
            return (lambda env: hi), (lambda env: lo)
        if isinstance(e, Variable):
            key, t = self.scope.resolve(e)
            if t in self.PAIR_TYPES:
                return ((lambda env: env[key + "|hi"]),
                        (lambda env: env[key + "|lo"]))
        return None

    def _c_CompareOp(self, e):
        # pair compares engage only when an integer VARIABLE lane is
        # involved; integer constants alone coerce fine on float lanes
        if (self._i64_parts(e.left, var_only=True) is None
                and self._i64_parts(e.right, var_only=True) is None):
            return super()._c_CompareOp(e)
        lp, rp = self._i64_parts(e.left), self._i64_parts(e.right)
        if lp is None or rp is None:
            raise SiddhiAppCreationError(
                "dense NFA: comparison mixes a 64-bit integer lane with a "
                "non-integer operand")
        lhi, llo = lp
        rhi, rlo = rp
        op = e.op

        def fn(env):
            a_hi, a_lo = lhi(env), llo(env)
            b_hi, b_lo = rhi(env), rlo(env)
            if op == "==":
                return (a_hi == b_hi) & (a_lo == b_lo)
            if op == "!=":
                return (a_hi != b_hi) | (a_lo != b_lo)
            if op == ">":
                return (a_hi > b_hi) | ((a_hi == b_hi) & (a_lo > b_lo))
            if op == ">=":
                return (a_hi > b_hi) | ((a_hi == b_hi) & (a_lo >= b_lo))
            if op == "<":
                return (a_hi < b_hi) | ((a_hi == b_hi) & (a_lo < b_lo))
            return (a_hi < b_hi) | ((a_hi == b_hi) & (a_lo <= b_lo))

        return CompiledExpression(fn, AttrType.BOOL)

    def _c_Variable(self, e):
        key, t = self.scope.resolve(e)
        if t in self.PAIR_TYPES:
            raise SiddhiAppCreationError(
                "dense NFA: integer attribute used outside a plain "
                "comparison (arithmetic/functions on 64-bit lanes need "
                "the host engine)")
        return super()._c_Variable(e)


def filter_env(cand_env, slots, regs, iregs):
    """Filter env of one node over ``[B, I]`` lanes: the candidate's
    columns (``cand_env``, ``candidate_env``'s, shared by the nodes of
    one stream) and the node's registers per instance, under the
    reference's keys: ``__reg.{i}`` for float slots of ``regs [B, I,
    R]``, and ``__ireg.{i}|hi``/``|lo`` for integer slots of ``iregs
    [B, I, 2*RI]`` (the JAX step's ``env_for``).  ``regs`` are as
    filters read them (``flush_subnormals``)."""
    env = dict(cand_env)
    for slot in slots:
        if slot.integer:
            env[f"__ireg.{slot.index}|hi"] = iregs[:, :, 2 * slot.index]
            env[f"__ireg.{slot.index}|lo"] = iregs[:, :, 2 * slot.index + 1]
        else:
            env[f"__reg.{slot.index}"] = regs[:, :, slot.index]
    return env


def _one_hot_sum(values: torch.Tensor) -> torch.Tensor:
    """The reference moves registers with a one-hot sum over the source
    lanes (``jnp.sum(jnp.where(assign, src, 0.0), axis=1)``): the moved
    value plus zeros.  With two or more lanes that sum turns -0.0 into
    +0.0 and, on XLA's CPU (which flushes denormals), a subnormal into
    +0.0, and keeps NaN bits; with one lane XLA makes the reduce a
    reshape and the value passes unchanged.  The port gathers the moved
    value (``values``, for I > 1) and applies that rule without doing
    arithmetic on it, so the card and the CPU give the same bits."""
    return torch.where(values.abs() < F32_MIN_NORMAL,
                       torch.zeros((), dtype=values.dtype,
                                   device=values.device), values)


def _lane_rank(x: torch.Tensor, upto: torch.Tensor) -> torch.Tensor:
    """``x.cumsum(dim=1) - 1`` for ``x [B, I]`` bool, as a masked sum
    over ``upto [I, I]`` (``upto[i, j] = j <= i``): CUDA's scan along a
    short innermost axis takes most of a millisecond a call at
    B = 131,072, the sum a few microseconds."""
    return (x[:, None, :] & upto).sum(dim=2) - 1


def _rank_place(t, mask, anchor, src_regs, src_iregs, entry_dl, a, first,
                counts, regs, iregs, dl, ovf, upto):
    """Rank-matched placement of advancing instances into free lanes of
    node ``t`` (the JAX package's ``_rank_place``, shared by the event
    step and the timer step): the k-th lane of ``mask`` takes the k-th
    free lane of node ``t``, carrying its anchor, registers and, where
    node ``t`` has an absent ``for`` spec, its deadline ``entry_dl``
    ([B, I] int32, else None); advancers beyond the free lanes are
    dropped and counted.  ``a``, ``first``, ``counts``, ``regs``,
    ``iregs`` and ``dl`` (the deadline rows, None without deadline
    state) change in place; returns the new overflow counts.
    ``upto``: the lane-rank mask of ``_lane_rank``."""
    B, I = mask.shape
    free = ~a[:, t] & (counts[:, t] == 0)  # [B, I]
    src_rank = _lane_rank(mask, upto)
    free_rank = _lane_rank(free, upto)
    n_free = free.sum(dim=1, keepdim=True)
    placed = mask & (src_rank < n_free)
    ovf = ovf + (mask & ~placed).sum(dim=1, dtype=torch.int32)
    # [B, Isrc, Itgt] one-hot assignment
    assign = (placed[:, :, None] & free[:, None, :]
              & (src_rank[:, :, None] == free_rank[:, None, :]))
    got = assign.any(dim=1)  # [B, I] target lanes filled
    # the source lane of each filled target lane (0 where none)
    lanes = torch.arange(I, device=mask.device)
    src = (assign * lanes[None, :, None]).sum(dim=1)  # [B, I]

    def moved(bank):
        idx = src[:, :, None].expand(B, I, bank.shape[-1])
        return torch.gather(bank, 1, idx)

    moved_regs = moved(src_regs)
    if I > 1:
        moved_regs = _one_hot_sum(moved_regs)
    a[:, t] |= got
    g = got[:, :, None]
    regs[:, t] = torch.where(g, moved_regs, regs[:, t])
    if iregs is not None:
        iregs[:, t] = torch.where(g, moved(src_iregs), iregs[:, t])
    first[:, t] = torch.where(got, torch.gather(anchor, 1, src), first[:, t])
    counts[:, t].masked_fill_(got, 0)
    if dl is not None:
        if entry_dl is not None:
            dl[:, t] = torch.where(got, torch.gather(entry_dl, 1, src),
                                   dl[:, t])
        else:
            # a target without a deadline spec: clear a stale value left
            # by the lane's previous occupant
            dl[:, t].masked_fill_(got, 0)
    return ovf


def _untraceable(e: DeviceUncompilableError) -> CompiledExpression:
    """A filter that fails where the reference's fails, when the step
    first runs it (``core/dense_pattern._trace_check`` at plan time):
    the engine's other checks come first, in the reference's order."""

    def fn(env):
        raise TypeError(str(e))

    return CompiledExpression(fn, AttrType.BOOL)


def _plain(node: Node) -> bool:
    """A plain stream node: one event, no count."""
    return (node.kind == "stream" and node.min_count == 1
            and node.max_count == 1)


def _present_mask(node: Node) -> int:
    """The bits of a logical node's present sides in ``counts``: absent
    sides count toward completion by staying silent."""
    return sum(1 << i for i, sp in enumerate(node.specs) if not sp.is_absent)


def is_open_count(node: Node) -> bool:
    """A count that stays dually pending once satisfied (``<1:>``,
    ``<2:4>``): it clones through its successor by the via-path."""
    return (node.kind == "stream" and not _plain(node)
            and (node.max_count == _ANY or node.max_count > node.min_count))


class DensePatternEngine:
    """A lowered node chain compiled into the batch step or the general
    step (``step_kind``, fixed at compile time).

    Usage:
        eng = compile_pattern(app_str, "q", n_partitions=P, device="cuda")
        state = eng.init_state()
        state, match_ev_idx, out = eng.process(state, stream_key,
                                               part_idx, cols, ts)

    ``process`` updates the state tensors in place and returns the dict.
    """

    base_ts: Optional[int] = None
    # set by a DensePatternRuntime: its staged puts count there
    ingest_stats = None
    # the app's fault injector: the step.dense and ingest.put sites
    faults = None
    # re-anchor before relative ms approach int32 range (~24.8 days of
    # stream time); headroom covers one batch + the within horizon
    _REL_LIMIT = 2**31 - 2**24

    def __init__(
        self,
        nodes: List[Node],
        ref_defs: Dict[str, StreamDefinition],
        stream_to_ref: Dict[str, Optional[str]],
        within_ms: Optional[int],
        n_partitions: int,
        select_vars: List[Variable],
        select_names: Optional[List[str]] = None,
        is_sequence: bool = False,
        n_instances: int = 4,
        device=None,
        reset_on_emit: Optional[bool] = None,
        every_start: Optional[bool] = None,
    ):
        self.device = resolve_device(device)
        self.nodes = nodes
        self.ref_defs = ref_defs
        self.within_ms = within_ms
        self.n_partitions = int(n_partitions)
        # an `every` anywhere re-arms the start on every event (None: as
        # the pattern says; the reference's compile_pattern takes the
        # same override)
        self.every_start = (any(n.rearm_to is not None for n in nodes)
                            if every_start is None else bool(every_start))
        # a match clears the partition's whole automaton.  None: only for
        # non-every heads, as the reference's product runtime sets it
        # (`every` consumes just the matched instance); the reference's
        # compile_pattern leaves it True, which callers pass explicitly
        self.reset_on_emit = (not self.every_start if reset_on_emit is None
                              else bool(reset_on_emit))
        self.is_sequence = is_sequence
        self.S = len(nodes)
        # sequences keep one pending per state; non-every patterns arm
        # exactly one chain
        self.I = (1 if (is_sequence or not self.every_start)
                  else max(int(n_instances), 1))
        if self.S > 32:
            raise SiddhiAppCreationError("dense NFA supports at most 32 chain nodes")
        # a rearm at node 0's completion is the standing virgin; a
        # whole-chain group-every (`every (e1 -> e2)`, the last node
        # re-arming node 0) keeps one arm at a time: the virgin arms only
        # while the partition has no active instance
        self.group_every = False
        for n in nodes:
            if n.rearm_to is None or (n.pos == 0 and n.rearm_to == 0):
                continue
            if (n.pos == self.S - 1 and n.rearm_to == 0
                    and not is_sequence
                    and nodes[0].kind == "stream"
                    and nodes[0].min_count == 1 and nodes[0].max_count == 1
                    and not any(sp.is_absent for nn in nodes
                                for sp in nn.specs)):
                self.group_every = True
                continue
            raise SiddhiAppCreationError(
                "dense NFA: this group-`every` shape (partial chain, or "
                "absent states whose violation must kill the arm "
                "permanently) needs the host engine")
        if self.group_every:
            self.I = 1
        # a node with an absent `for t` spec arms `deadline = entry ts +
        # t` when an instance enters it; a matching absent-stream event
        # kills the instance and the timer step fires it once the
        # deadline passes
        self.deadline_w: List[Optional[int]] = []
        for n in nodes:
            w = None
            for sp in n.specs:
                if sp.is_absent and sp.waiting_ms is not None:
                    w = int(sp.waiting_ms)
            self.deadline_w.append(w)
        self.has_deadlines = any(w is not None for w in self.deadline_w)
        self._check_host_only_shapes()
        self.alloc = RegAllocator()
        self._compile_filters(stream_to_ref)
        self._compile_outputs(select_vars, stream_to_ref, select_names)
        # capture slots each node writes, after both filter and output
        # compilation so select-only slots get written too
        self.node_writes: List[List[RegSlot]] = [
            [slot for (ref, _a, _l), slot in self.alloc.slots.items()
             if any(ref == spec.ref for spec in node.specs)]
            for node in nodes]
        absent_refs = {sp.ref for n in nodes for sp in n.specs if sp.is_absent}
        if any(ref in absent_refs for (ref, _a, _l) in self.alloc.slots):
            raise SiddhiAppCreationError(
                "dense NFA: filters/selects cannot reference an absent "
                "event (it never arrives) — host engine used")
        # the via-path models one capture and advance, so an open
        # count's successor must be a plain stream node
        for n, nxt in zip(nodes, nodes[1:]):
            if is_open_count(n) and not _plain(nxt):
                raise SiddhiAppCreationError(
                    "dense NFA: open-ended count followed by a "
                    "count/logical node needs the host engine")
        self.step_kind = route_dense_step(self)
        self._step_cache: Dict[str, Callable] = {}
        self._general_cache: Dict[str, Callable] = {}
        self._time_step: Optional[Callable] = None

    def check_kernels(self):
        """On a card, build and launch the probe kernel, raising
        ``KernelUnavailableError`` (which no fallback catches) when it
        fails.  Called once the engine has passed every check, so an
        app that falls back to the host pattern engine launches
        nothing."""
        if self.device.type == "cuda":
            ok, reason = probe.kernels_available(self.device)
            if not ok:
                raise KernelUnavailableError(reason)

    def _check_host_only_shapes(self):
        """The shapes the reference sends to its host engine (its
        constructor's refusals, with its wording): optional counts, and
        absent states in sequences or where the dense step cannot model
        them.  The constructor adds absent refs in filters or selects and
        an open count followed by a count or logical node."""
        nodes, every_start = self.nodes, self.every_start
        for ni, n in enumerate(nodes):
            if n.kind == "stream" and n.min_count == 0:
                raise SiddhiAppCreationError(
                    "dense NFA does not support optional (min 0) states "
                    "yet; use the host engine")
            absent = [sp for sp in n.specs if sp.is_absent]
            if n.kind != "absent" and not absent:
                continue
            wait = None
            for sp in absent:
                if sp.waiting_ms is not None:
                    wait = int(sp.waiting_ms)
            if self.is_sequence:
                raise SiddhiAppCreationError(
                    "dense NFA: absent states in sequences (strict "
                    "continuity over a waiting state) need the host "
                    "engine")
            if n.kind == "absent" and wait is None:
                raise SiddhiAppCreationError(
                    "dense NFA: standalone absent node without a 'for' "
                    "duration needs the host engine")
            if ni == 0 and wait is not None:
                raise SiddhiAppCreationError(
                    "dense NFA: a leading absent 'for' deadline counts "
                    "from app start — host engine used")
            if wait is not None and wait > 2**23:
                raise SiddhiAppCreationError(
                    "dense NFA: absent 'for' durations above 2^23 ms would "
                    "overflow the int32 relative-time deadline — host "
                    "engine used")
            if n.kind == "logical":
                if n.logical_op == "or":
                    raise SiddhiAppCreationError(
                        "dense NFA: 'or' with an absent side needs the "
                        "host engine")
                if ({sp.stream_key for sp in n.specs if not sp.is_absent}
                        & {sp.stream_key for sp in absent}):
                    raise SiddhiAppCreationError(
                        "dense NFA: logical and-not over the SAME stream "
                        "(one event can both match and violate) needs the "
                        "host engine")
                if ni == 0 and every_start:
                    raise SiddhiAppCreationError(
                        "dense NFA: every-start logical and-not (violation "
                        "permanently kills the start state) needs the host "
                        "engine")

    # -- compilation --------------------------------------------------------

    def _compile_filters(self, stream_to_ref):
        """Per-node filters compiled against candidate columns."""
        self.node_filters: List[List[Optional[CompiledExpression]]] = []
        for node in self.nodes:
            fs = []
            for spec in node.specs:
                if spec.filter_compiled is None:
                    fs.append(None)
                    continue
                scope = DenseScope(self.ref_defs, stream_to_ref,
                                   spec.stream_def, self.alloc,
                                   cand_ref=spec.ref)
                try:
                    fs.append(DenseExprCompiler(scope).compile(
                        spec.raw_filter))
                except DeviceUncompilableError as e:
                    # what the reference compiles to numpy closures
                    # (``is null``, functions) and then fails to trace
                    fs.append(_untraceable(e))
            self.node_filters.append(fs)

    def _compile_outputs(self, select_vars: List[Variable], stream_to_ref,
                         select_names=None):
        """Selector variables -> (slot | ('cand', attr)) extractors.

        Output names use the query's `as` aliases when provided."""
        self.out_spec: List[Tuple[str, object]] = []
        self.out_int: List[bool] = []  # integer (hi/lo pair) output lane?
        # each output's declared type and its numpy dtype (the engine
        # computes in float32; callbacks keep the source types)
        self.out_types: List[AttrType] = []
        last_node = self.nodes[-1]
        last_refs = {s.ref for s in last_node.specs}
        for vi, var in enumerate(select_vars):
            ref = var.stream_id
            if ref not in self.ref_defs and ref in stream_to_ref:
                ref = stream_to_ref[ref]
            if ref is None or ref not in self.ref_defs:
                raise SiddhiAppCreationError(f"cannot resolve select ref '{var.stream_id}'")
            idx = var.stream_index
            name = (
                select_names[vi]
                if select_names and vi < len(select_names)
                else f"{ref}.{var.attribute}"
            )
            d = self.ref_defs[ref]
            if var.attribute not in d.attribute_names:
                raise SiddhiAppCreationError(
                    f"select ref '{ref}.{var.attribute}': no such attribute")
            attr_type = d.attribute_type(var.attribute)
            integer = attr_type in _INT_TYPES
            self.out_types.append(attr_type)
            if ref in last_refs and last_node.kind == "stream" and last_node.max_count == 1:
                # final event: values come from the candidate columns
                self.out_spec.append((name, ("cand", var.attribute)))
                self.out_int.append(integer)
                continue
            if idx not in (None, 0, -1):
                raise SiddhiAppCreationError(
                    f"dense NFA supports only first/[0]/[last] select refs, got {idx}"
                )
            slot = self.alloc.slot(ref, var.attribute, idx == -1, integer=integer)
            self.out_spec.append((name, slot))
            self.out_int.append(integer)
        self.out_dtypes = [t.np_dtype for t in self.out_types]

    # -- state --------------------------------------------------------------

    def state_layout(self) -> Dict[str, Tuple[Tuple[int, ...], np.dtype]]:
        """Shape and numpy dtype of each state tensor (scratch row P
        included), as in the JAX engine's ``init_state_host``."""
        P, S, I = self.n_partitions + 1, self.S, self.I
        layout = {
            "active": ((P, S, I), np.dtype(bool)),
            "first_ts": ((P, S, I), np.dtype(np.int32)),
            "counts": ((P, S, I), np.dtype(np.int32)),
            "regs": ((P, S, I, max(self.alloc.n, 1)), np.dtype(np.float32)),
            "overflow": ((P,), np.dtype(np.int32)),
        }
        if self.alloc.n_int:
            # integer capture bank: a hi/lo int32 pair per slot
            layout["iregs"] = ((P, S, I, 2 * self.alloc.n_int),
                               np.dtype(np.int32))
        if self.has_deadlines:
            # absent deadlines, relative ms (0 = unset)
            layout["deadline"] = ((P, S, I), np.dtype(np.int32))
        return layout

    def init_state_host(self, n_rows: Optional[int] = None
                        ) -> Dict[str, np.ndarray]:
        """Initial state as numpy arrays, in the JAX engine's layout: all
        zero, but a non-every head arms node 0 once per partition (lane
        0), which a match's reset clears for good.  ``n_rows``: that many
        init rows instead of the whole state (a purge's template)."""
        state = {k: np.zeros(shape if n_rows is None
                             else (n_rows,) + shape[1:], dt)
                 for k, (shape, dt) in self.state_layout().items()}
        if not self.every_start:
            state["active"][:, 0, 0] = True
        return state

    def init_state(self, n_rows: Optional[int] = None,
                   device=None) -> Dict[str, torch.Tensor]:
        """Initial state on the engine's device (``init_state_host``),
        built there; ``n_rows``/``device``: that many rows on another
        device (a shard of ``parallel.mesh.ShardedPatternEngine``)."""
        dev = self.device if device is None else device
        state = {
            k: torch.zeros(shape if n_rows is None
                           else (n_rows,) + shape[1:],
                           dtype=_TORCH_DTYPES[dt], device=dev)
            for k, (shape, dt) in self.state_layout().items()
        }
        if not self.every_start:
            state["active"][:, 0, 0] = True
        return state

    # the state surface a DensePatternRuntime drives, which
    # parallel.mesh.ShardedPatternEngine mirrors for a sharded state

    @property
    def n_state_rows(self) -> int:
        """Rows of the whole state: the partitions and the scratch row."""
        return self.n_partitions + 1

    @staticmethod
    def deal_rows(ids: np.ndarray) -> np.ndarray:
        """Allocation-counter ids -> partition rows: the same here."""
        return ids

    def state_to_host(self, state) -> Dict[str, np.ndarray]:
        return state_to_numpy(self, state)[0]

    def state_from_host(self, host_state: Dict, base_ts: Optional[int]):
        rows = len(next(iter(host_state.values())))
        if rows != self.n_state_rows:
            raise SiddhiAppRuntimeError(
                f"cannot restore: snapshot has {rows} state rows but "
                f"this app needs {self.n_state_rows} (snapshot taken under "
                "a different @app:execution devices/partitions setting)")
        return state_from_numpy(self, host_state, base_ts)

    def live_state(self, state) -> Dict[str, torch.Tensor]:
        """The snapshot layout as the live device tensors."""
        return {k: state[k] for k in self.state_layout()}

    @staticmethod
    def overflow_sum(state) -> torch.Tensor:
        """Dropped instances of every row, a 0-d device tensor."""
        return state["overflow"].sum()

    def active_sum(self, state, rows: np.ndarray) -> torch.Tensor:
        """Pending lanes of ``rows``, a 0-d device tensor."""
        return state["active"][torch.as_tensor(rows,
                                               device=self.device)].sum()

    def reset_rows(self, state, rows: np.ndarray, ingest_stats=None):
        """``rows`` back to the initial row (a purge), in place; every
        init row is the same, so one row is the template."""
        idx, tmpl = staged_put((rows, self.init_state_host(n_rows=1)),
                               self.device, ingest_stats)
        for key, arr in state.items():
            arr[idx] = tmpl[key]

    # -- step ---------------------------------------------------------------

    def make_step(self, stream_key: str) -> Callable:
        """The packed step for one collision round of one source stream
        (see ``kernels/dense_step.build_packed_nfa`` for its signature):
        the interface-level twin of the JAX package's step.  Off the main
        path: ``process_deferred`` runs ``batch_step``.  It holds at most
        ``dense_step.MAX_INSTANCES`` (16) instance lanes per node."""
        if self.I > PACKED_MAX_INSTANCES:
            raise ValueError(
                f"make_step: the packed step holds at most "
                f"{PACKED_MAX_INSTANCES} instance lanes per node, this engine "
                f"has {self.I}; process() runs the batch step, which holds "
                f"{MAX_INSTANCES}")
        if self.step_kind != "batch":
            raise ValueError(
                "make_step: the packed step covers capture-free "
                "every-chains only; this engine runs the general step "
                "(make_general_step)")
        fn = self._step_cache.get(stream_key)
        if fn is None:
            fn = build_packed_nfa(self, stream_key)
            self._step_cache[stream_key] = fn
        return fn

    def make_general_step(self, stream_key: str) -> Callable:
        """The general dense step for one collision round of one source
        stream: the JAX package's ``DensePatternEngine.make_step`` with
        ``use_kernel = False`` (``siddhi_tpu/ops/dense_nfa.py:610``, step
        body ``:695-1238``) in torch ops, for every class the router
        sends here: plain, counting and logical (``and``/``or``) nodes;
        every, non-every and whole-chain group-every heads; patterns and
        strict-contiguity sequences; an optional ``within``; float and
        integer captures, first/[0]/[last] refs; any lane count; reset on
        emit; absent nodes and ``and not`` sides: a matching event kills
        the instances pending there (deadline completion runs in
        ``make_time_step``), and entering a node with an absent ``for``
        spec arms its deadline to the event's time plus the wait.

        step(state, part_idx [B] int, cols {key: [B]}, ts [B] int32
             relative ms, valid [B] bool)
          -> (state, emit [B, 2I] bool,
              {"f": [B, 2I, O] float32, "i": [B, 2I, 2*n_int_out] int32},
              emit_anchor [B, 2I] int32, n_emit int32 0-d)

        Valid rows must name distinct partitions (one collision round).
        The step gathers their state rows, steps them and writes them
        back in place; the gathered ``[B, S, I]`` rows are private copies,
        so they are updated in place node slice by node slice.
        ``counts`` is the capture count at a count node and the bitmask
        of matched sides at a logical node; ``deadline`` rides beside
        them when the engine has absent ``for`` specs.  Emit bank 0 (lanes
        ``[0, I)``) takes instances completing at the last node; bank 1
        (``[I, 2I)``) the via-path's clones, a dually pending open count
        passing straight through the last node on the same event."""
        fn = self._general_cache.get(stream_key)
        if fn is not None:
            return fn
        S, I = self.S, self.I
        nodes, node_filters, slots = (self.nodes, self.node_filters,
                                      list(self.alloc.slots.values()))
        within, every_start = self.within_ms, self.every_start
        group_every, is_sequence = self.group_every, self.is_sequence
        reset_on_emit = self.reset_on_emit
        out_spec = self.out_spec
        O = max(len(out_spec), 1)
        # out-spec position -> index into the integer output pairs
        int_out = [oi for oi, is_int in enumerate(self.out_int) if is_int]
        int_out_idx = {oi: k for k, oi in enumerate(int_out)}
        # the present specs of each node this stream feeds, and its
        # absent specs, whose matching events kill
        sides = [[si for si, sp in enumerate(node.specs)
                  if sp.stream_key == stream_key and not sp.is_absent]
                 for node in nodes]
        kills = [[si for si, sp in enumerate(node.specs)
                  if sp.stream_key == stream_key and sp.is_absent]
                 for node in nodes]
        deadline_w = self.deadline_w
        # the slots each spec captures into
        writes = [[[slot for slot in self.node_writes[s] if slot.ref == sp.ref]
                   for sp in node.specs] for s, node in enumerate(nodes)]
        # a dually pending open count at s-1 clones through node s
        via = [s >= 1 and is_open_count(nodes[s - 1]) for s in range(S)]
        stream_def = self._stream_def(stream_key)
        filtered = any(node_filters[s][si] is not None
                       for s in range(S) for si in sides[s] + kills[s])
        slots_f = any(not slot.integer for slot in slots)

        def eval_ok(s, si, cand, fregs, iregs, B, rn=None):
            """Spec ``si`` of node ``s``'s filter over ``[B, I]`` lanes
            against node ``rn``'s registers (default ``s``; the via-path
            reads the dually pending source's at ``s - 1``).  ``cand``:
            this stream's candidate env; ``fregs``: the float register
            file as filters read it."""
            f = node_filters[s][si]
            if f is None:
                return torch.ones((B, I), dtype=torch.bool,
                                  device=fregs.device)
            rn = s if rn is None else rn
            env = filter_env(cand, slots, fregs[:, rn],
                             None if iregs is None else iregs[:, rn])
            return torch.as_tensor(f.fn(env), device=fregs.device).to(
                torch.bool).broadcast_to((B, I))

        def step(state, part_idx, cols, ts, valid):
            B = part_idx.shape[0]
            dev = ts.device
            pi = part_idx.long()
            a = state["active"][pi]        # [B, S, I] bool
            first = state["first_ts"][pi]  # [B, S, I] int32
            counts = state["counts"][pi]   # [B, S, I] int32
            regs = state["regs"][pi]       # [B, S, I, R] float32
            iregs = state["iregs"][pi] if "iregs" in state else None
            ovf = state["overflow"][pi]    # [B] int32
            dl = state["deadline"][pi] if "deadline" in state else None
            t = ts[:, None]
            emit = torch.zeros((B, 2 * I), dtype=torch.bool, device=dev)
            out_f = torch.zeros((B, 2 * I, O), dtype=torch.float32, device=dev)
            out_i = torch.zeros((B, 2 * I, 2 * len(int_out)),
                                dtype=torch.int32, device=dev)
            emit_anchor = torch.zeros((B, 2 * I), dtype=torch.int32,
                                      device=dev)

            # within-window expiry (int32 wrap-around subtraction, as in
            # the reference step): active bits, counts and side masks
            if within is not None:
                expired = (first > 0) & ((ts[:, None, None] - first) > within)
                a &= ~expired
                counts.masked_fill_(expired, 0)
                first.masked_fill_(expired, 0)
                if dl is not None:
                    dl.masked_fill_(expired, 0)

            # group-every: the fresh arm forms only while the partition
            # has no active instance (after expiry, before the event)
            if group_every:
                grp_ok = ~a.reshape(B, -1).any(dim=1, keepdim=True)

            # node filters once, against the entry-state registers (the
            # reversed loop reads them before any write of this step); a
            # logical node holds one per spec; None: not this stream.
            # Filters read subnormals as zeros: the candidate columns and
            # the register file are flushed once here (the via-path reads
            # node s-1's registers, which no write before it touches)
            vb = valid[:, None]
            cand = candidate_env(stream_def, cols, ts) if filtered else None
            fregs = flush_subnormals(regs) if slots_f else regs
            ok = []
            for s, node in enumerate(nodes):
                oks = [eval_ok(s, si, cand, fregs, iregs, B) & vb
                       if si in sides[s] or si in kills[s] else None
                       for si in range(len(node.specs))]
                ok.append(oks if node.kind == "logical" else oks[0])

            if is_sequence:
                # strict continuity: a pending instance whose node cannot
                # use this event dies before the advance pass (the start
                # node stays armed)
                for s in range(1, S):
                    m = [o for o in (ok[s] if isinstance(ok[s], list)
                                     else [ok[s]]) if o is not None]
                    kill = a[:, s] & vb
                    for o in m:
                        kill &= ~o
                    a[:, s] &= ~kill
                    counts[:, s].masked_fill_(kill, 0)
                    first[:, s].masked_fill_(kill, 0)

            def capture(fbank, ibank, slot, upd):
                """The event into one register slot of ``fbank [B, I, R]``
                / ``ibank [B, I, 2*RI]`` for the lanes in ``upd``."""
                if slot.integer:
                    hk, lk = f"{slot.attr}|hi", f"{slot.attr}|lo"
                    if hk in cols:
                        for j, key in ((2 * slot.index, hk),
                                       (2 * slot.index + 1, lk)):
                            ibank[:, :, j] = torch.where(
                                upd, cols[key][:, None], ibank[:, :, j])
                elif slot.attr in cols:
                    fbank[:, :, slot.index] = torch.where(
                        upd, cols[slot.attr].to(torch.float32)[:, None],
                        fbank[:, :, slot.index])

            def write_slot(s, slot, upd):
                capture(regs[:, s], None if iregs is None else iregs[:, s],
                        slot, upd)

            def emit_rows(mask, anchor, src_regs, src_iregs, bank=0):
                """Instances in ``mask`` complete the chain on this event
                (bank 0: at the last node; bank 1: via-path clones)."""
                sl = slice(bank * I, (bank + 1) * I)
                emit[:, sl] |= mask
                emit_anchor[:, sl] = torch.where(mask, anchor,
                                                 emit_anchor[:, sl])
                for oi, (_name, src) in enumerate(out_spec):
                    ii = int_out_idx.get(oi)
                    if isinstance(src, tuple):  # ('cand', attr): this event
                        keys = ((f"{src[1]}|hi", f"{src[1]}|lo")
                                if ii is not None else (src[1],))
                        if keys[0] not in cols:
                            continue
                        vals = [cols[k][:, None] for k in keys]
                    elif ii is not None:
                        vals = [src_iregs[:, :, 2 * src.index + j]
                                for j in (0, 1)]
                    else:
                        vals = [src_regs[:, :, src.index]]
                    obank, at = ((out_i, (2 * ii, 2 * ii + 1))
                                 if ii is not None else (out_f, (oi,)))
                    for c, val in zip(at, vals):
                        obank[:, sl, c] = torch.where(mask, val,
                                                      obank[:, sl, c])

            def place(tgt, mask, anchor, src_regs, src_iregs):
                """Move the instances in ``mask`` into free lanes of node
                ``tgt`` (rank-matched, overflow counted); a target with an
                absent ``for`` spec arms its deadline to this event's
                time plus the wait."""
                nonlocal ovf
                w = deadline_w[tgt]
                entry_dl = None if w is None else (t + w).expand(B, I)
                ovf = _rank_place(tgt, mask, anchor, src_regs, src_iregs,
                                  entry_dl, a, first, counts, regs, iregs, dl,
                                  ovf, upto)

            def anchor_of(s):
                return torch.where(first[:, s] > 0, first[:, s], t)

            def advance(s, mask):
                """Lanes of node ``s`` in ``mask`` complete it: emit at
                the last node, else move into free lanes of node s+1."""
                src_iregs = None if iregs is None else iregs[:, s]
                if s == S - 1:
                    emit_rows(mask, anchor_of(s), regs[:, s], src_iregs)
                else:
                    place(s + 1, mask, anchor_of(s), regs[:, s], src_iregs)

            lanes = torch.arange(I, device=dev)
            lane0 = lanes == 0
            upto = lanes[None, :] <= lanes[:, None]  # [i, j]: j <= i

            def kill(s, viol):
                """A matching absent-stream event kills the instances in
                ``viol`` pending at node ``s``."""
                a[:, s] &= ~viol
                counts[:, s].masked_fill_(viol, 0)
                first[:, s].masked_fill_(viol, 0)
                if dl is not None:
                    dl[:, s].masked_fill_(viol, 0)

            for s in reversed(range(S)):
                node = nodes[s]
                if node.kind == "absent":
                    # completion at the deadline is the timer step's
                    if kills[s]:
                        kill(s, a[:, s] & ok[s])
                    continue
                if not sides[s] and not kills[s]:
                    continue
                if node.kind == "logical":
                    # sides ride bits of counts; an already matched side
                    # ignores further events; `or` takes only the first
                    # matching side, `and` lets one event fill both
                    pending = a[:, s]
                    if s == 0 and every_start:
                        pending = pending | lane0  # the lane-0 virgin
                    for si in kills[s]:
                        # `and not`: the absent side arriving kills the
                        # armed lanes (an every-start `and not` is refused,
                        # so no virgin meets a kill)
                        viol = a[:, s] & ok[s][si]
                        kill(s, viol)
                        pending = pending & ~viol
                    matched_now = None
                    for si in sides[s]:
                        bit = 1 << si
                        fire = pending & ok[s][si] & ((counts[:, s] & bit) == 0)
                        if node.logical_op == "or" and matched_now is not None:
                            fire &= ~matched_now
                        matched_now = (fire if matched_now is None
                                       else matched_now | fire)
                        counts[:, s] |= fire.to(torch.int32) * bit
                        for slot in writes[s][si]:
                            write_slot(s, slot, fire)
                        first[:, s] = torch.where(
                            fire & (first[:, s] == 0), t, first[:, s])
                    if matched_now is None:
                        continue  # no present side on this stream
                    # completion needs a side matched on this event, then
                    # every present side (`and`) or any (`or`); `and not
                    # B for t` also needs its deadline passed (or
                    # consumed by the timer)
                    pmask = _present_mask(node)
                    need = counts[:, s] & pmask
                    done = (need == pmask if node.logical_op == "and"
                            else need > 0)
                    complete = done & matched_now
                    if deadline_w[s] is not None:
                        dls = dl[:, s]
                        complete &= (dls == 0) | (t >= dls)
                    advance(s, complete)
                    # a completed logical node releases its lane
                    a[:, s] &= ~complete
                    counts[:, s].masked_fill_(complete, 0)
                    first[:, s].masked_fill_(complete, 0)
                    if deadline_w[s] is not None:
                        dl[:, s].masked_fill_(complete, 0)
                    continue
                is_count = not _plain(node)
                pending = a[:, s]
                if s == 0 and every_start:
                    if is_count:
                        # a fresh virgin arms only while no unsatisfied
                        # count exists, in the first free lane; one that
                        # should arm but finds no free lane is dropped
                        # and counted
                        c0 = counts[:, 0]
                        unsat = (a[:, 0] & (c0 > 0)
                                 & (c0 < max(node.min_count, 1)))
                        armable = ~unsat.any(dim=1, keepdim=True)
                        free0 = ~a[:, 0] & (c0 == 0)
                        virgin = free0 & (_lane_rank(free0, upto) == 0) & armable
                        pending = pending | virgin
                        no_lane = (armable[:, 0] & ~free0.any(dim=1)
                                   & ok[s][:, 0])
                        ovf = ovf + no_lane.to(torch.int32)
                    elif group_every:
                        pending = pending | (lane0 & grp_ok)
                    else:
                        # the standing virgin fires through lane 0 on
                        # every event
                        pending = pending | lane0
                fire = pending & ok[s]
                if is_count:
                    cs = counts[:, s]
                    cap = (fire if node.max_count == _ANY
                           else fire & (cs < node.max_count))
                    first_cap = cap & (cs == 0)
                    cs += cap.to(torch.int32)
                    # a counting lane is occupied from its first capture
                    a[:, s] |= first_cap
                    for slot in writes[s][0]:
                        write_slot(s, slot, cap if slot.last else first_cap)
                    first[:, s] = torch.where(
                        first_cap & (first[:, s] == 0), t, first[:, s])
                    open_count = is_open_count(node)
                    if not open_count or s == S - 1:
                        # an exact count moves at min == max; a count on
                        # the last node emits once, at satisfaction
                        advance(s, cap & (cs == max(node.min_count, 1)))
                    if node.max_count != _ANY:
                        # at max an exact count is spent (its advance
                        # placed it); an open count moves its pending
                        # instance on; every count releases its lane
                        at_max = cap & (cs >= node.max_count)
                        if open_count and s < S - 1:
                            place(s + 1, at_max, anchor_of(s), regs[:, s],
                                  None if iregs is None else iregs[:, s])
                        a[:, s] &= ~at_max
                        cs.masked_fill_(at_max, 0)
                        first[:, s].masked_fill_(at_max, 0)
                    continue
                for slot in writes[s][0]:
                    write_slot(s, slot, fire)
                if s == 0 and every_start:
                    # fresh arming each event: the anchor is this event's
                    first[:, s] = torch.where(fire, t, first[:, s])
                else:
                    first[:, s] = torch.where(fire & (first[:, s] == 0), t,
                                              first[:, s])
                    # only `every` keeps the start armed
                    a[:, s] &= ~fire
                advance(s, fire)
                if not via[s]:
                    continue
                # via-path: a satisfied, still pending open count at s-1
                # clones straight through this node on the same event,
                # capturing into a copy of its own registers, and is
                # consumed (forward once)
                prev = nodes[s - 1]
                cp = counts[:, s - 1]
                sat = a[:, s - 1] & (cp >= max(prev.min_count, 1))
                if prev.max_count != _ANY:
                    sat &= cp < prev.max_count
                fire_via = sat & eval_ok(s, 0, cand, fregs, iregs, B,
                                         rn=s - 1) & vb
                via_regs = regs[:, s - 1].clone()
                via_iregs = None if iregs is None else iregs[:, s - 1].clone()
                for slot in writes[s][0]:
                    capture(via_regs, via_iregs, slot, fire_via)
                if s == S - 1:
                    emit_rows(fire_via, anchor_of(s - 1), via_regs, via_iregs,
                              bank=1)
                else:
                    place(s + 1, fire_via, anchor_of(s - 1), via_regs,
                          via_iregs)
                a[:, s - 1] &= ~fire_via
                cp.masked_fill_(fire_via, 0)
                first[:, s - 1].masked_fill_(fire_via, 0)

            if reset_on_emit:
                hit = emit.any(dim=1)[:, None, None]
                a &= ~hit
                counts.masked_fill_(hit, 0)
                first.masked_fill_(hit, 0)
                if dl is not None:
                    dl.masked_fill_(hit, 0)

            # scatter back (valid rows only)
            v3 = valid[:, None, None]
            for key, rows, vmask in (("active", a, v3), ("first_ts", first, v3),
                                     ("counts", counts, v3),
                                     ("regs", regs, v3[..., None]),
                                     ("iregs", iregs, v3[..., None]),
                                     ("deadline", dl, v3),
                                     ("overflow", ovf, valid)):
                if rows is not None:
                    state[key][pi] = torch.where(vmask, rows, state[key][pi])
            n_emit = (emit & vb).sum(dtype=torch.int32)
            return state, emit, {"f": out_f, "i": out_i}, emit_anchor, n_emit

        self._general_cache[stream_key] = step
        return step

    # -- timer step (absent deadlines) ---------------------------------------

    def make_time_step(self) -> Callable:
        """The deadline-timer step of an engine with absent states: the
        JAX package's ``make_time_step`` (``siddhi_tpu/ops/dense_nfa.py
        :1246-1376``) in torch ops.

        time_step(state, now int relative ms)
          -> (state, emit [P+1, I] bool, {"f": [P+1, I, O] float32,
              "i": [P+1, I, 2*n_int_out] int32}, fire [P+1, I] int32,
              n_emit int32 0-d)

        It runs over every state row (no gather) and writes the state
        tensors in place: ``within`` expiry first; then, node by node in
        descending order (a fire placing into node s+1 cannot fire again
        this tick), the lanes whose deadline has passed (``active``,
        ``deadline > 0``, ``now >= deadline``).  At a logical node they
        complete only if every present side has matched, and the deadline
        is consumed either way.  At the last node they emit, their
        outputs from the node's registers (selects never read the absent
        event); elsewhere they move into free lanes of node s+1, arming
        its deadline from the fire time.  ``fire[p, i]`` is the deadline
        an instance fired at, the match's timestamp.  Then reset on
        emit."""
        if self._time_step is not None:
            return self._time_step
        S, I = self.S, self.I
        nodes, within = self.nodes, self.within_ms
        deadline_w, reset_on_emit = self.deadline_w, self.reset_on_emit
        out_spec, out_int = self.out_spec, self.out_int
        O = max(len(out_spec), 1)
        n_iout = sum(out_int)

        def time_step(state, now: int):
            a, first, counts = state["active"], state["first_ts"], state["counts"]
            regs, iregs = state["regs"], state.get("iregs")
            dl = state["deadline"]
            ovf = state["overflow"]
            Pr, dev = a.shape[0], a.device
            emit = torch.zeros((Pr, I), dtype=torch.bool, device=dev)
            out_f = torch.zeros((Pr, I, O), dtype=torch.float32, device=dev)
            out_i = torch.zeros((Pr, I, 2 * n_iout), dtype=torch.int32,
                                device=dev)
            fire = torch.zeros((Pr, I), dtype=torch.int32, device=dev)
            lanes = torch.arange(I, device=dev)
            upto = lanes[None, :] <= lanes[:, None]

            # an instance that ran out of its within window never fires
            if within is not None:
                expired = (first > 0) & ((now - first) > within)
                a &= ~expired
                counts.masked_fill_(expired, 0)
                first.masked_fill_(expired, 0)
                dl.masked_fill_(expired, 0)

            for s in reversed(range(S)):
                if deadline_w[s] is None:
                    continue
                node = nodes[s]
                dls = dl[:, s]
                due = a[:, s] & (dls > 0) & (now >= dls)
                ft = dls.clone()  # the fire times, read before consumed
                if node.kind == "logical":
                    pmask = _present_mask(node)
                    fire_mask = due & ((counts[:, s] & pmask) == pmask)
                else:
                    fire_mask = due
                dls.masked_fill_(due, 0)
                anchor = torch.where(first[:, s] > 0, first[:, s], ft)
                if s == S - 1:
                    emit |= fire_mask
                    fire = torch.where(fire_mask, ft, fire)
                    ii = 0
                    for oi, (_name, src) in enumerate(out_spec):
                        if out_int[oi]:
                            for j in (0, 1):
                                out_i[:, :, 2 * ii + j] = torch.where(
                                    fire_mask, iregs[:, s, :, 2 * src.index + j],
                                    out_i[:, :, 2 * ii + j])
                            ii += 1
                        else:
                            out_f[:, :, oi] = torch.where(
                                fire_mask, regs[:, s, :, src.index],
                                out_f[:, :, oi])
                else:
                    w2 = deadline_w[s + 1]
                    ovf = _rank_place(
                        s + 1, fire_mask, anchor, regs[:, s],
                        None if iregs is None else iregs[:, s],
                        None if w2 is None else ft + w2,
                        a, first, counts, regs, iregs, dl, ovf, upto)
                a[:, s] &= ~fire_mask
                counts[:, s].masked_fill_(fire_mask, 0)
                first[:, s].masked_fill_(fire_mask, 0)

            if reset_on_emit:
                hit = emit.any(dim=1)[:, None, None]
                a &= ~hit
                counts.masked_fill_(hit, 0)
                first.masked_fill_(hit, 0)
                dl.masked_fill_(hit, 0)
            if ovf is not state["overflow"]:
                state["overflow"].copy_(ovf)
            n_emit = emit.sum(dtype=torch.int32)
            return state, emit, {"f": out_f, "i": out_i}, fire, n_emit

        self._time_step = time_step
        return time_step

    def next_wakeup_state(self, state) -> Optional[int]:
        """Earliest armed absent deadline (absolute ms), or None: one
        reduction over the state and one scalar to the host.  Engines
        without deadlines, and any before its first event, return None
        without touching the device."""
        if not self.has_deadlines or self.base_ts is None:
            return None
        return self.wakeup_from_mins(fetch_coalesced([self.wake_min(state)]))

    @staticmethod
    def wake_min(state) -> torch.Tensor:
        """The earliest armed deadline of ``state``'s rows as a 0-d device
        tensor (int32 max when none)."""
        dl = state["deadline"]
        return torch.where(state["active"] & (dl > 0), dl,
                           torch.iinfo(torch.int32).max).amin()

    def wakeup_from_mins(self, mins) -> Optional[int]:
        """Absolute ms of the earliest of fetched ``wake_min`` values."""
        m = int(min(int(x) for x in mins))
        if m >= 2**31 - 1:
            return None
        return self.base_ts + m

    def on_time_state(self, state, now: int):
        """Advance the deadline timers to absolute time ``now``.

        Returns ``(state, fired)``: ``fired`` is None (no instance fired)
        or ``(out [m, n_out], fire_ts [m] absolute ms, part_rows [m])``
        ordered by (fire time, partition row, lane), the reference's
        deadline-ordered flush.  The fires are compacted on the device
        (``nonzero`` on ``emit``, whose size is the count gate, then
        gathers) and fetched in one copy."""
        rel = self.timer_rel(now)
        if rel is None:
            return state, None
        state, mat = self.time_fires(state, rel)
        if mat is None:
            return state, None
        return state, self.fires_from_host(fetch_coalesced([mat]))

    def timer_rel(self, now: int) -> Optional[int]:
        """``now`` as relative ms for the timer step, or None when no
        deadline can be due."""
        if not self.has_deadlines or self.base_ts is None:
            return None
        rel = now - self.base_ts
        if rel <= 0:
            return None
        return min(rel, 2**31 - 1)

    def time_fires(self, state, rel: int, row0: int = 0):
        """Run the timer step over ``state``'s rows at relative ``rel``
        and compact its fires on the device: ``(state, mat)``, ``mat``
        one int32 matrix a fire (row + ``row0``, lane, fire time, the
        float outputs' bits, the integer outputs), or None when nothing
        fired (``nonzero`` on ``emit``, whose size is the count gate)."""
        state, emit, outs, fire, _n = self.make_time_step()(state, rel)
        rows_d, lanes_d = emit.nonzero(as_tuple=True)
        if rows_d.numel() == 0:
            return state, None
        return state, torch.cat([
            (rows_d.to(torch.int32) + row0)[:, None],
            lanes_d.to(torch.int32)[:, None],
            fire[rows_d, lanes_d][:, None],
            outs["f"][rows_d, lanes_d].view(torch.int32),
            outs["i"][rows_d, lanes_d]], dim=1)

    def fires_from_host(self, mats):
        """Fetched ``time_fires`` matrices -> ``(out, fire_ts, rows)`` in
        (fire time, row, lane) order."""
        host = np.concatenate(mats) if len(mats) > 1 else mats[0]
        O = max(len(self.out_spec), 1)
        rows = host[:, 0].astype(np.int64)
        lanes = host[:, 1]
        out = self.assemble_rows(np.ascontiguousarray(host[:, 3:3 + O])
                                 .view(np.float32), host[:, 3 + O:])
        fire_np = host[:, 2].astype(np.int64) + self.base_ts
        order = np.lexsort((lanes, rows, fire_np))
        return out[order], fire_np[order], rows[order]

    # -- host wrapper -------------------------------------------------------

    def rel_ts64(self, ts: np.ndarray) -> np.ndarray:
        if self.base_ts is None:
            self.base_ts = int(ts[0]) - 1 if len(ts) else 0
        return ts - self.base_ts

    def maybe_re_anchor(self, state, rel64: np.ndarray):
        """Shift ``base_ts`` forward when relative timestamps approach the
        int32 range.  ``first_ts`` anchors and armed deadlines shift with
        it; instances whose anchor falls outside the ``within`` horizon
        are already expired and are cleared on the host (a
        once-per-24-days round trip)."""
        delta = self.re_anchor_delta(rel64)
        if delta is None:
            return state, rel64
        return self.shift_state(state, delta, self.device), rel64 - delta

    def re_anchor_delta(self, rel64: np.ndarray) -> Optional[int]:
        """The forward shift of ``base_ts`` that keeps ``rel64`` inside
        int32 (``base_ts`` moves by it), or None when none is due."""
        if not len(rel64) or int(rel64.max()) < self._REL_LIMIT:
            return None
        horizon = self.within_ms or 0
        delta = int(rel64.min()) - 1 - horizon
        if delta <= 0 or int(rel64.max()) - delta >= 2**31:
            raise SiddhiAppRuntimeError(
                "dense NFA: timestamp span of one batch plus the within "
                "horizon exceeds the int32 relative-time range")
        self.base_ts += delta
        return delta

    def shift_state(self, state, delta: int, device):
        """``state``'s anchors re-expressed against a base moved forward
        by ``delta``, put back on ``device``."""
        keys = ["first_ts", "active", "counts"]
        if "deadline" in state:
            keys.append("deadline")
        first, active, counts, *dlv = fetch_coalesced(
            [state[k] for k in keys])
        first = first.astype(np.int64)  # [P, S, I]
        shifted = np.where(first > 0, first - delta, 0)
        if self.within_ms is not None:
            # anchors at/below the new zero were expired before the shift
            dead = (first > 0) & (shifted <= 0)
            if dead.any():
                active[dead] = False
                counts[dead] = 0
                shifted = np.where(dead, 0, shifted)
        else:
            # no within: anchors are inert, clamp to stay "set" (>0)
            shifted = np.where(first > 0, np.maximum(shifted, 1), 0)
        host = [shifted.astype(np.int32), active, counts]
        if dlv:
            # armed deadlines shift with the base; one at or below the new
            # zero clamps to 1 (long overdue: it fires on the next tick,
            # where the unshifted value pointed too)
            d = dlv[0].astype(np.int64)
            host.append(np.where(d > 0, np.maximum(d - delta, 1), 0)
                        .astype(np.int32))
        state = dict(state)
        state.update(zip(keys, staged_put(tuple(host), device,
                                          self.ingest_stats)))
        return state

    def shift_row_ts(self, rows: Dict[str, np.ndarray],
                     delta: int) -> Dict[str, np.ndarray]:
        """Host state rows re-expressed against a base shifted by
        ``delta`` (new base = old base + delta), either way.  The
        multiplex group shares one ``base_ts`` over its tenants: a tenant
        snapshot taken under another anchor, or a tenant whose events
        predate the group's anchor (a shift down, ``delta < 0``),
        rewrites the ``first_ts`` and ``deadline`` anchors as
        :meth:`maybe_re_anchor` does: a forward shift expires the
        instances that leave the ``within`` horizon (or clamps inert
        anchors to stay set), a backward one only grows the values,
        within int32.  ``rows`` are numpy arrays; nothing touches the
        device here."""
        out = dict(rows)
        first = rows["first_ts"].astype(np.int64)
        shifted = np.where(first > 0, first - delta, 0)
        if int(shifted.max(initial=0)) >= 2**31:
            raise SiddhiAppRuntimeError(
                "dense NFA: timestamp shift exceeds the int32 "
                "relative-time range")
        if delta > 0:
            if self.within_ms is not None:
                dead = (first > 0) & (shifted <= 0)
                if dead.any():
                    active = rows["active"].copy()
                    counts = rows["counts"].copy()
                    active[dead] = False
                    counts[dead] = 0
                    shifted = np.where(dead, 0, shifted)
                    out["active"] = active
                    out["counts"] = counts
            else:
                shifted = np.where(first > 0, np.maximum(shifted, 1), 0)
        out["first_ts"] = shifted.astype(np.int32)
        if "deadline" in rows:
            dlv = rows["deadline"].astype(np.int64)
            dshift = np.where(dlv > 0, dlv - delta, 0)
            if delta > 0:
                dshift = np.where(dlv > 0, np.maximum(dshift, 1), 0)
            elif int(dshift.max(initial=0)) >= 2**31:
                raise SiddhiAppRuntimeError(
                    "dense NFA: timestamp shift exceeds the int32 "
                    "relative-time range")
            out["deadline"] = dshift.astype(np.int32)
        return out

    def process(self, state, stream_key: str, part_idx: np.ndarray,
                cols: Dict[str, np.ndarray], ts: np.ndarray):
        """Process a batch: each partition's events in batch order.

        Returns ``(state, match_ev_idx, match_out)``: one row per match,
        ``match_ev_idx[m]`` the batch-row index of the completing event
        (ascending; same-event matches ordered by arming age) and
        ``match_out[m, n_out]`` its output values."""
        state, pending = self.process_deferred(state, stream_key, part_idx,
                                               cols, ts)
        return state, *(pending or DeferredDenseEmit(self)).rows()

    def process_deferred(self, state, stream_key: str, part_idx: np.ndarray,
                         cols: Dict[str, np.ndarray], ts: np.ndarray,
                         trace=None):
        """Async-emit variant of :meth:`process`: the batch's match
        outputs stay on the device inside the returned
        :class:`DeferredDenseEmit` (None only for empty input); even the
        match counts stay device scalars until ``resolve()``.

        The batch step: one host sort by partition, one ``staged_put``,
        the filter matrix, one ``batch_step`` (the state rows change in
        place) and the output columns.  The general step: one
        ``staged_put``, then one ``make_general_step`` call per
        collision round on the device (see :meth:`_process_general`).
        ``trace``: the batch's sampled cycle token, which times the put
        (``ingest.put``) and each round's dispatch (``step.round``) and
        marks the stream before the put and after the last round
        (``step.device``)."""
        faults = self.faults
        if faults is not None:
            faults.check("step.dense")
        part_idx = np.asarray(part_idx)
        if len(part_idx) and (int(part_idx.min()) < 0
                              or int(part_idx.max()) >= self.n_partitions):
            raise SiddhiAppRuntimeError(
                f"partition ids must lie in [0, {self.n_partitions})")
        rel64 = self.rel_ts64(np.asarray(ts, dtype=np.int64))
        state, rel64 = self.maybe_re_anchor(state, rel64)
        n = len(part_idx)
        if n == 0:
            return state, None
        prepared = self.prepare_cols(stream_key, cols)
        if self.step_kind == "general":
            pending = self._process_general(
                state, stream_key, part_idx, prepared, rel64.astype(np.int32),
                trace)
        else:
            pending = DeferredDenseEmit(self)
            self.batch_chunk(pending, state, stream_key, part_idx, prepared,
                             rel64.astype(np.int32), self.device, np.arange(n),
                             trace)
        if trace is not None:
            trace.device_end(self.device)
        return state, pending

    def _put(self, x, device, trace):
        """``staged_put`` of a batch's inputs; a sampled cycle's
        ``trace`` marks the stream before it and times it."""
        if trace is None:
            return staged_put(x, device, self.ingest_stats, self.faults)
        trace.device_begin(device)
        t0 = trace.tracer.clock()
        out = staged_put(x, device, self.ingest_stats, self.faults)
        trace.detail(STAGE_INGEST_PUT, t0, trace.n_events)
        return out

    def batch_chunk(self, pending: "DeferredDenseEmit", state,
                    stream_key: str, part_idx: np.ndarray,
                    prepared: Dict[str, np.ndarray], rel: np.ndarray,
                    device, ridx: np.ndarray, trace=None):
        """One ``batch_step`` over ``state``'s rows (on ``device``): the
        batch sorted by partition on the host, staged in one put, its
        filter matrix, one launch and the output columns, added to
        ``pending`` as one part; ``ridx`` maps its events to the caller's
        batch rows; ``trace`` as in ``process_deferred``, and
        besides it times the sort (``ingest.segments``) and the dispatch
        of the filter matrix, the launch and the output columns
        (``step.launch``).  The engine's ``ingest_stats`` count the step
        from the host's segment arrays."""
        t0 = trace.tracer.clock() if trace is not None else 0.0
        order, seg_start, seg_part = partition_segments(part_idx)
        if trace is not None:
            trace.detail(STAGE_INGEST_SEGMENTS, t0, len(part_idx))
        stats = self.ingest_stats
        if stats is not None:
            stats.count_batch_step(seg_start)
        order, seg_start, seg_part, rel_d, cb = self._put(
            (order, seg_start, seg_part, rel, prepared), device, trace)
        t0 = trace.tracer.clock() if trace is not None else 0.0
        ok = self.filter_matrix(stream_key, cb, rel_d)
        emit, anchor, n_emit = batch_step(
            state, order, seg_start, seg_part, ok, rel_d, n_inst=self.I,
            within=self.within_ms)
        out_f, out_i = self.output_columns(cb, emit[:, :self.I])
        if trace is not None:
            trace.detail(STAGE_STEP_LAUNCH, t0, len(part_idx))
        pending.add(emit, out_f, out_i, anchor, n_emit, ridx)

    def _process_general(self, state, stream_key: str, part_idx: np.ndarray,
                         prepared: Dict[str, np.ndarray], rel: np.ndarray,
                         trace=None) -> "DeferredDenseEmit":
        """The general step over a batch's collision rounds (the
        reference's loop, ``siddhi_tpu/ops/dense_nfa.py:1591-1616``): the
        whole batch goes to the device in one put, laid out round after
        round, and each round is a slice of it.  One part a round; no
        value crosses to the host here.  ``trace`` as in
        ``process_deferred``."""
        order, bounds = _round_order(part_idx)
        batch = (part_idx.astype(np.int32), rel, prepared)
        if len(bounds) > 2:  # more than one round: lay the rounds out
            batch = (batch[0][order], rel[order],
                     {k: v[order] for k, v in prepared.items()})
        part_d, rel_d, cols_d = self._put(batch, self.device, trace)
        valid = torch.ones(len(part_idx), dtype=torch.bool, device=self.device)
        step = self.make_general_step(stream_key)
        pending = DeferredDenseEmit(self)
        for lo, hi in zip(bounds[:-1].tolist(), bounds[1:].tolist()):
            t_round = trace.tracer.clock() if trace is not None else 0.0
            state, emit, outs, anchor, n_emit = step(
                state, part_d[lo:hi], {k: v[lo:hi] for k, v in cols_d.items()},
                rel_d[lo:hi], valid[lo:hi])
            if trace is not None:
                trace.detail(STAGE_STEP_ROUND, t_round, hi - lo)
            pending.add(emit, outs["f"], outs["i"], anchor, n_emit,
                        order[lo:hi])
        return pending

    def filter_matrix(self, stream_key: str, cols: Dict[str, torch.Tensor],
                      ts: torch.Tensor) -> torch.Tensor:
        """``ok [N, S]`` bool on the device: node ``s``'s candidate filter
        for every event, False where the node reads another stream."""
        n = ts.shape[0]
        rows = []
        cenv = None  # one env for every node on this stream
        for node, fs in zip(self.nodes, self.node_filters):
            spec = node.specs[0]
            if spec.stream_key != stream_key:
                rows.append(torch.zeros(n, dtype=torch.bool,
                                        device=ts.device))
            elif fs[0] is None:
                rows.append(torch.ones(n, dtype=torch.bool, device=ts.device))
            else:
                if cenv is None:
                    cenv = candidate_env(spec.stream_def, cols, ts)
                okb = torch.as_tensor(fs[0].fn(cenv), device=ts.device)
                rows.append(okb.to(torch.bool).broadcast_to((n, 1))[:, 0])
        return torch.stack(rows, dim=1)

    def output_columns(self, cols: Dict[str, torch.Tensor],
                       emit0: torch.Tensor):
        """Output banks ``f [N, 2I, O]`` float32 and ``i [N, 2I, 2*n_int]``
        int32 of the batch step: the candidate's selects at the emitting
        lanes ``emit0 [N, I]`` of bank 0.  Bank 1 stays zero: its class
        has no counts, so no via-path."""
        n, I = emit0.shape
        dev = emit0.device
        O = max(len(self.out_spec), 1)
        out_f = torch.zeros((n, 2 * I, O), dtype=torch.float32, device=dev)
        out_i = torch.zeros((n, 2 * I, 2 * sum(self.out_int)),
                            dtype=torch.int32, device=dev)
        ii = 0
        for oi, ((_name, src), is_int) in enumerate(zip(self.out_spec,
                                                        self.out_int)):
            if is_int:
                hk, lk = f"{src[1]}|hi", f"{src[1]}|lo"
                if hk in cols:
                    out_i[:, :I, 2 * ii] = torch.where(
                        emit0, cols[hk][:, None], 0)
                    out_i[:, :I, 2 * ii + 1] = torch.where(
                        emit0, cols[lk][:, None], 0)
                ii += 1
                continue
            val = cols.get(src[1])
            if val is not None:
                out_f[:, :I, oi] = torch.where(
                    emit0, val.to(torch.float32)[:, None], 0.0)
        return out_f, out_i

    def assemble_rows(self, f: np.ndarray, i: np.ndarray) -> np.ndarray:
        """Match output rows from one output row each of the float bank
        (``f [m, O]``) and the integer bank (``i [m, 2*n_int]``): integer
        lanes re-join their hi/lo pair into exact int64, and the rows
        come back as :meth:`MatchColumns.matrix` gives them."""
        return MatchColumns(self, _i64_join(i[:, 0::2], i[:, 1::2]),
                            f).matrix()

    @property
    def output_names(self) -> List[str]:
        return [name for name, _ in self.out_spec]

    @property
    def stream_keys(self) -> List[str]:
        """Junction keys of the pattern's source streams, in node order."""
        keys: List[str] = []
        for node in self.nodes:
            for spec in node.specs:
                if spec.stream_key not in keys:
                    keys.append(spec.stream_key)
        return keys

    def numeric_stream_attrs(self, stream_key: str) -> List[str]:
        """Numeric attribute names of one stream: the host columns the
        runtime hands to ``process`` (strings stay on the host)."""
        return [a.name for a in self._stream_def(stream_key).attributes
                if a.type.is_numeric]

    def _stream_def(self, stream_key: str):
        for node in self.nodes:
            for spec in node.specs:
                if spec.stream_key == stream_key:
                    return spec.stream_def
        raise SiddhiAppCreationError(f"stream '{stream_key}' not in pattern")

    def prepare_cols(self, stream_key: str,
                     cols: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        """Host numpy columns (native dtypes) -> device lane columns:
        float attrs cast to float32, integer attrs split into the
        bias-signed hi/lo int32 pair (bit-exact at any magnitude)."""
        out: Dict[str, np.ndarray] = {}
        for a in self._stream_def(stream_key).attributes:
            v = cols.get(a.name)
            if v is None:
                continue
            v = np.asarray(v)
            if a.type in _INT_TYPES:
                v64 = v.astype(np.int64)
                out[f"{a.name}|hi"] = (v64 >> 32).astype(np.int32)
                out[f"{a.name}|lo"] = (
                    (v64 & 0xFFFFFFFF) - 2**31).astype(np.int32)
            elif a.type.is_numeric:
                out[a.name] = v.astype(np.float32)
        return out


_TORCH_DTYPES = {
    np.dtype(bool): torch.bool,
    np.dtype(np.int32): torch.int32,
    np.dtype(np.float32): torch.float32,
}


def state_from_numpy(engine: DensePatternEngine, host_state: dict,
                     base_ts: Optional[int]) -> Dict[str, torch.Tensor]:
    """A JAX engine's state (``{k: np.asarray(v)}``, or its packed
    snapshot from ``plane_pack.pack_state``) and its ``base_ts`` → port
    tensors on the engine's device.  Sets ``engine.base_ts``."""
    if "active_planes" in host_state:
        host_state = unpack_state(host_state)
    layout = engine.state_layout()
    if set(host_state) != set(layout):
        raise SiddhiAppRuntimeError(
            f"state keys {sorted(host_state)} do not match the engine's "
            f"{sorted(layout)}")
    state = {}
    for k, (shape, dt) in layout.items():
        v = np.asarray(host_state[k])
        if v.shape != shape or v.dtype != dt:
            raise SiddhiAppRuntimeError(
                f"state '{k}' is {v.dtype}{list(v.shape)}, the engine "
                f"expects {dt}{list(shape)}")
        state[k] = staged_put(np.array(v), engine.device)
    engine.base_ts = None if base_ts is None else int(base_ts)
    return state


def state_to_numpy(engine: DensePatternEngine, state: Dict[str, torch.Tensor]
                   ) -> Tuple[Dict[str, np.ndarray], Optional[int]]:
    """Inverse of :func:`state_from_numpy`: ``({k: np.ndarray}, base_ts)``
    in the JAX engine's layout."""
    keys = list(engine.state_layout())
    return (dict(zip(keys, fetch_coalesced([state[k] for k in keys]))),
            engine.base_ts)


class MatchColumns:
    """The output rows of a dense emit as typed columns: ``ints [m,
    n_int]`` int64, the integer outputs in output order, and ``f [m, O]``
    float32, a slot for every output, read by the float ones.  A delivery
    takes ``columns``, each output in its declared dtype; ``column``
    gives one output as computed and ``matrix`` the one matrix of
    ``process``.  A pair ``[row, output]`` indexes one value, as in that
    matrix."""

    __slots__ = ("engine", "ints", "f")

    def __init__(self, engine: "DensePatternEngine", ints: np.ndarray,
                 f: np.ndarray):
        self.engine = engine
        self.ints = ints
        self.f = f

    def __len__(self) -> int:
        return len(self.f)

    def column(self, oi: int) -> np.ndarray:
        """Output ``oi``'s values: an int64 view for an integer output,
        a float32 view for the others."""
        out_int = self.engine.out_int
        if out_int[oi]:
            return self.ints[:, sum(out_int[:oi])]
        return self.f[:, oi]

    def columns(self, rows=slice(None)) -> Dict[str, np.ndarray]:
        """``rows`` of every output under its name, cast to the output's
        declared dtype: the columns of an ``EventBatch``."""
        eng = self.engine
        return {name: self.column(oi)[rows].astype(eng.out_dtypes[oi])
                for oi, name in enumerate(eng.output_names)}

    def matrix(self) -> np.ndarray:
        """The rows as one matrix, as the JAX engine returns them: the
        float32 bank when no output is an integer, else an object matrix
        of exact ints and float64 values."""
        out_int = self.engine.out_int
        if not any(out_int):
            return self.f
        res = np.empty((len(self.f), len(out_int)), dtype=object)
        for oi, is_int in enumerate(out_int):
            col = self.column(oi)
            res[:, oi] = col if is_int else col.astype(np.float64)
        return res

    def copy(self) -> "MatchColumns":
        return MatchColumns(self.engine, self.ints.copy(), self.f.copy())

    def __getitem__(self, at):
        row, oi = at
        return self.column(oi)[row]

    def __setitem__(self, at, value):
        row, oi = at
        self.column(oi)[row] = value


class EmitPart(NamedTuple):
    """One step's dense banks in a :class:`DeferredDenseEmit`: ``emit
    [b, L]``, ``f [b, L, O]``, ``i [b, L, 2*n_int]`` and ``anchor [b,
    L]`` on the step's device, ``count`` its match count (a device
    scalar, a host int after ``resolve``) and ``ridx``, which maps its
    rows to batch rows in ascending order."""

    emit: torch.Tensor
    f: torch.Tensor
    i: torch.Tensor
    anchor: torch.Tensor
    count: object
    ridx: np.ndarray


class DeferredDenseEmit:
    """Device-resident match outputs of one dense batch, pending drain:
    the one owner of the dense emit format and of the match-ordering
    contract, (event index, arming anchor, lane).

    A producer adds each step's banks with :meth:`add`, one
    :class:`EmitPart` a step: the batch step's one a batch, the general
    step's one a collision round, a sharded engine's one a shard's step.
    ``resolve`` brings the counts to the host and drops the parts that
    matched nothing; ``device_arrays`` then compacts each part's matches
    on its device, and ``materialize`` receives them fetched, in
    ``device_arrays()`` order, and returns ``(ev, MatchColumns)``.
    ``pending_emit`` wraps the three for an emit queue; ``rows`` runs
    them at once, as ``process`` does.
    """

    __slots__ = ("engine", "parts", "_total")

    def __init__(self, engine: "DensePatternEngine"):
        self.engine = engine
        self.parts: List[EmitPart] = []
        self._total: Optional[int] = None

    def add(self, emit: torch.Tensor, f: torch.Tensor, i: torch.Tensor,
            anchor: torch.Tensor, count: torch.Tensor, ridx: np.ndarray):
        """One step's banks, still on its device, as a part of its own."""
        self.parts.append(EmitPart(emit, f, i, anchor, count, ridx))

    def resolve(self) -> int:
        """Fetch the match counts (scalars only, one a part) and prune
        the parts that matched nothing.  Idempotent; returns the total
        match count."""
        if self._total is None:
            counts = fetch_coalesced([p.count for p in self.parts])
            self.parts = [p._replace(count=int(c))
                          for p, c in zip(self.parts, counts) if int(c)]
            self._total = sum(p.count for p in self.parts)
        return self._total

    def device_arrays(self) -> List[torch.Tensor]:
        """After :meth:`resolve`: each part's matches compacted on its
        device, ordered and typed, two tensors a part: see
        :func:`compact_matches`.  The counts size the compaction, so
        nothing waits for the device here."""
        arrs: List[torch.Tensor] = []
        for p in self.parts:
            arrs.extend(compact_matches(p.emit, p.f, p.i, p.anchor, p.count))
        return arrs

    def materialize(self, host_arrays
                    ) -> Tuple[np.ndarray, MatchColumns]:
        """The fetched parts as ``(ev [m] int64, MatchColumns)`` in the
        match-ordering contract.  Each part arrives in (row, anchor,
        lane) order and its ``ridx`` rises, so one part is final.
        Several parts (a batch's collision rounds, a sharded batch's
        shards) hold disjoint events, each event's matches together and
        in order: one stable argsort on the event index merges them."""
        heads, flts = host_arrays[0::2], host_arrays[1::2]
        evs = [p.ridx[head[:, 0]] for p, head in zip(self.parts, heads)]
        if len(heads) == 1:
            ev, head, f = evs[0], heads[0], flts[0]
        else:
            ev = np.concatenate(evs)
            order = np.argsort(ev, kind="stable")
            ev = ev[order]
            head = np.concatenate(heads)[order]
            f = np.concatenate(flts)[order]
        return (ev.astype(np.int64, copy=False),
                MatchColumns(self.engine, head[:, 1:], f))

    def pending_emit(self, deliver: Callable, trace=None) -> PendingEmit:
        """After :meth:`resolve`, with matches: the emit queue's entry,
        whose materializer hands ``deliver`` the ``(ev, MatchColumns)``
        of :meth:`materialize`.  It counts the parts compacted and, when
        there are several, the rows merged on the host."""
        n = len(self.parts)
        return PendingEmit(
            self.device_arrays(),
            lambda host: deliver(*self.materialize(host)), trace=trace,
            compacted=n, host_merged=self._total if n > 1 else 0)

    def rows(self) -> Tuple[np.ndarray, np.ndarray]:
        """Resolve, fetch and materialize at once: ``(ev [m] int64,
        out [m, n_out])`` as ``process`` returns them, ``out`` as
        :meth:`MatchColumns.matrix` gives it; an empty float32 matrix
        when nothing matched."""
        if self.resolve() == 0:
            return (np.empty(0, dtype=np.int64),
                    np.empty((0, max(len(self.engine.out_spec), 1)),
                             dtype=np.float32))
        ev, out = self.materialize(fetch_coalesced(self.device_arrays()))
        return ev, out.matrix()


def match_order(row: torch.Tensor, anchor: torch.Tensor, lane: torch.Tensor,
                n_rows: int, n_lanes: int) -> torch.Tensor:
    """The permutation that orders matches by (row, arming anchor, lane),
    on their device: one sort of the int64 key ``row << (32 + lane_bits)
    | (anchor + 2**31) << lane_bits | lane``, its widths those of a bank
    of ``n_rows`` rows and ``n_lanes`` lanes (the offset keeps every
    int32 anchor in order); past 63 bits, stable sorts by lane, then
    anchor, then row.  ``row`` and ``lane`` are int64, ``anchor``
    int32."""
    row_bits = max(n_rows - 1, 0).bit_length()
    lane_bits = max(n_lanes - 1, 0).bit_length()
    if row_bits + 32 + lane_bits <= 63:
        key = ((row << (32 + lane_bits))
               | ((anchor.to(torch.int64) + 2**31) << lane_bits) | lane)
        return torch.argsort(key)
    perm = torch.argsort(lane, stable=True)
    for k in (anchor, row):
        perm = perm[torch.argsort(k[perm], stable=True)]
    return perm


def compact_matches(emit: torch.Tensor, f: torch.Tensor, i: torch.Tensor,
                    anchor: torch.Tensor, m: int, row0: int = 0
                    ) -> List[torch.Tensor]:
    """The ``m`` set ``(row, lane)`` pairs of ``emit [b, L]``, ordered by
    (row, arming anchor, lane) (:func:`match_order`) and gathered on
    ``emit``'s device from the dense banks ``f [b, L, O]``, ``i [b, L,
    2*n_int]`` and ``anchor [b, L]`` in their output types: ``[head [m,
    1 + n_int] int64 (row + row0, then each integer output re-joined from
    its hi/lo pair as ``_i64_join`` does), f [m, O] float32]``: the row
    rides the integer tensor, so a part is one copy a dtype.  ``m`` is
    the count gate's, so ``nonzero_static`` needs no sync; a step's
    count is the popcount of its ``emit``."""
    rl = torch.nonzero_static(emit, size=m)
    r, lane = rl[:, 0], rl[:, 1]
    perm = match_order(r, anchor[r, lane], lane, *emit.shape)
    r, lane = r[perm], lane[perm]
    pairs = i[r, lane].to(torch.int64)
    ints = pairs[:, 0::2] * 2**32 + (pairs[:, 1::2] + 2**31)
    return [torch.cat([(r + row0)[:, None], ints], dim=1), f[r, lane]]


def partition_segments(part_idx: np.ndarray
                       ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """A batch sorted stably by partition, as ``batch_step`` takes it:
    ``(order [N], seg_start [K+1], seg_part [K])``, all int32.
    ``order[seg_start[k]:seg_start[k+1]]`` are the batch rows of
    partition ``seg_part[k]``, in batch order."""
    order = np.argsort(part_idx, kind="stable")
    sorted_parts = part_idx[order]
    is_new = np.ones(len(order), dtype=bool)
    is_new[1:] = sorted_parts[1:] != sorted_parts[:-1]
    starts = np.flatnonzero(is_new)
    return (order.astype(np.int32),
            np.append(starts, len(order)).astype(np.int32),
            sorted_parts[starts].astype(np.int32))


def _round_order(part_idx: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Collision rounds of a batch, the reference's split: round ``r``
    holds the ``r``-th event of every partition that has one, in batch
    order.  Returns ``(order [N], bounds [R+1])``: the batch rows round
    after round, and where each round starts."""
    n = len(part_idx)
    order = np.argsort(part_idx, kind="stable")
    sorted_parts = part_idx[order]
    # occurrence number of each element within its partition group
    is_new = np.ones(n, dtype=bool)
    is_new[1:] = sorted_parts[1:] != sorted_parts[:-1]
    group_start = np.maximum.accumulate(np.where(is_new, np.arange(n), 0))
    occ = np.empty(n, dtype=np.int64)
    occ[order] = np.arange(n) - group_start
    bounds = np.zeros(1, dtype=np.int64)
    if n:
        bounds = np.concatenate([bounds, np.cumsum(np.bincount(occ))])
    return np.argsort(occ, kind="stable"), bounds


def _collision_rounds(part_idx: np.ndarray) -> List[np.ndarray]:
    """The batch rows of each collision round (see ``_round_order``);
    tests build the round loop of the packed step from it."""
    order, bounds = _round_order(part_idx)
    return [order[lo:hi] for lo, hi in zip(bounds[:-1], bounds[1:])]


def compile_pattern(
    app_str: str,
    query_name: Optional[str] = None,
    n_partitions: int = 1024,
    n_instances: int = 4,
    device=None,
    reset_on_emit: Optional[bool] = None,
    every_start: Optional[bool] = None,
) -> DensePatternEngine:
    """Compile a SiddhiQL pattern query into a DensePatternEngine on
    ``device`` (``cuda`` when None; raises without a card).

    The partition axis is the implicit per-key replication of the query;
    callers route events to partition ids.  ``reset_on_emit`` as in
    :class:`DensePatternEngine` (None: the product runtime's choice; the
    JAX package's ``compile_pattern`` resets, so pass True to match it).
    ``every_start`` (None: any ``every`` in the pattern) re-arms the
    start on every event, as the reference's override does: a
    non-every app compiled with True runs as its every-headed form.
    """
    from siddhi_tpu_torch.compiler import SiddhiCompiler
    from siddhi_tpu_torch.query_api.annotation import find_annotation

    dev = resolve_device(device)
    app = SiddhiCompiler.parse(app_str)
    query = None
    for i, q in enumerate(app.queries):
        info = find_annotation(q.annotations, "info")
        nm = (info.element("name") if info else None) or f"query_{i}"
        if query_name is None or nm == query_name:
            query = q
            break
    if query is None:
        raise SiddhiAppCreationError(f"query '{query_name}' not found")
    st = query.input_stream
    if not isinstance(st, StateInputStream):
        raise SiddhiAppCreationError("compile_pattern needs a pattern query")
    is_sequence = st.type == StateInputStream.SEQUENCE

    def resolve(s):
        d = app.stream_definitions.get(s.stream_id)
        if d is None:
            raise SiddhiAppCreationError(f"stream '{s.stream_id}' is not defined")
        return d

    builder = NFABuilder(st, resolve)
    nodes = builder.build()

    select_vars = []
    select_names = []
    if query.selector.selection:
        for oa in query.selector.selection:
            if not isinstance(oa.expression, Variable) or oa.expression.stream_id is None:
                raise SiddhiAppCreationError(
                    "dense NFA select items must be event references (e1.attr)"
                )
            select_vars.append(oa.expression)
            select_names.append(oa.name)

    eng = DensePatternEngine(
        nodes=nodes,
        ref_defs=builder.ref_defs,
        stream_to_ref=builder.stream_to_ref,
        within_ms=st.within_ms,
        n_partitions=n_partitions,
        select_vars=select_vars,
        select_names=select_names,
        is_sequence=is_sequence,
        n_instances=n_instances,
        device=dev,
        reset_on_emit=reset_on_emit,
        every_start=every_start,
    )
    eng.check_kernels()
    return eng
