"""Plain PyTorch reference of ``fraud16_1m``: the 16-state escalation
chain in ``partition with (key of Txn)``, followed for every key.

The query::

    every e1=Txn[v > 0.0] -> e2=Txn[v > 1.0 and v > e1.v] -> ...
        -> e16=Txn[v > 15.0 and v > e1.v] within 10 min
    select e1.key as key, e1.v as v1, e16.v as v16

under the configuration's stated semantics (``guarantees`` in
``configs/fraud16_1m.json``): each key holds at most ``lanes`` pending
instances a node, each with its anchor (the time its chain started) and
its ``e1.v``; ``v`` and ``e1.v`` are float32.  For each event of a key,
in arrival order:

1. instances whose anchor lies more than ``within_ms`` before the event
   expire;
2. every node's filter is read against the instances as they stand;
3. from the last node down to the first, each pending instance whose
   node's filter passes completes that node: at the last node it emits a
   row ``(key, e1.v, v)``; elsewhere it moves to the next node, the k-th
   mover taking the k-th free lane there in lane order (movers beyond
   the free lanes are dropped and counted for the key).  Going from the
   last node down, no instance completes two nodes on one event;
4. the first node's lane 0 is always pending (``every``); when it fires
   it starts an instance with ``e1.v = v``, anchored at the event.

Every key starts empty.  Keys are independent, so a batch is stepped in
collision rounds: a key's r-th event of the batch in round r, each round
one vectorised step over its keys.  It runs on the card once the
program's state is freed (on the CPU in tests), and imports torch and
numpy and nothing of the program.
"""

from __future__ import annotations

import sys

import numpy as np

# each number the check compares, with its limit: an exact comparison
LIMITS = {"rows_compared": (">=", 1), "mismatched_rows": ("<=", 0),
          "dropped_gap": ("<=", 0)}

UNSET = -(2 ** 63)  # an anchor that no instance holds


class ChainState:
    """Pending instances of keys ``[0, n)``: ``act [n, S, I]`` bool,
    ``anc [n, S, I]`` int64 anchors in ms (``UNSET`` where none),
    ``reg [n, S, I]`` float32 ``e1.v``, ``ovf [n]`` dropped instances."""

    def __init__(self, torch, n: int, S: int, I: int, device):
        self.act = torch.zeros((n, S, I), dtype=torch.bool, device=device)
        self.anc = torch.full((n, S, I), UNSET, dtype=torch.int64,
                              device=device)
        self.reg = torch.zeros((n, S, I), dtype=torch.float32,
                               device=device)
        self.ovf = torch.zeros(n, dtype=torch.int64, device=device)


def step_round(torch, st: ChainState, rows, v, t, thresholds, within_ms: int,
               rnd):
    """One event for each of the distinct keys ``rows``, with values
    ``v`` (float32) at times ``t`` (int64 ms).  Returns the emitted rows
    as ``(event, e1.v)``: the index into ``rows`` of each completing
    event and its instance's ``e1.v``.  ``rnd``: the rounding every float
    goes through (the control's bfloat16, else identity)."""
    E = rows.numel()
    S, I = st.act.shape[1], st.act.shape[2]
    act, anc, reg, ovf = st.act[rows], st.anc[rows], st.reg[rows], st.ovf[rows]
    v = rnd(v)
    expired = (anc != UNSET) & (t[:, None, None] - anc > within_ms)
    act &= ~expired
    anc.masked_fill_(expired, UNSET)
    # every filter, against the instances as they stand at the event
    vv = v[:, None]
    ok = torch.empty((E, S, I), dtype=torch.bool, device=v.device)
    ok[:, 0, :] = vv > thresholds[0]
    ok[:, 1:, :] = ((v[:, None, None] > thresholds[1:, None])
                    & (v[:, None, None] > rnd(reg[:, 1:, :])))
    lanes = torch.arange(I, device=v.device)
    emitted = None

    def place(tgt, mask, src_anc, src_reg):
        free = ~act[:, tgt]
        n_src = mask.sum(dim=1)
        free_rank = free.cumsum(dim=1) - 1
        fill = free & (free_rank < n_src[:, None])
        ovf.add_(n_src - fill.sum(dim=1))
        # the k-th mover (lane order) into the k-th free lane
        movers = torch.argsort((~mask).to(torch.uint8), dim=1, stable=True)
        src = movers.gather(1, free_rank.clamp(0, I - 1))
        act[:, tgt] |= fill
        anc[:, tgt] = torch.where(fill, src_anc.gather(1, src), anc[:, tgt])
        reg[:, tgt] = torch.where(fill, src_reg.gather(1, src), reg[:, tgt])

    for s in range(S - 1, -1, -1):
        if s == 0:
            fire = (act[:, 0] | (lanes == 0)) & ok[:, 0]
            reg[:, 0] = torch.where(fire, vv, reg[:, 0])
            anc[:, 0] = torch.where(fire, t[:, None], anc[:, 0])
        else:
            fire = act[:, s] & ok[:, s]
            act[:, s] &= ~fire
        if s == S - 1:
            e, ln = fire.nonzero(as_tuple=True)
            emitted = (e, rnd(reg[e, s, ln]))
        else:
            place(s + 1, fire, anc[:, s], reg[:, s])
    st.act[rows] = act
    st.anc[rows] = anc
    st.reg[rows] = reg
    st.ovf[rows] = ovf
    return emitted


def reference(config: dict, traffic, n_batches: int, device: str = "cpu",
              precision: str = "float32") -> dict:
    """The rows every key emits over batches ``[0, n_batches)``, and the
    instances each key dropped: ``{"batch", "key", "v1", "v16"}`` numpy
    arrays, ``"dropped"`` ``{key: count}`` and ``"dropped_total"``.
    ``precision``: ``float32`` (the configuration's) or ``bfloat16``
    (the control)."""
    import torch

    sizes = config["sizes"]
    S, I = int(sizes["states"]), int(sizes["lanes"])
    within = int(sizes["within_ms"])
    if len(config["thresholds"]) != S:
        raise ValueError("one threshold a node")
    if precision == "bfloat16":
        def rnd(x):
            return x.to(torch.bfloat16).to(torch.float32)
    else:
        def rnd(x):
            return x
    thresholds = rnd(torch.tensor([float(x) for x in config["thresholds"]],
                                  dtype=torch.float32, device=device))
    n = traffic.key_space(config["key"])
    st = ChainState(torch, n, S, I, device)
    out = {"batch": [], "key": [], "v1": [], "v16": []}
    for i in range(n_batches):
        cols, ts = traffic.batch(i)
        keys = torch.as_tensor(np.asarray(cols[config["key"]],
                                          dtype=np.int64), device=device)
        if len(keys) and not 0 <= int(keys.min()) <= int(keys.max()) < n:
            raise ValueError("keys outside the key space")
        v = torch.as_tensor(np.asarray(cols[config["value"]],
                                       dtype=np.float32), device=device)
        t = torch.as_tensor(np.asarray(ts, dtype=np.int64), device=device)
        # collision rounds: a key's r-th event of the batch in round r
        sk, order = torch.sort(keys, stable=True)
        pos = torch.arange(len(sk), device=device)
        new = torch.ones_like(sk, dtype=torch.bool)
        new[1:] = sk[1:] != sk[:-1]
        first = torch.cummax(torch.where(new, pos, 0), dim=0).values
        occ = torch.empty_like(pos)
        occ[order] = pos - first
        for r in range(int(occ.max()) + 1 if len(occ) else 0):
            ev = (occ == r).nonzero(as_tuple=True)[0]
            e, v1 = step_round(torch, st, keys[ev], v[ev], t[ev],
                               thresholds, within, rnd)
            ev = ev[e]
            out["batch"].append(np.full(len(ev), i, dtype=np.int64))
            out["key"].append(keys[ev].cpu().numpy())
            out["v1"].append(v1.cpu().numpy())
            out["v16"].append(rnd(v[ev]).cpu().numpy())
    rows = {k: (np.concatenate(a) if a else np.empty(0, dtype=(
        np.int64 if k in ("batch", "key") else np.float32)))
        for k, a in out.items()}
    ovf = st.ovf.cpu().numpy()
    hit = np.flatnonzero(ovf)
    rows["dropped"] = {int(k): int(ovf[k]) for k in hit}
    rows["dropped_total"] = int(ovf.sum())
    return rows


def as_received(config: dict, traffic, want: dict) -> tuple:
    """Reference rows as the callbacks deliver the program's, one
    ``(timestamps, {"key", "v1", "v16"})`` a batch, with its dropped
    instances as the readout gives the program's (the control's
    stand-in for the program)."""
    got = []
    for i in np.unique(want["batch"]):
        sel = want["batch"] == i
        # a batch's rows can outnumber its events; any time of its span
        # names it
        got.append((np.full(int(sel.sum()), traffic.timestamps(int(i))[0]),
                    {"key": want["key"][sel],
                     "v1": want["v1"][sel].astype(np.float64),
                     "v16": want["v16"][sel].astype(np.float64)}))
    return got, {"dropped": dict(want["dropped"]),
                 "dropped_total": want["dropped_total"]}


def compare(config: dict, traffic, n_batches: int, want: dict, received,
            program: dict) -> dict:
    """The program's rows (``received``: ``(ts, {column: array})`` per
    callback) and dropped instances (``program``, the readout's) against
    ``want``.  ``mismatched_rows``: rows ``(batch, key, v1, v16)`` in one
    multiset and not the other, a row's batch named by its event time;
    ``dropped_gap``: the summed gap of the keys' dropped instances, plus
    any the program counted on no key.  ``failed_batches``: batches
    with a mismatched row (every batch where the drops disagree)."""
    got = {"batch": [], "key": [], "v1": [], "v16": []}
    for ts, cols in received:
        got["batch"].append(traffic.batch_of_ts(ts))
        got["key"].append(np.asarray(cols["key"], dtype=np.int64))
        got["v1"].append(np.asarray(cols["v1"]).astype(np.float32))
        got["v16"].append(np.asarray(cols["v16"]).astype(np.float32))
    got = {k: (np.concatenate(v) if v else np.empty(0, want[k].dtype))
           for k, v in got.items()}
    mismatched, where = multiset_gap(_rows(want), _rows(got))
    bad = {int(x) for x in where}
    mine, theirs = program["dropped"], want["dropped"]
    gap = sum(abs(mine.get(k, 0) - theirs.get(k, 0))
              for k in set(mine) | set(theirs))
    gap += program["dropped_total"] - sum(mine.values())
    if gap:
        bad.update(range(n_batches))
    print(f"cepbench: dropped instances {program['dropped_total']} "
          f"(reference {want['dropped_total']})", flush=True,
          file=sys.stderr)
    return {"rows_compared": int(len(want["batch"])),
            "mismatched_rows": mismatched, "dropped_gap": int(gap),
            "failed_batches": sorted(bad)}


def _rows(d) -> tuple:
    """Rows as two sortable integer columns: ``(batch, key)`` and
    ``(v1, v16)`` by their float32 bits."""
    hi = (np.asarray(d["batch"], dtype=np.int64) << 32) | np.asarray(
        d["key"], dtype=np.int64)
    v1 = np.asarray(d["v1"], dtype=np.float32).view(np.uint32)
    v16 = np.asarray(d["v16"], dtype=np.float32).view(np.uint32)
    lo = (v1.astype(np.uint64) << np.uint64(32)) | v16.astype(np.uint64)
    return hi, lo


def multiset_gap(a: tuple, b: tuple):
    """``(n, batches)``: the number of rows in one multiset and not in
    the other, counting repeats, and the batches of the rows at fault."""
    hi = np.concatenate([a[0], b[0]])
    lo = np.concatenate([a[1], b[1]])
    if not len(hi):
        return 0, np.empty(0, np.int64)
    side = np.r_[np.ones(len(a[0]), np.int64), -np.ones(len(b[0]), np.int64)]
    order = np.lexsort((lo, hi))
    hi, lo, side = hi[order], lo[order], side[order]
    start = np.flatnonzero(np.r_[True, (hi[1:] != hi[:-1])
                                 | (lo[1:] != lo[:-1])])
    net = np.add.reduceat(side, start)
    bad = net != 0
    return int(np.abs(net).sum()), np.unique(hi[start[bad]] >> 32)
