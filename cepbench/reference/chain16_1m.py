"""Plain PyTorch reference of ``chain16_1m``: the capture-free 16-state
amount ladder in ``partition with (key of Txn)``, followed for every
key.

The query::

    every e1=Txn[v > 1.0] -> e2=Txn[v > 2.0] -> ...
        -> e16=Txn[v > 16.0] within 10 min
    select e16.key as key, e16.v as v

under the configuration's stated semantics (``guarantees`` in
``configs/chain16_1m.json``): each key holds at most ``lanes`` pending
instances a node, each with its anchor (the time its chain started);
``v`` is float32, and no node compares one event with another.  For
each event of a key, in arrival order:

1. instances whose anchor lies more than ``within_ms`` before the event
   expire;
2. every node's filter is read against the event;
3. from the last node down to the first, each pending instance whose
   node's filter passes completes that node: at the last node it emits a
   row ``(key, v)``; elsewhere it moves to the next node with its
   anchor, the k-th mover taking the k-th free lane there in lane order
   (movers beyond the free lanes are dropped and counted for the key).
   Going from the last node down, no instance completes two nodes on
   one event;
4. the first node's lane 0 is always pending (``every``); when it fires
   it starts an instance anchored at the event.

Every key starts empty.  Keys are independent, so a batch is stepped in
collision rounds: a key's r-th event of the batch in round r, each round
one vectorised step over its keys.  It runs on the card once the
program's state is freed (on the CPU in tests), and imports torch and
numpy and nothing of the program.  The row comparison and the unset
anchor are ``fraud16_1m``'s (``multiset_gap``, ``UNSET``).
"""

from __future__ import annotations

import sys

import numpy as np

from cepbench.reference.fraud16_1m import UNSET, multiset_gap

# each number the check compares, with its limit: an exact comparison
LIMITS = {"rows_compared": (">=", 1), "mismatched_rows": ("<=", 0),
          "dropped_gap": ("<=", 0)}


class LadderState:
    """Pending instances of keys ``[0, n)``: ``act [n, S, I]`` bool,
    ``anc [n, S, I]`` int64 anchors in ms (``UNSET`` where none),
    ``ovf [n]`` dropped instances."""

    def __init__(self, torch, n: int, S: int, I: int, device):
        self.act = torch.zeros((n, S, I), dtype=torch.bool, device=device)
        self.anc = torch.full((n, S, I), UNSET, dtype=torch.int64,
                              device=device)
        self.ovf = torch.zeros(n, dtype=torch.int64, device=device)


def step_round(torch, st: LadderState, rows, v, t, thresholds,
               within_ms: int):
    """One event for each of the distinct keys ``rows``, with values
    ``v`` (float32, already rounded as the run's precision asks) at
    times ``t`` (int64 ms).  Returns the index into ``rows`` of the
    completing event of each emitted row (an event that completes k
    instances appears k times)."""
    S, I = st.act.shape[1], st.act.shape[2]
    act, anc, ovf = st.act[rows], st.anc[rows], st.ovf[rows]
    expired = (anc != UNSET) & (t[:, None, None] - anc > within_ms)
    act &= ~expired
    anc.masked_fill_(expired, UNSET)
    ok = v[:, None] > thresholds  # [E, S]: every filter at the event
    lanes = torch.arange(I, device=v.device)
    emitted = torch.empty(0, dtype=torch.int64, device=v.device)

    def place(tgt, mask, src_anc):
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

    for s in range(S - 1, -1, -1):
        if s == 0:
            fire = (act[:, 0] | (lanes == 0)) & ok[:, :1]
            anc[:, 0] = torch.where(fire, t[:, None], anc[:, 0])
        else:
            fire = act[:, s] & ok[:, s:s + 1]
            act[:, s] &= ~fire
        if s == S - 1:
            emitted = fire.nonzero(as_tuple=True)[0]
        else:
            place(s + 1, fire, anc[:, s])
    st.act[rows] = act
    st.anc[rows] = anc
    st.ovf[rows] = ovf
    return emitted


def reference(config: dict, traffic, n_batches: int, device: str = "cpu",
              precision: str = "float32") -> dict:
    """The rows every key emits over batches ``[0, n_batches)``, and the
    instances each key dropped: ``{"batch", "key", "v"}`` numpy arrays,
    ``"dropped"`` ``{key: count}`` and ``"dropped_total"``.
    ``precision``: ``float32`` (the configuration's) or ``bfloat16``
    (the control: values and thresholds rounded to it)."""
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
    st = LadderState(torch, n, S, I, device)
    out = {"batch": [], "key": [], "v": []}
    for i in range(n_batches):
        cols, ts = traffic.batch(i)
        keys = torch.as_tensor(np.asarray(cols[config["key"]],
                                          dtype=np.int64), device=device)
        if len(keys) and not 0 <= int(keys.min()) <= int(keys.max()) < n:
            raise ValueError("keys outside the key space")
        v = rnd(torch.as_tensor(np.asarray(cols[config["value"]],
                                           dtype=np.float32), device=device))
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
            ev = ev[step_round(torch, st, keys[ev], v[ev], t[ev],
                               thresholds, within)]
            out["batch"].append(np.full(len(ev), i, dtype=np.int64))
            out["key"].append(keys[ev].cpu().numpy())
            out["v"].append(v[ev].cpu().numpy())
    rows = {k: (np.concatenate(a) if a else np.empty(0, dtype=(
        np.float32 if k == "v" else np.int64)))
        for k, a in out.items()}
    ovf = st.ovf.cpu().numpy()
    hit = np.flatnonzero(ovf)
    rows["dropped"] = {int(k): int(ovf[k]) for k in hit}
    rows["dropped_total"] = int(ovf.sum())
    return rows


def as_received(config: dict, traffic, want: dict) -> tuple:
    """Reference rows as the callbacks deliver the program's, one
    ``(timestamps, {"key", "v"})`` a batch, with its dropped instances
    as the readout gives the program's (the control's stand-in for the
    program)."""
    got = []
    for i in np.unique(want["batch"]):
        sel = want["batch"] == i
        # a batch's rows can outnumber its events; any time of its span
        # names it
        got.append((np.full(int(sel.sum()), traffic.timestamps(int(i))[0]),
                    {"key": want["key"][sel],
                     "v": want["v"][sel].astype(np.float64)}))
    return got, {"dropped": dict(want["dropped"]),
                 "dropped_total": want["dropped_total"]}


def compare(config: dict, traffic, n_batches: int, want: dict, received,
            program: dict) -> dict:
    """The program's rows (``received``: ``(ts, {column: array})`` per
    callback) and dropped instances (``program``, the readout's) against
    ``want``.  ``mismatched_rows``: rows ``(batch, key, v)`` in one
    multiset and not the other, a row's batch named by its event time;
    ``dropped_gap``: the summed gap of the keys' dropped instances, plus
    any the program counted on no key.  ``failed_batches``: batches
    with a mismatched row (every batch where the drops disagree)."""
    got = {"batch": [], "key": [], "v": []}
    for ts, cols in received:
        got["batch"].append(traffic.batch_of_ts(ts))
        got["key"].append(np.asarray(cols["key"], dtype=np.int64))
        got["v"].append(np.asarray(cols["v"]).astype(np.float32))
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
    """Rows as two sortable integer columns: ``(batch, key)`` and ``v``
    by its float32 bits."""
    hi = (np.asarray(d["batch"], dtype=np.int64) << 32) | np.asarray(
        d["key"], dtype=np.int64)
    lo = np.asarray(d["v"], dtype=np.float32).view(np.uint32).astype(
        np.int64)
    return hi, lo
