"""End to end: the port's ``compile_pattern`` + ``process`` against the
JAX package's, with the JAX engine on its Pallas packed step
(``use_kernel = True``, interpret mode on the CPU, as ``bench.py``'s
``bench_pallas_nfa`` sets it) and the port on ``device="cpu"``.

Every batch's match indices and outputs, and the final ``active``,
``first_ts`` and ``overflow``, must agree exactly: the class is
int32/bool and the outputs are selects of the inputs.
"""

import numpy as np
import pytest
import torch

from siddhi_tpu.compiler import SiddhiCompiler as JaxCompiler
from siddhi_tpu.kernels import plane_pack as jax_pack
from siddhi_tpu.ops.dense_nfa import compile_pattern as jax_compile
from siddhi_tpu_torch import compile_pattern, state_from_numpy, state_to_numpy
from siddhi_tpu_torch.compiler import SiddhiCompiler
from siddhi_tpu_torch.core.exceptions import (
    SiddhiAppCreationError,
    SiddhiAppRuntimeError,
)

DEFINE = "define stream S (k long, u double, v double); "

# capture-free chain of tests/test_kernels.py: the packed kernel's class
ELIGIBLE = ("@info(name='q') from every a=S[v > 8.0] -> b=S[v > 12.0] "
            "within 3 sec select b.v as bv insert into Alerts;")


def kernel_eligible_app(n_states):
    """bench.py's kernel_eligible_app at ``n_states`` nodes."""
    states = ["every e1=Txn[v > 1.0]"]
    for i in range(2, n_states + 1):
        states.append(f"e{i}=Txn[v > {float(i)}]")
    return ("define stream Txn (key long, v double); "
            f"@info(name='bench') from {' -> '.join(states)} within 10 min "
            f"select e{n_states}.v as v insert into Alerts;")


def engines(app, qname, P, n_instances=4):
    je = jax_compile(app, qname, n_partitions=P, n_instances=n_instances)
    je.use_kernel = True
    je._step_cache.clear()
    te = compile_pattern(app, qname, n_partitions=P, n_instances=n_instances,
                         device="cpu")
    return je, te


def assert_same_matches(jres, tres):
    (jev, jout), (tev, tout) = jres, tres
    assert np.array_equal(jev, tev)
    assert jout.dtype == tout.dtype and jout.shape == tout.shape
    assert np.array_equal(jout, tout)


def assert_same_state(jstate, te, tstate):
    host, _ = state_to_numpy(te, tstate)
    for k in ("active", "first_ts", "overflow"):
        assert np.array_equal(np.asarray(jstate[k]), host[k]), k


def drive(je, te, batches, stream="S", jstate=None, tstate=None):
    """Run both engines over ``batches``; return the states and the
    total match count."""
    jstate = je.init_state() if jstate is None else jstate
    tstate = te.init_state() if tstate is None else tstate
    n = 0
    for part, cols, ts in batches:
        jstate, *jres = je.process(jstate, stream, part, cols, ts)
        tstate, *tres = te.process(tstate, stream, part, cols, ts)
        assert_same_matches(jres, tres)
        n += len(tres[0])
    assert_same_state(jstate, te, tstate)
    return jstate, tstate, n


def s_batches(seed, n_batches, B, P, t0=1000, span=900, jump_at=None,
              v_values=None):
    """Seeded S-stream batches: partitions may repeat within a batch
    (several collision rounds); ``jump_at`` moves time past the int32
    relative range before that batch (forces a re-anchor)."""
    rng = np.random.default_rng(seed)
    out, t = [], t0
    for i in range(n_batches):
        if i == jump_at:
            t += 2**31
        part = rng.integers(0, P, B).astype(np.int32)
        if v_values is None:
            v = rng.uniform(0.0, 20.0, B)
        else:
            v = rng.choice(v_values, B)
        cols = {"k": rng.integers(-2**40, 2**40, B),
                "u": rng.uniform(0.0, 20.0, B), "v": v}
        ts = t + np.sort(rng.integers(0, span, B))
        t = int(ts[-1])
        out.append((part, cols, ts))
    return out


@pytest.mark.parametrize("app", [
    ELIGIBLE,
    # LONG compare on the hi/lo pair, values far outside int32
    "@info(name='q') from every a=S[v > 8.0] -> b=S[k > 5 and v > 4.0] "
    "within 3 sec select b.v as bv, b.k as bk insert into Alerts;",
    # no within: anchors are inert
    "@info(name='q') from every a=S[v > 10.0] -> b=S[u > 10.0] "
    "-> c=S[v < 5.0] select c.u as cu, c.k as ck insert into Alerts;",
])
@pytest.mark.parametrize("n_instances", [2, 16])
def test_matches_jax_with_collision_rounds(app, n_instances):
    je, te = engines(DEFINE + app, "q", P=8, n_instances=n_instances)
    _, _, n = drive(je, te, s_batches(11, 5, 64, P=8))
    assert n > 0


def test_float32_threshold_compares_in_float32():
    """``v > 8.1``: 8.1 has no float32; a float64 compare would pass
    v = f32(8.1), the float32 compare of both packages does not."""
    f = float(np.float32(8.1))
    app = ("@info(name='q') from every a=S[v > 8.1] -> b=S[v >= 8.1] "
           "within 3 sec select b.v as bv insert into Alerts;")
    je, te = engines(DEFINE + app, "q", P=16)
    values = np.array([f, 8.0, 9.0, np.nextafter(np.float32(8.1), 9)])
    _, _, n = drive(je, te, s_batches(3, 6, 48, P=16, v_values=values))
    assert n > 0


@pytest.mark.parametrize("app", [
    ELIGIBLE,
    "@info(name='q') from every a=S[v > 8.0] -> b=S[v > 12.0] "
    "select b.v as bv insert into Alerts;",
])
def test_re_anchor_after_time_jump(app):
    je, te = engines(DEFINE + app, "q", P=16)
    _, _, n = drive(je, te, s_batches(5, 6, 32, P=16, jump_at=3))
    assert je.base_ts == te.base_ts and te.base_ts > 2**31
    assert n > 0


def test_sixteen_state_chain():
    je, te = engines(kernel_eligible_app(16), "bench", P=64)
    rng = np.random.default_rng(7)
    batches = []
    for i in range(4):
        part = ((np.arange(64) * 524287 + i * 64) % 64).astype(np.int32)
        v = rng.uniform(0.0, 20.0, 64)
        batches.append((part, {"key": part.astype(np.int64), "v": v},
                        np.full(64, 1000 + 10 * i)))
    drive(je, te, batches, stream="Txn")


@pytest.mark.parametrize("packed", [False, True])
def test_state_carried_across_from_jax(packed):
    """JAX runs three batches; its state continues in the port."""
    app = DEFINE + ELIGIBLE
    je, te = engines(app, "q", P=16)
    batches = s_batches(17, 6, 48, P=16)
    jstate = je.init_state()
    for part, cols, ts in batches[:3]:
        jstate, _ev, _out = je.process(jstate, "S", part, cols, ts)
    host = {k: np.asarray(v) for k, v in jstate.items()}
    if packed:
        host = jax_pack.pack_state(host)
    tstate = state_from_numpy(te, host, je.base_ts)
    assert te.base_ts == je.base_ts
    _, _, n = drive(je, te, batches[3:], jstate=jstate, tstate=tstate)
    assert n > 0


def test_host_state_layout_matches_jax():
    je, te = engines(kernel_eligible_app(16), "bench", P=10)
    jhost, thost = je.init_state_host(), te.init_state_host()
    assert set(jhost) == set(thost)
    for k in jhost:
        assert jhost[k].shape == thost[k].shape, k
        assert jhost[k].dtype == thost[k].dtype, k
        assert np.array_equal(jhost[k], thost[k]), k
    for k, t in te.init_state().items():
        assert np.array_equal(t.numpy(), thost[k]), k


def test_state_from_numpy_refuses_a_foreign_layout():
    te = compile_pattern(DEFINE + ELIGIBLE, "q", n_partitions=4, device="cpu")
    host = te.init_state_host()
    host["first_ts"] = host["first_ts"].astype(np.int64)
    with pytest.raises(SiddhiAppRuntimeError, match="first_ts"):
        state_from_numpy(te, host, 0)
    host.pop("first_ts")
    with pytest.raises(SiddhiAppRuntimeError, match="keys"):
        state_from_numpy(te, host, 0)


@pytest.mark.parametrize("app,reason", [
    # counts, sequences, logical nodes, non-every heads, group-every
    # (tests/test_torch_part_b.py) and absent nodes
    # (tests/test_torch_absent.py) run on the general step
    ("@info(name='q') from every a=S[v > 8.0] -> b=S[v > a.v]<2> "
     "within 3 sec select a.v as av, b[last].v as bv insert into Alerts;",
     "counting"),
    ("@info(name='q') from every a=S[v > 8.0] -> b=S[v > 12.0]<2:3> "
     "-> c=S[v > 1.0] select c.v as cv insert into Alerts;", "counting"),
    ("@info(name='q') from every a=S[v > 8.0], b=S[v > 12.0] "
     "select b.v as bv insert into Alerts;", "sequence"),
    ("@info(name='q') from every a=S[v > 8.0] -> not S[v > 5.0] for 1 sec "
     "-> c=S[v > 1.0] select c.v as cv insert into Alerts;", "absent"),
    ("@info(name='q') from every a=S[v > 8.0] -> b=S[v > 12.0] and "
     "c=S[u > 1.0] select b.v as bv insert into Alerts;", "logical"),
    ("@info(name='q') from a=S[v > 8.0] -> b=S[v > 12.0] "
     "select b.v as bv insert into Alerts;", "non-every"),
    ("@info(name='q') from every (a=S[v > 8.0] -> b=S[v > 12.0]) "
     "within 3 sec select b.v as bv insert into Alerts;", "grouped-every"),
])
def test_refuses_patterns_outside_the_packed_class(app, reason):
    """The packed step (and the batch step) take capture-free every
    chains of plain nodes only: these shapes run on the general step,
    and ``make_step`` refuses them."""
    te = compile_pattern(DEFINE + app, "q", n_partitions=8, device="cpu")
    assert te.step_kind == "general"
    with pytest.raises(ValueError, match="general step"):
        te.make_step("S")


def test_default_device_is_cuda_and_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SiddhiAppCreationError, match="no CUDA device"):
        compile_pattern(DEFINE + ELIGIBLE, "q", n_partitions=8)
    with pytest.raises(SiddhiAppCreationError, match="no CUDA device"):
        compile_pattern(DEFINE + ELIGIBLE, "q", n_partitions=8, device="cuda")


def test_rejects_partition_ids_out_of_range():
    te = compile_pattern(DEFINE + ELIGIBLE, "q", n_partitions=8, device="cpu")
    with pytest.raises(SiddhiAppRuntimeError, match="partition ids"):
        te.process(te.init_state(), "S", np.array([8]),
                   {"k": np.array([1]), "u": np.array([1.0]),
                    "v": np.array([9.0])}, np.array([1000]))


@pytest.mark.parametrize("app", [
    DEFINE + ELIGIBLE,
    kernel_eligible_app(16),
    DEFINE + "@info(name='q') from every a=S[v > 8.0] -> b=S[v > a.v]<2:3> "
    "within 3 sec select a.v as av, b[last].v as bv insert into Alerts;",
    DEFINE + "partition with (k of S) begin @info(name='q') from S[v > 1.0] "
    "select k, v insert into Out; end;",
])
def test_compiler_copy_parses_like_jax(app):
    assert repr(SiddhiCompiler.parse(app)) == repr(JaxCompiler.parse(app))
