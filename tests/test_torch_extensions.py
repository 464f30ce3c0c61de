"""User functions, custom extensions and the manager's APIs in the port,
held against the JAX package on the same apps and events.

Replays ``tests/test_extensions.py`` (script functions, function
extensions, custom windows, parameter validation, custom aggregators,
the built-in stream functions) through both packages, each with its own
extension classes, and compares every output value with its type.  Then
the manager's and runtime's APIs: ``validate_siddhi_app``, the sandbox,
attributes, the runtime registry, ``set_config_manager`` (a
``@store(ref=...)`` table reads its options), ``set_data_source``,
``query_names`` and ``get_stream_definitions``.  A script function in a
filter under ``@app:execution('tpu')`` falls back to the host with the
reference's WARNING.
"""

import logging
import math

import numpy as np
import pytest

import siddhi_tpu.core.exceptions as jexc
import siddhi_tpu.extension.function as jfunction
import siddhi_tpu.ops.aggregators as jaggs
import siddhi_tpu.ops.windows as jwindows
import siddhi_tpu.planner.expr as jexpr
import siddhi_tpu.query_api as jqa
import siddhi_tpu.transport.broker as jbroker
import siddhi_tpu.util.config as jconfig
import siddhi_tpu_torch.core.exceptions as texc
import siddhi_tpu_torch.extension.function as tfunction
import siddhi_tpu_torch.ops.aggregators as taggs
import siddhi_tpu_torch.ops.windows as twindows
import siddhi_tpu_torch.planner.expr as texpr
import siddhi_tpu_torch.query_api as tqa
import siddhi_tpu_torch.transport.broker as tbroker
import siddhi_tpu_torch.util.config as tconfig
from siddhi_tpu import SiddhiManager as JaxManager
from siddhi_tpu_torch import SiddhiManager
from test_torch_query import ev_key


class Pkg:
    """One package's classes, so each test builds its extensions twice."""

    def __init__(self, name, manager, exc, function, windows, aggs, expr,
                 qa):
        self.name = name
        self.manager = manager
        self.exc = exc
        self.FunctionExecutor = function.FunctionExecutor
        self.LengthWindow = windows.LengthWindow
        self.WindowProcessor = windows.WindowProcessor
        self.AggExecutor = aggs.AggExecutor
        self.CompiledExpression = expr.CompiledExpression
        self.AttrType = qa.AttrType


JAX = Pkg("jax", JaxManager, jexc, jfunction, jwindows, jaggs, jexpr, jqa)
TORCH = Pkg("torch", lambda: SiddhiManager(device="cpu"), texc, tfunction,
            twindows, taggs, texpr, tqa)


def run(pkg, app, rows, out="O", stream="S", setup=None):
    """The app through one package: each row sent 1 ms apart under
    playback; returns the output events with their types."""
    m = pkg.manager()
    try:
        if setup is not None:
            setup(pkg, m)
        rt = m.create_siddhi_app_runtime("@app:playback " + app)
        got = []
        rt.add_callback(out, lambda evs: got.extend(ev_key(e) for e in evs))
        rt.start()
        h = rt.get_input_handler(stream)
        for i, r in enumerate(rows):
            h.send(list(r), timestamp=1000 + i)
        rt.shutdown()
        return got
    finally:
        m.shutdown()


def both(app, rows, **kw):
    """Run through both packages; equal outputs, types included."""
    jgot = run(JAX, app, rows, **kw)
    tgot = run(TORCH, app, rows, **kw)
    assert tgot == jgot
    return tgot


def both_raise(app, setup=None, match=None):
    """Both packages refuse the app at creation, each with its own
    SiddhiAppCreationError (and ``match`` in the message)."""
    for pkg in (JAX, TORCH):
        m = pkg.manager()
        try:
            if setup is not None:
                setup(pkg, m)
            with pytest.raises(pkg.exc.SiddhiAppCreationError, match=match):
                m.create_siddhi_app_runtime(app)
        finally:
            m.shutdown()


def seeded_rows(seed, n=200):
    rng = np.random.default_rng(seed)
    return [[int(v), float(np.round(w, 3))]
            for v, w in zip(rng.integers(-50, 50, n), rng.uniform(0, 100, n))]


SV = "define stream S (v long, w double); "


class TestScriptFunctions:
    @pytest.mark.parametrize("fn,select", [
        ("define function double[python] return long { data[0] * 2 }; ",
         "double(v) as d"),
        ("define function tag[python] return string "
         "{ result = 'v=' + str(data[0]) }; ", "tag(v) as t"),
        ("define function addem[python] return long { data[0] + data[1] }; ",
         "addem(v, v) as s"),
        ("define function half[python] return double { data[0] / 2 }; ",
         "half(w) as h"),
        ("define function trunc[python] return int { data[0] }; ",
         "trunc(w) as i"),
        ("define function big[python] return bool { data[0] > 10 }; ",
         "big(v) as b"),
    ])
    def test_script_in_select(self, fn, select):
        got = both(fn + SV + f"from S select v, {select} insert into O;",
                   seeded_rows(1))
        assert len(got) == 200

    def test_script_in_filter(self):
        got = both("define function isBig[python] return bool "
                   "{ data[0] > 10 }; " + SV +
                   "from S[isBig(v)] select v insert into O;",
                   seeded_rows(2))
        assert 0 < len(got) < 200

    def test_unknown_language_raises(self):
        both_raise("define function f[cobol] return long { 42 }; "
                   "define stream S (v long); "
                   "from S select f() as x insert into O;")

    def test_javascript_needs_engine(self):
        both_raise("define function f[javascript] return long "
                   "{ return 42; }; define stream S (v long); "
                   "from S select f() as x insert into O;",
                   match="JavaScript")

    def test_script_filter_under_tpu_falls_back(self, caplog):
        """The device compilers do not know a user function: the query
        runs on the host with the reference's WARNING."""
        app = ("@app:execution('tpu') define function isBig[python] "
               "return bool { data[0] > 10 }; " + SV +
               "@info(name='q') from S[isBig(v)] select v, w, isBig(v) as b "
               "insert into O;")
        caplog.set_level(logging.WARNING)
        jgot = run(JAX, app, seeded_rows(3))
        jwarn = [r.getMessage() for r in caplog.records
                 if r.name.startswith("siddhi_tpu")
                 and "device query path" in r.getMessage()]
        caplog.clear()
        tgot = run(TORCH, app, seeded_rows(3))
        twarn = [r.getMessage() for r in caplog.records
                 if r.name.startswith("siddhi_tpu_torch")]
        assert tgot == jgot and len(tgot) > 0
        assert twarn == jwarn == [
            "query 'q': device query path unavailable (unknown function "
            "'isBig()'); using host engine"]


class TestCustomFunctionExtension:
    def test_function_executor(self):
        def setup(pkg, m):
            class PlusOne(pkg.FunctionExecutor):
                return_type = pkg.AttrType.LONG

                def execute(self, v):
                    return v + 1

            m.set_extension("custom:plusOne", PlusOne, kind="function")

        got = both(SV + "from S select custom:plusOne(v) as d insert into O;",
                   seeded_rows(4), setup=setup)
        assert got[0][2][0] == ("int", 1 + int(seeded_rows(4)[0][0]))

    def test_executor_instance_sees_argument_types(self):
        seen = {}

        def setup(pkg, m):
            class Scale(pkg.FunctionExecutor):
                return_type = pkg.AttrType.DOUBLE

                def init(self, arg_types):
                    seen[pkg.name] = [t.value for t in arg_types]

                def execute(self, v, w):
                    return v * w

            m.set_extension("scale", Scale(), kind="function")

        both(SV + "from S[scale(v, w) > 0.0] select scale(v, w) as x "
             "insert into O;", seeded_rows(5), setup=setup)
        assert seen["torch"] == seen["jax"]

    def test_plain_callable(self):
        got = both(SV + "from S select sq(v) as d insert into O;",
                   seeded_rows(6),
                   setup=lambda pkg, m: m.set_extension(
                       "sq", lambda v: v * v, kind="function"))
        assert len(got) == 200

    def test_remove_extension(self):
        def setup(pkg, m):
            m.set_extension("gone", lambda v: v, kind="function")
            m.remove_extension("gone", kind="function")

        both_raise(SV + "from S select gone(v) as d insert into O;",
                   setup=setup, match="unknown function")

    def test_extension_set_after_creation_is_not_seen(self):
        """Each app plans against a copy of its manager's registry."""
        m = SiddhiManager(device="cpu")
        rt = m.create_siddhi_app_runtime(SV + "from S select v insert into O;")
        m.set_extension("later", lambda v: v, kind="function")
        assert rt.extensions.lookup("function", "later") is None
        assert m.siddhi_context.extensions.lookup("function", "later")
        m.shutdown()


class TestCustomWindowExtension:
    def test_custom_window(self):
        def setup(pkg, m):
            class KeepOne(pkg.LengthWindow):
                def __init__(self, args, attribute_names):
                    one = pkg.CompiledExpression(lambda env: 1,
                                                 pkg.AttrType.INT)
                    super().__init__([one], attribute_names)

            m.set_extension("custom:keepOne", KeepOne, kind="window")

        got = both(SV + "from S#window.custom:keepOne() select sum(v) as t "
                   "insert into O;", seeded_rows(7, 50), setup=setup)
        assert [e[2][0][1] for e in got] == [r[0] for r in seeded_rows(7, 50)]


class TestParameterValidation:
    @pytest.mark.parametrize("window", ["length(2, 3)", "length('two')"])
    def test_bad_arguments_fail_at_creation(self, window):
        for pkg in (JAX, TORCH):
            m = pkg.manager()
            with pytest.raises(pkg.exc.SiddhiAppValidationError):
                m.create_siddhi_app_runtime(
                    f"define stream S (v long); from S#window.{window} "
                    "select v insert into OutputStream;")
            m.shutdown()

    def test_named_window_is_a_later_slice(self):
        """A named window's function is validated as a query window's:
        ``time(1 sec, 2 sec)`` is refused by both packages with the
        validation error (the port took named windows in with tables)."""
        app = ("define stream S (v long); "
               "define window W (v long) time(1 sec, 2 sec) output all "
               "events; from S insert into W;")
        with pytest.raises(jexc.SiddhiAppValidationError):
            JaxManager().create_siddhi_app_runtime(app)
        with pytest.raises(texc.SiddhiAppValidationError):
            SiddhiManager(device="cpu").create_siddhi_app_runtime(app)

    def test_repetitive_overload_accepts_tail(self):
        both("define stream S (v long, w double); "
             "from S#window.sort(2, v, 'asc') select v insert into O;",
             seeded_rows(8, 40))

    def test_custom_extension_without_declaration_unchecked(self):
        def setup(pkg, m):
            class AnyArgsWindow(pkg.WindowProcessor):
                def process(self, batch, now):
                    return batch

            m.set_extension("anyArgs", AnyArgsWindow, kind="window")

        got = both(SV + "from S#window.anyArgs(1, 'x', v) select v "
                   "insert into O;", seeded_rows(9, 30), setup=setup)
        assert len(got) == 30


class TestCustomAggregators:
    def test_custom_aggregator_extension(self):
        def setup(pkg, m):
            class GeoMean(pkg.AggExecutor):
                return_type = pkg.AttrType.DOUBLE

                def __init__(self, arg_type=None):
                    pass

                def new_state(self):
                    return {"logsum": 0.0, "n": 0}

                def add_run(self, state, values):
                    logs = np.log(values.astype(np.float64))
                    cum = state["logsum"] + np.cumsum(logs)
                    ns = state["n"] + np.arange(1, len(values) + 1)
                    state["logsum"] = cum[-1] if len(cum) else state["logsum"]
                    state["n"] += len(values)
                    return np.exp(cum / ns)

                def remove_run(self, state, values):
                    logs = np.log(values.astype(np.float64))
                    cum = state["logsum"] - np.cumsum(logs)
                    ns = state["n"] - np.arange(1, len(values) + 1)
                    state["logsum"] = cum[-1] if len(cum) else state["logsum"]
                    state["n"] -= len(values)
                    return np.exp(cum / np.maximum(ns, 1))

            m.set_extension("custom:geoMean", GeoMean, kind="aggregator")

        got = both(SV + "from S#window.length(5) select "
                   "custom:geoMean(w) as g insert into O;",
                   seeded_rows(10, 60), setup=setup)
        first = seeded_rows(10, 60)[0][1]
        assert math.isclose(float.fromhex(got[0][2][0][1]), first)

    def test_custom_aggregator_with_group_by(self):
        def setup(pkg, m):
            class Last(pkg.AggExecutor):
                return_type = pkg.AttrType.DOUBLE

                def __init__(self, arg_type=None):
                    pass

                def new_state(self):
                    return {"last": None}

                def add_run(self, state, values):
                    state["last"] = float(values[-1])
                    return values.astype(np.float64)

                def remove_run(self, state, values):
                    return np.full(len(values), state["last"] or 0.0)

            m.set_extension("lastVal", Last, kind="aggregator")

        got = both("define stream S (k string, v double); "
                   "from S select k, lastVal(v) as l group by k "
                   "insert into O;",
                   [["a", 1.0], ["b", 5.0], ["a", 3.0]], setup=setup)
        assert [e[2][1][1] for e in got] == [x.hex() for x in (1.0, 5.0, 3.0)]


class TestBuiltinStreamFunctions:
    def test_pol2cart_appends_xy(self):
        both("define stream P (theta double, rho double); "
             "from P#pol2Cart(theta, rho) select x, y insert into O;",
             [[60.0, 2.0], [15.5, 3.25]], stream="P")

    def test_pol2cart_z_passthrough_and_downstream_filter(self):
        got = both("define stream P (theta double, rho double, e double); "
                   "from P#pol2Cart(theta, rho, e)[x > 0.5] "
                   "select x, z insert into O;",
                   [[60.0, 2.0, 5.0], [120.0, 0.4, 6.0]], stream="P")
        assert len(got) == 1

    def test_log_function_passthrough(self):
        both("define stream S (v double); "
             "from S#log('checkpoint') select v insert into O;",
             [[7.0], [8.0]])

    def test_pol2cart_select_star(self):
        got = both("define stream P (theta double, rho double); "
                   "@info(name='q1') from P#pol2Cart(theta, rho) "
                   "select * insert into O; "
                   "@info(name='q2') from P select * insert into O2;",
                   [[0.0, 2.0]], stream="P")
        assert len(got[0][2]) == 4  # theta, rho, x, y


class TestManagerApis:
    APP = SV + "@info(name='q1') from S[v > 1] select v insert into O;"

    @pytest.mark.parametrize("app,ok", [
        (APP, True),
        (SV + "from S[nope > 1] select v insert into O;", False),
        ("define function f[cobol] return long { 1 }; " + SV +
         "from S select f() as x insert into O;", False),
    ])
    def test_validate(self, app, ok):
        for pkg in (JAX, TORCH):
            m = pkg.manager()
            if ok:
                m.validate_siddhi_app(app)
            else:
                with pytest.raises(Exception):
                    m.validate_siddhi_app(app)
            # validation leaves no runtime registered
            assert m.get_siddhi_app_runtimes() == {}
            m.shutdown()

    def test_validate_leaves_a_running_app_alone(self):
        m = SiddhiManager(device="cpu")
        app = "@app:name('X') " + self.APP
        rt = m.create_siddhi_app_runtime(app)
        m.validate_siddhi_app(app)
        assert m.get_siddhi_app_runtime("X") is rt
        m.shutdown()

    def test_sandbox_strips_stream_transports(self):
        app = ("@source(type='doesNotExist', topic='x', "
               "@map(type='passThrough')) "
               "@sink(type='log') "
               "define stream S (v long, w double); "
               "@sink(type='alsoMissing') define stream O (v long); "
               "@info(name='q1') from S[v > 1] select v insert into O;")
        outs = {}
        for pkg in (JAX, TORCH):
            m = pkg.manager()
            rt = m.create_sandbox_siddhi_app_runtime(app)
            got = []
            rt.add_callback("O", lambda evs: got.extend(
                ev_key(e) for e in evs))
            rt.start()
            h = rt.get_input_handler("S")
            for i, row in enumerate(seeded_rows(11, 20)):
                h.send(row, timestamp=1000 + i)
            anns = {sid: [(a.name, a.element("type"))
                          for a in d.annotations]
                    for sid, d in rt.get_stream_definitions().items()}
            outs[pkg.name] = (got, anns, rt.query_names())
            rt.shutdown()
            m.shutdown()
        assert outs["torch"] == outs["jax"]
        assert outs["torch"][0]
        assert outs["torch"][1] == {"S": [], "O": []}

    def test_sandbox_keeps_in_memory_transports(self):
        """The sandbox keeps an inMemory sink, as the reference's does,
        and the sink publishes what the stream carries, in both
        packages."""
        app = ("@source(type='doesNotExist', topic='x') "
               "@sink(type='inMemory', topic='sandbox-t') "
               "define stream S (v long, w double); "
               "@info(name='q1') from S[v > 1] select v insert into O;")
        outs = {}
        for pkg, broker in ((JAX, jbroker), (TORCH, tbroker)):
            m = pkg.manager()
            rt = m.create_sandbox_siddhi_app_runtime(app)
            anns = [(a.name, a.element("type")) for a in
                    rt.get_stream_definitions()["S"].annotations]
            got = []
            sub = broker.FunctionSubscriber(
                "sandbox-t", lambda e, g=got: g.append(tuple(e.data)))
            broker.InMemoryBroker.subscribe(sub)
            rt.start()
            h = rt.get_input_handler("S")
            for i, row in enumerate(seeded_rows(11, 6)):
                h.send(row, timestamp=1000 + i)
            rt.shutdown()
            broker.InMemoryBroker.unsubscribe(sub)
            m.shutdown()
            outs[pkg.name] = (anns, got)
        assert outs["torch"] == outs["jax"]
        assert outs["torch"][0] == [("sink", "inMemory")]
        assert len(outs["torch"][1]) == 6

    def test_attributes_and_runtimes(self):
        outs = {}
        for pkg in (JAX, TORCH):
            m = pkg.manager()
            m.set_attribute("shared", {"x": 1})
            rt = m.create_siddhi_app_runtime("@app:name('A1') " + self.APP)
            outs[pkg.name] = (dict(m.get_attributes()),
                              sorted(m.get_siddhi_app_runtimes()),
                              m.get_siddhi_app_runtime("A1") is rt,
                              m.get_siddhi_app_runtime("nope"),
                              rt.query_names(),
                              sorted(rt.get_stream_definitions()))
            m.shutdown()
        assert outs["torch"] == outs["jax"]
        assert outs["torch"][0] == {"shared": {"x": 1}}

    def test_config_manager_and_data_sources(self):
        """The same calls through both managers, each with its own
        ``InMemoryConfigManager`` over the same dicts: what the config
        readers, refs and properties answer, and what the manager's
        context holds after the data-source and handler-manager setters
        (Java aliases included), are equal.  The store planner reads
        the refs: a ``@store(ref='store1')`` table gives the same rows
        in both packages.  The transport planner reads them too: a
        ``@source(ref='src1')`` of an unknown type raises in both."""
        configs = {"source.http.port": "8280", "source.http.host": "h",
                   "sink.log.prefix": "p", "some.property": "v"}
        system = {"store1": {"type": "memory", "topic": "t1"},
                  "src1": {"type": "http", "port": "9090"}}
        marks = {n: object() for n in ("ds", "source", "sink", "table")}
        outs = {}
        for pkg, config in ((JAX, jconfig), (TORCH, tconfig)):
            m = pkg.manager()
            cm = config.InMemoryConfigManager(configs, system)
            m.setConfigManager(cm)
            m.set_data_source("ds", marks["ds"])
            m.setDataSource("ds2", marks["ds"])
            m.set_source_handler_manager(marks["source"])
            m.setSinkHandlerManager(marks["sink"])
            m.set_record_table_handler_manager(marks["table"])
            ctx = m.siddhi_context
            http = ctx.config_manager.generate_config_reader("source",
                                                             "http")
            outs[pkg.name] = (
                ctx.config_manager is cm,
                http.read_config("port"), http.readConfig("nope"),
                http.read_config("nope", "d"), http.getAllConfigs(),
                cm.generateConfigReader("sink", "log").get_all_configs(),
                cm.generate_config_reader("store", "rdbms").get_all_configs(),
                cm.extractSystemConfigs("store1"),
                cm.extract_system_configs("src1"),
                cm.extract_system_configs("missing"),
                cm.extractProperty("some.property"),
                cm.extract_property("missing"),
                sorted(ctx.data_sources),
                ctx.data_sources["ds"] is marks["ds"],
                ctx.source_handler_manager is marks["source"],
                ctx.sink_handler_manager is marks["sink"],
                ctx.record_table_handler_manager is marks["table"])
            m.shutdown()
        assert outs["torch"] == outs["jax"]
        assert outs["torch"][1:3] == ("8280", None)
        for pkg, config, exc in ((JAX, jconfig, jexc), (TORCH, tconfig,
                                                         texc)):
            m = pkg.manager()
            m.set_config_manager(config.InMemoryConfigManager(configs,
                                                              system))
            with pytest.raises(exc.SiddhiAppCreationError,
                               match=r"unknown @source\(type='http'\)"):
                m.create_siddhi_app_runtime(
                    "@source(ref='src1') define stream S (v long); "
                    "from S select v insert into O;")
            m.shutdown()
        rows = {}
        for pkg, config in ((JAX, jconfig), (TORCH, tconfig)):
            m = pkg.manager()
            m.set_config_manager(config.InMemoryConfigManager(configs,
                                                              system))
            rt = m.create_siddhi_app_runtime(
                "@app:playback @store(ref='store1') define table T "
                "(v long); define stream S (v long); "
                "from S select v insert into T;")
            rt.start()
            for i, v in enumerate((7, -3, 9)):
                rt.get_input_handler("S").send([v], timestamp=10 + i)
            rows[pkg.name] = [ev_key(e) for e in rt.query(
                "from T on v > 0L select v;")]
            m.shutdown()
        assert rows["torch"] == rows["jax"]
        assert [r[2] for r in rows["torch"]] == [(("int", 7),),
                                                 (("int", 9),)]

    def test_set_extension_takes_the_kinds_the_port_plans(self):
        """A kind the port's planners never look up (the reference's
        ``table``) is refused rather than stored unread; a known kind (a
        function, a store, a source, a sink, a mapper) registers and
        ``remove_extension`` takes it out again."""
        m = SiddhiManager(device="cpu")
        for kind in ("table", "nope"):
            with pytest.raises(ValueError, match="unknown extension kind"):
                m.set_extension("custom:thing", object, kind=kind)
        reg = m.siddhi_context.extensions
        for kind in ("function", "store", "source", "sink", "source_mapper",
                     "sink_mapper"):
            m.set_extension("custom:thing", object, kind=kind)
            assert reg.lookup(kind, "thing", "custom") is object
            m.remove_extension("custom:thing", kind=kind)
            assert reg.lookup(kind, "thing", "custom") is None
        m.shutdown()
