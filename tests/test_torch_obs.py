"""The port's tracer and the serving engine's v5 and v6 counters: a span
is a shared no-op that allocates nothing and opens no profiler range
while the obs switch is off, under a running profiler too; while it is
on, a ring event and, under ``torch.profiler``, a ``record_function``
range (the ops launched inside it nested under it); the model's paged
serving calls give well-nested spans, one ``model.attn`` a layer; the
engine counts each gate run and its host time; a v6 snapshot
round-trips and renders, and a v5 one loads with v6's counters at 0."""
import collections
import gc
import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import configs, obs
from repro_torch.models import build
from repro_torch.obs.export import prometheus_text
from repro_torch.serve import PagedServingEngine, ServingEngine
from repro_torch.serve.metrics import (GRAPH_COUNTERS, HOST_COUNTERS,
                                       ServingMetrics)
from repro_torch.serve.trace import poisson_trace, replay

REPO = Path(__file__).resolve().parent.parent
GEOM = dict(page_size=8, max_batch=4, max_len=64, prefill_chunk=8)
PATHS = {"kernel": dict(decode_path="kernel", prefill_path="kernel"),
         "gather": dict(decode_path="gather", prefill_path="gather")}


@pytest.fixture(autouse=True)
def _switch_off():
    obs.disable()
    yield
    obs.disable()


@pytest.fixture(scope="module")
def models():
    out = {}
    for arch in ("qwen3-1.7b", "granite-moe-3b-a800m"):
        model = build(configs.get_reduced(arch))
        out[arch] = (model, model.init(0, device="cpu"))
    return out


def _trace(vocab, n=6):
    return poisson_trace(seed=3, n_requests=n, mean_gap=2.0,
                         prompt_lens=(4, 28), max_new=(3, 6), vocab=vocab)


def _paged(model, params, path="kernel", **kw):
    return PagedServingEngine(model, params, pool_pages=25, eos_id=-1,
                              device="cpu", **PATHS[path], **GEOM, **kw)


# -- the tracer ---------------------------------------------------------------

def test_off_span_is_one_shared_no_op_that_opens_no_range(monkeypatch):
    opened = []
    monkeypatch.setattr(torch.autograd.profiler, "record_function",
                        lambda name: opened.append(name))
    assert not obs.enabled()
    assert not torch.autograd.profiler._is_profiler_enabled
    a, b = obs.span("x"), obs.span("y", {"k": 1})
    assert a is b
    with a as sp:
        assert sp is a
    # a running profiler does not turn an off span into a range
    with profile(activities=[ProfilerActivity.CPU]):
        assert obs.span("z") is a
        with obs.span("z"):
            pass
    assert opened == []


@pytest.mark.skipif(not hasattr(sys, "getallocatedblocks"),
                    reason="needs sys.getallocatedblocks")
def test_off_span_allocates_nothing():
    """The hot-path guarantee with torch loaded, as an allocation budget
    over a tight loop."""
    span = obs.span
    for _ in range(1000):
        with span("warmup"):
            pass
    gc.collect()
    before = sys.getallocatedblocks()
    for _ in range(100_000):
        with span("hot"):
            pass
    delta = sys.getallocatedblocks() - before
    assert delta <= 16, f"an off span() allocated {delta} blocks"


def test_obs_imports_and_spans_without_torch():
    code = ("import sys; sys.modules['torch'] = None; "
            f"sys.path.insert(0, {str(REPO / 'src' / 'repro_torch')!r}); "
            "import obs\n"
            "with obs.span('off'): pass\n"
            "obs.enable(clock=obs.TickClock())\n"
            "with obs.span('on'): pass\n"
            "assert [e['name'] for e in obs.tracer().events()] == ['on']\n"
            "print('ok')")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=60)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def _ring():
    return obs.tracer().events() if obs.tracer() is not None else []


def test_a_span_under_the_profiler_is_a_range_over_its_ops():
    obs.enable(clock=obs.TickClock())
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with obs.span("outer.part"):
            with obs.span("inner.part"):
                torch.ones(4).add_(1)
    assert [e["name"] for e in _ring()] == ["inner.part", "outer.part"]
    events = list(prof.events())
    names = collections.Counter(e.name for e in events)
    assert names["outer.part"] == names["inner.part"] == 1
    add = next(e for e in events if e.name == "aten::add_")
    chain, p = [], add.cpu_parent
    while p is not None:
        chain.append(p.name)
        p = p.cpu_parent
    assert chain[:2] == ["inner.part", "outer.part"]
    # switched off, no span and no range: the null span again
    obs.disable()
    assert obs.span("after") is obs.span("again")


def test_a_span_with_the_switch_on_is_a_ring_event_and_a_range():
    obs.enable(clock=obs.TickClock())
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with obs.span("both", {"k": 1}):
            torch.ones(2).add_(1)
    assert [(e["name"], e["args"]) for e in obs.tracer().events()] == \
        [("both", {"k": 1})]
    assert sum(e.name == "both" for e in prof.events()) == 1


# -- the model's spans --------------------------------------------------------

def _nested_counts(events, parent, child):
    """For each ``parent`` event (oldest first), the ``child`` events
    inside its interval."""
    out = []
    for p in (e for e in events if e["name"] == parent):
        lo, hi = p["ts"], p["ts"] + p["dur"]
        out.append([e for e in events if e["name"] == child
                    and lo <= e["ts"] and e["ts"] + e["dur"] <= hi])
    return out


@pytest.mark.parametrize("arch,ffn", [("qwen3-1.7b", "model.ffn"),
                                      ("granite-moe-3b-a800m", "model.moe")])
def test_the_paged_serving_calls_give_a_span_per_layer(models, arch, ffn):
    model, params = models[arch]
    L = model.cfg.n_layers
    obs.enable(clock=obs.TickClock())
    eng = _paged(model, params)
    replay(eng, _trace(model.cfg.vocab))
    events = obs.tracer().events()
    assert obs.well_nested(events)
    n = collections.Counter(e["name"] for e in events)
    calls = n["model.decode"] + n["model.prefill"]
    assert n["model.decode"] > 0 and n["model.prefill"] > 0
    assert n["model.attn"] == n[ffn] == L * calls
    assert n["model.head"] == n["model.embed"] == calls
    # on the CPU the decode call runs eagerly: no CUDA graph
    assert {e["args"]["graph"] for e in events
            if e["name"] == "model.decode"} == {"eager"}
    for call in ("model.decode", "model.prefill"):
        for kind in ("model.attn", ffn):
            for inside in _nested_counts(events, call, kind):
                assert [e["args"]["layer"] for e in inside] == \
                    list(range(L))
        for inside in _nested_counts(events, call, "model.head"):
            assert len(inside) == 1
    # the engine's spans hold the model's
    for holder, call in (("serve.decode_tick", "model.decode"),
                         ("serve.prefill_chunk", "model.prefill")):
        assert sum(map(len, _nested_counts(events, holder, call))) == \
            n[call]
    assert {"serve.pack", "serve.tokens", "serve.gate"} <= set(n)
    assert all(e["args"]["path"] in ("decode", "prefill")
               for e in events if e["name"] == "serve.gate")


def test_the_model_calls_under_the_profiler(models):
    """With the switch on, the same spans as ranges on the profiler's
    timeline: one ``model.attn`` and one FFN range a layer a call, one
    head a call.  With it off, the profile holds none of them."""
    model, params = models["granite-moe-3b-a800m"]
    eng = _paged(model, params)
    for a in _trace(model.cfg.vocab, n=3):
        eng.submit(a.request())
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        eng.step()
    assert not any(e.name.startswith(("model.", "serve."))
                   for e in prof.events())
    obs.enable()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(6):
            eng.step()
    n = collections.Counter(e.name for e in prof.events())
    calls = n["model.decode"] + n["model.prefill"]
    assert calls > 0
    assert n["model.attn"] == n["model.moe"] == \
        model.cfg.n_layers * calls
    assert n["model.head"] == calls
    assert n["serve.tick"] == 6


# -- the engine's counters ----------------------------------------------------

@pytest.mark.parametrize("path", list(PATHS))
def test_gate_verifications_count_the_distinct_geometries(models, path):
    model, params = models["qwen3-1.7b"]
    eng = _paged(model, params, path)
    snap = replay(eng, _trace(model.cfg.vocab))["metrics"]
    c = snap["counters"]
    if path == "kernel":
        # one decode batch geometry, and each packed prefill geometry
        assert c["gate_verifications"] == 1 + len(eng._prefill_cfgs)
        assert len(eng._prefill_cfgs) >= 2
        assert c["prefill_model_us"] > 0 and c["decode_model_us"] > 0
    else:
        # the gather path's one batch geometry, shared by its prefill
        # and decode
        assert c["gate_verifications"] == 1
        assert c["prefill_model_us"] == c["decode_model_us"] == 0
    assert c["gate_us"] > 0 and c["pack_us"] > 0 and c["token_wait_us"] > 0
    lat = snap["latency"]
    for kind in ("queue_wait", "ttft", "tpot"):
        # a microsecond reading beside every tick reading
        assert sum(lat[kind]["counts"].values()) == \
            sum(lat[kind + "_us"]["counts"].values()) > 0
    assert lat["ttft_us"]["sum"] > 0 and lat["tpot_us"]["sum"] > 0


def test_the_dense_engine_counts_its_token_reads(models):
    model, params = models["qwen3-1.7b"]
    eng = ServingEngine(model, params, n_slots=4, max_len=64, eos_id=-1,
                        device="cpu")
    snap = replay(eng, _trace(model.cfg.vocab))["metrics"]
    c = snap["counters"]
    assert c["token_wait_us"] > 0 and c["gate_verifications"] == 0
    for kind in ("queue_wait", "ttft", "tpot"):
        assert sum(snap["latency"][kind]["counts"].values()) == \
            sum(snap["latency"][kind + "_us"]["counts"].values())


def test_grouped_tpot_records_equal_one_record_a_token():
    """A tick's TPOT gaps are recorded once per distinct previous token
    (rows whose last token came on one tick share it), and the
    histograms are those of one record a token."""
    from repro_torch.serve.engine import _record_tpots
    lats = [{"last": last, "last_s": s} for last, s in
            [(9, 1.0), (9, 1.0), (7, 0.5), (9, 1.0), (4, 0.25)]]
    lats.append({})                  # no token yet: a zero gap
    grouped, one = ServingMetrics(8, "paged"), ServingMetrics(8, "paged")
    _record_tpots(grouped, [dict(x) for x in lats], 10, 2.0)
    for lat in (dict(x) for x in lats):
        _record_tpots(one, [lat], 10, 2.0)
        assert (lat["last"], lat["last_s"]) == (10, 2.0)
    assert grouped.snapshot() == one.snapshot()
    tpot = grouped.snapshot()["latency"]
    assert sum(tpot["tpot"]["counts"].values()) == len(lats)
    assert tpot["tpot"]["sum"] == 1 + 1 + 3 + 1 + 6 + 0
    assert tpot["tpot_us"]["sum"] == 3 * 10**6 + 1_500_000 + 1_750_000


def _v4_part(snap):
    out = json.loads(json.dumps(snap))
    for k in HOST_COUNTERS:
        del out["counters"][k]
    for k in ("queue_wait_us", "ttft_us", "tpot_us"):
        del out["latency"][k]
    return out


def test_tracing_on_leaves_the_v4_fields_alone(models):
    """Under a TickClock the v4 fields are a function of the call
    sequence: the spans, the profiler ranges and the host-time counters
    read no reading of the engine's clock."""
    model, params = models["qwen3-1.7b"]
    tr = _trace(model.cfg.vocab)
    off = replay(_paged(model, params, clock=obs.TickClock()), tr)
    obs.enable()
    with profile(activities=[ProfilerActivity.CPU]):
        on = replay(_paged(model, params, clock=obs.TickClock()), tr)
    assert on["outputs"] == off["outputs"]
    assert _v4_part(on["metrics"]) == _v4_part(off["metrics"])


# -- the v5 and v6 snapshots --------------------------------------------------

def test_a_v5_snapshot_round_trips_and_renders(models):
    model, params = models["qwen3-1.7b"]
    snap = replay(_paged(model, params), _trace(model.cfg.vocab))["metrics"]
    assert snap["schema"] == 6
    assert ServingMetrics.from_snapshot(snap).snapshot() == snap
    text = prometheus_text(snap)
    for k in HOST_COUNTERS:
        assert f'argus_{k}_total{{engine="paged"}} {snap["counters"][k]}' \
            in text
    for k in ("queue_wait_us", "ttft_us", "tpot_us"):
        assert f"# TYPE argus_{k} histogram" in text
        n = sum(snap["latency"][k]["counts"].values())
        assert f'argus_{k}_count{{engine="paged"}} {n}' in text


def test_a_v5_snapshot_must_hold_every_v5_field():
    snap = ServingMetrics(4, "paged").snapshot()
    for group, key in (("counters", "pack_us"), ("latency", "tpot_us"),
                       ("counters", "decode_graph_replays")):
        bad = json.loads(json.dumps(snap))
        del bad[group][key]
        with pytest.raises(ValueError, match=group):
            ServingMetrics.from_snapshot(bad)
    with pytest.raises(ValueError, match="v2..v6"):
        ServingMetrics.from_snapshot(dict(snap, schema=7))


def test_the_graph_counters_round_trip_and_a_v5_snapshot_loads_them_as_0():
    m = ServingMetrics(4, "paged")
    m.record_tick(queue_depth=0, active=1, occupancy=2, pack_us=5,
                  decode_graph_replays=3, decode_graph_captures=1)
    m.record_tick(queue_depth=0, active=1, occupancy=2,
                  decode_graph_replays=1)
    snap = m.snapshot()
    assert [snap["counters"][k] for k in GRAPH_COUNTERS] == [4, 1]
    assert ServingMetrics.from_snapshot(snap).snapshot() == snap
    text = prometheus_text(snap)
    assert 'argus_decode_graph_replays_total{engine="paged"} 4' in text
    v5 = json.loads(json.dumps(snap))
    v5["schema"] = 5
    for k in GRAPH_COUNTERS:
        del v5["counters"][k]
    got = ServingMetrics.from_snapshot(v5).snapshot()
    assert got["counters"] == dict(snap["counters"], decode_graph_replays=0,
                                   decode_graph_captures=0)
    assert {k: got[k] for k in ("gauges", "peaks", "latency")} == \
        {k: snap[k] for k in ("gauges", "peaks", "latency")}
