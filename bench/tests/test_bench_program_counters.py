"""The per-layer metrics read from the engine's own counters (schema v5
of ``ServingMetrics``), which the harness copies into every tick record
as per-tick deltas: each reads a finite value in a traced run of the
tiny tree, and no counter takes the name of a field the harness writes
into the record, which ``rec.update`` would overwrite."""
import math

import pytest

import tiny
from bench import harness, spec
from repro_torch.serve.metrics import ServingMetrics

NEW = ["gate_verifications_per_tick.prefill", "pack_ms.prefill",
       "pack_ms.decode", "prefill_call_ms.prefill"]


@pytest.fixture(scope="module")
def traced(tmp_path_factory):
    root = tiny.make_tree(tmp_path_factory.mktemp("bench"))
    out = harness.run_cell(spec.load_cell("tiny-moe.mix", root),
                           2**31 + 5, 3.0, True, "cpu")
    assert out["correct"], out["checks"]
    return root, out["run"]


def _harness_fields():
    return set(harness._new_tick(0.0)) | {"tokens"}


@pytest.mark.parametrize("name", NEW)
def test_the_counter_readers_read_a_traced_run(traced, name):
    root, run = traced
    value = spec.reader(root, name)(run)
    assert value is not None and math.isfinite(value) and value >= 0


def test_the_readers_find_the_path_ran(traced):
    root, run = traced
    assert spec.reader(root, "prefill_call_ms.prefill")(run) > 0
    assert spec.reader(root, "pack_ms.decode")(run) > 0


def test_no_counter_takes_a_tick_field_name():
    counters = set(ServingMetrics(1, "paged").counters)
    assert not counters & _harness_fields()


def test_the_tick_fields_stay_the_harness_own(traced):
    """The fields the existing readers read keep the harness's types
    (a counter's delta would be an int), and the wrappers' model calls
    are still recorded."""
    _, run = traced
    want = harness._new_tick(0.0)
    for t in run.ticks:
        for k, v in want.items():
            assert type(t[k]) is type(v), k
        assert isinstance(t["tokens"], int)
    assert any(t["model"] for t in run.ticks)
