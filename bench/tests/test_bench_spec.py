"""The benchmark is driven by data: cells, configurations, mixes and
metrics are found by name, and a new one is taken up as new files."""
import json
import math

import pytest
import torch

import tiny
from bench import harness, report, spec

ROOT = tiny.ROOT
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_loads_and_its_config_is_the_ports(cell):
    c = spec.load_cell(cell, ROOT)
    cfg = spec.port_config(c.config)          # checked against "model"
    assert cfg.n_layers == c.config["model"]["num_hidden_layers"]
    names = {m["name"] for m in c.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert c.per_layer and all(m["moves"] in names for m in c.per_layer)
    w = next(w for w in BENCH["workloads"] if w["name"] == cell)
    assert c.traffic == json.loads(
        (ROOT / "bench/traffic" / f"{w['traffic']}.json").read_text())


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["end_to_end"]
                                    + BENCH["per_layer"]])
def test_every_metric_has_a_reader(metric):
    assert callable(spec.reader(ROOT, metric))


def test_a_config_that_the_port_does_not_compute_is_refused():
    c = json.loads((ROOT / "bench/configs/granite-moe-3b-a800m.json")
                   .read_text())
    c["model"]["num_key_value_heads"] = 4         # the port's is 8
    with pytest.raises(ValueError, match="n_kv_heads"):
        spec.port_config(c)
    c = json.loads((ROOT / "bench/configs/stablelm-3b.json").read_text())
    c["port"]["overrides"] = {}                   # the port's eps is 1e-6
    with pytest.raises(ValueError, match="norm_eps"):
        spec.port_config(c)


def test_a_config_without_a_family_is_refused(tmp_path):
    root = tiny.make_tree(tmp_path)
    path = root / "bench/configs/tiny-dense.json"
    c = json.loads(path.read_text())
    del c["family"]
    path.write_text(json.dumps(c))
    with pytest.raises(ValueError, match="'family'"):
        spec.load_cell("tiny-dense.mix", root)
    c["family"] = "../decoder.py"
    path.write_text(json.dumps(c))
    with pytest.raises(ValueError, match="no file under"):
        spec.load_cell("tiny-dense.mix", root)


# A family of the test's own: the decoder family, with the rotary base
# read from a key of another name, so that neither the decoder's
# port_fields nor its reference would take this configuration as run.
FAMILY = '''
from bench.families import decoder
from bench.families.decoder import KERNELS  # noqa: F401

RAN = []


def _as_decoder(model):
    m = dict(model)
    m["rope_theta"] = m.pop("rotary_base")
    return m


def port_fields(model):
    return decoder.port_fields(_as_decoder(model))


def published(params, model):
    return decoder.published(params, _as_decoder(model))


def shape(model):
    return decoder.shape(_as_decoder(model))


class Reference(decoder.Reference):
    def __init__(self, model, params, precision="f32"):
        RAN.append(precision)
        super().__init__(_as_decoder(model), params, precision)
'''


def test_new_config_mix_and_metric_are_taken_up_as_files(tmp_path):
    """A configuration, its family module, a traffic mix and a per-layer
    metric added as files (and entries of BENCHMARK.json) run without an
    edit to any file of the harness."""
    root = tiny.make_tree(tmp_path)
    (root / "bench/families/rotary_base.py").write_text(FAMILY)
    extra = dict(tiny.DENSE, name="tiny-extra",
                 family="bench/families/rotary_base.py")
    extra["model"] = dict(tiny.DENSE["model"], rotary_base=500.0)
    del extra["model"]["rope_theta"]
    extra["port"] = json.loads(json.dumps(tiny.DENSE["port"]))
    extra["port"]["overrides"]["rope_theta"] = 500.0
    (root / "bench/configs/tiny-extra.json").write_text(json.dumps(extra))
    mix = dict(tiny.MIX, output_tokens={"dist": "uniform", "min": 2,
                                        "max": 3})
    (root / "bench/traffic/short.json").write_text(json.dumps(mix))
    (root / "bench/metrics/ticks_per_s.py").write_text(
        "def read(run):\n    return len(run.ticks) / run.window_s\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny-extra", "source": "test",
                             "file": "bench/configs/tiny-extra.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "tiny-extra.short",
                               "config": "tiny-extra", "traffic": "short",
                               "chips": 1, "why": "test"})
    bench["per_layer"].append({
        "name": "ticks_per_s", "unit": "1/s", "better": "higher",
        "source": "host_clock", "layer": "serve",
        "moves": "output_tokens_per_s", "workloads": ["tiny-extra.short"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = spec.load_cell("tiny-extra.short", root)
    assert cell.config["port"]["overrides"]["rope_theta"] == 500.0
    assert cell.traffic["output_tokens"]["max"] == 3
    assert "ticks_per_s" in [m["name"] for m in cell.per_layer]
    # the decoder family reads the model block as rotary base 10000
    with pytest.raises(ValueError, match="rope_theta"):
        spec.check_port_matches(
            spec.family(tiny.DENSE, root).port_fields(
                dict(extra["model"])), spec.port_config(cell.config, root))
    out = harness.run_cell(cell, 11, 1.0, True, "cpu")
    line = report.line(cell, out, True, torch.device("cpu"))
    assert line["correct"], line["checks"]
    assert line["metrics"]["ticks_per_s"]["value"] > 0
    # the check ran the new family's reference, once, in float32
    assert cell.family.RAN == ["f32"]
    # a metric another cell lists is not this cell's
    other = spec.load_cell("tiny-dense.mix", root)
    assert "ticks_per_s" not in [m["name"] for m in other.per_layer]


def test_a_reader_with_nothing_to_read_leaves_its_metric_out(tmp_path):
    root = tiny.make_tree(tmp_path)
    cell = spec.load_cell("tiny-dense.mix", root)
    out = harness.run_cell(cell, 3, 1.0, True, "cpu")
    line = report.line(cell, out, True, torch.device("cpu"))
    # no device trace on the CPU: no roofline, no idle share, no 0
    for m in ("paged_decode_roofline", "ragged_prefill_roofline",
              "device_idle.decode", "device_idle.prefill"):
        assert m not in line["metrics"]
    assert all(math.isfinite(v["value"]) for v in line["metrics"].values())
    assert "busy_s" not in line["device"]
    assert list(line)[-1] == "checks"
