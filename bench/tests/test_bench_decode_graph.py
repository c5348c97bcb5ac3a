"""``decode_graph_share.decode``: the share of kernel decode ticks that
replayed the decode call's CUDA graph, read from the engine's v6
counter in each tick record.  None where the counter is missing (a
program before v6) or no kernel decode tick ran."""
from types import SimpleNamespace

import pytest

from bench import spec
from tiny import ROOT

NAME = "decode_graph_share.decode"


def _run(ticks):
    return SimpleNamespace(ticks=[dict(t, profiled=t.get("profiled", False))
                                  for t in ticks])


@pytest.fixture
def read():
    return spec.reader(ROOT, NAME)


def test_none_without_the_counter(read):
    assert read(_run([{"kernel_decode_ticks": 1}] * 3)) is None
    assert read(_run([])) is None


def test_none_without_a_kernel_decode_tick(read):
    assert read(_run([{"kernel_decode_ticks": 0,
                       "decode_graph_replays": 0}] * 2)) is None


def test_100_when_every_kernel_decode_tick_replays(read):
    ticks = [{"kernel_decode_ticks": 1, "decode_graph_replays": 1},
             {"kernel_decode_ticks": 0, "decode_graph_replays": 0},
             {"kernel_decode_ticks": 1, "decode_graph_replays": 1}]
    assert read(_run(ticks)) == 100.0


def test_the_profiled_ticks_are_left_out(read):
    ticks = [{"kernel_decode_ticks": 1, "decode_graph_replays": 0},
             {"kernel_decode_ticks": 1, "decode_graph_replays": 1},
             {"kernel_decode_ticks": 1, "decode_graph_replays": 1,
              "profiled": True}]
    assert read(_run(ticks)) == 50.0


def test_a_cpu_run_reads_0(tmp_path):
    """The tiny tree's traced run on the CPU: the engine builds no graph
    there, so no kernel decode tick replays."""
    import tiny
    from bench import harness
    root = tiny.make_tree(tmp_path)
    out = harness.run_cell(spec.load_cell("tiny-moe.mix", root), 11, 2.0,
                           True, "cpu")
    assert spec.reader(root, NAME)(out["run"]) == 0.0
