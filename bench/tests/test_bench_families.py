"""The family that both configuration files name counts the work that
the benchmark counted before the counts moved into a family module:
``tick_work``, ``kernel_work`` and the readers of ``mfu.*`` and the
kernel rooflines on fixed tick records, against numbers copied from
``bench/roofline.py``'s ``tick_work``, ``paged_decode_work`` and
``ragged_prefill_work`` (times the layers) and ``bench/readers.py`` as
they were then."""
import json
from types import SimpleNamespace

import pytest

from bench import readers, spec
from tiny import ROOT

TICKS = [
    dict(decode_lengths=[], prefill_spans=[]),
    dict(decode_lengths=[161, 400, 1023, 7], prefill_spans=[]),
    dict(decode_lengths=[12, 900], prefill_spans=[(0, 512), (1536, 400)]),
    dict(decode_lengths=[], prefill_spans=[(0, 512), (512, 512),
                                           (3584, 416)]),
]
# per tick: tick_work, kernel_work("paged_decode"), ("ragged_prefill")
WANT = {
    "granite-moe-3b-a800m": [
        ((0.0, 0.0), None, None),
        ((7374999552.0, 5494756400.0), (312803328.0, 105054208.0), None),
        ((1638861410304.0, 6881082416.0), (179306496.0, 60162048.0),
         (162384052224.0, 339738624.0)),
        ((2738762050560.0, 7059579940.0), None,
         (413364387840.0, 645922816.0)),
    ],
    "stablelm-3b": [
        ((0.0, 0.0), None, None),
        ((21851996160.0, 5856139264.0), (521338880.0, 522649600.0), None),
        ((4910617722880.0, 6738653184.0), (298844160.0, 299499520.0),
         (270640087040.0, 1101004800.0)),
        ((7997868605440.0, 7626536448.0), None,
         (688940646400.0, 2285895680.0)),
    ],
}
# mfu, paged_decode_roofline, ragged_prefill_roofline of _run's records
READERS = {
    "granite-moe-3b-a800m": (2.4859629818241764, 7.045469339019189,
                             17.64097313061862),
    "stablelm-3b": (5.692369326885987, 35.05966396588486,
                    31.06852823519135),
}


def _shape(name):
    config = json.loads((ROOT / f"bench/configs/{name}.json").read_text())
    return spec.family(config, ROOT).shape(config["model"])


@pytest.mark.parametrize("name", list(WANT))
def test_tick_and_kernel_work_are_the_counts_before_the_move(name):
    s = _shape(name)
    for t, (tick, decode, prefill) in zip(TICKS, WANT[name]):
        assert s.tick_work(
            decode_lengths=t["decode_lengths"],
            prefill_spans=t["prefill_spans"],
            logits_rows=len(t["decode_lengths"]) + len(t["prefill_spans"])
        ) == tick
        assert s.kernel_work("paged_decode", t) == decode
        assert s.kernel_work("ragged_prefill", t) == prefill
        # a kernel the family never calls has no work to count
        assert s.kernel_work("latent_decode", t) is None


def _run(shape):
    """The TICKS once outside and once inside a profiled stretch whose
    device holds one call of each kernel and a GEMM (µs)."""
    ticks = [dict(t, t0=i * 0.1, t1=i * 0.1 + 0.05 + 0.01 * i,
                  model=[("decode", 0.01, 0.0)], profiled=p)
             for p in (False, True) for i, t in enumerate(TICKS)]
    profile = {"kept": True, "device": [
        ("paged_decode_bf16_kernel", 0.0, 700.0),
        ("ragged_wgmma_kernel", 800.0, 4100.0), ("gemm", 5000.0, 9000.0)]}
    return SimpleNamespace(ticks=ticks, shape=shape, profile=profile)


@pytest.mark.parametrize("name", list(READERS))
def test_readers_read_what_they_read_before_the_move(name):
    run = _run(_shape(name))
    mfu, decode, prefill = READERS[name]
    assert readers.mfu(run) == mfu
    # the bound of a tick's calls is now taken once over the layers'
    # summed work, not once a layer and multiplied: rounding apart
    assert readers.paged_decode_roofline(run) == pytest.approx(decode,
                                                               rel=1e-12)
    assert readers.ragged_prefill_roofline(run) == pytest.approx(prefill,
                                                                 rel=1e-12)
