"""The harness drives the port's engine on the CPU at tiny sizes and
holds what it served to its family's reference; the control, and each
fault planted under the timed path, come out as not correct."""
import dataclasses

import pytest
import torch

import tiny
from bench import check, harness, spec, weights
from bench.families.decoder import Reference, published
from repro_torch.models import build


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make_tree(tmp_path_factory.mktemp("bench"))


@pytest.mark.parametrize("config", [tiny.MOE, tiny.DENSE],
                         ids=["moe", "dense"])
def test_reference_is_the_ports_forward_in_float32(config):
    """The reference against the port's own full forward pass
    (``TransformerLM.apply``) in float32 on the same weights: a
    different program of the same mathematics."""
    cfg = dataclasses.replace(spec.port_config(config), dtype="float32")
    model = build(cfg)
    params = weights.make(model.specs, 5, "cpu", config.get("init_std"))
    tokens = torch.randint(0, cfg.vocab, (1, 40),
                           generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        want, _ = model.apply(params, tokens, remat=False)
        got = Reference(config["model"], published(
            params, config["model"])).logits([tokens[0]],
                                             [torch.arange(40)])[0]
    torch.testing.assert_close(got, want[0, :, :cfg.vocab], rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("cell", ["tiny-moe.mix", "tiny-dense.mix"])
def test_served_tokens_agree_with_the_reference(root, cell):
    c = spec.load_cell(cell, root)
    out = harness.run_cell(c, 2**31 + 11, 3.0, False, "cpu")
    assert out["correct"], out["checks"]
    assert out["checks"]["served_tokens_checked"]["value"] > 0
    assert out["checks"]["ticks_off_kernel_path"]["value"] == 0
    assert out["attempted"] > 0 and out["failed"] == 0


CELLS = {"moe": ("tiny-moe.mix", "mean_logit_gap"),
         "dense": ("tiny-dense.mix", "widest_logit_gap")}


@pytest.mark.parametrize("kind", list(CELLS))
@pytest.mark.parametrize("seed", [1, 2, 3])
def test_the_control_is_not_correct(root, kind, seed):
    """The reference in float8 in the program's place reads above the
    limit that the program's runs stay under, and is judged not
    correct."""
    name, number = CELLS[kind]
    c = spec.load_cell(name, root)
    out = harness.run_cell(c, seed, 3.0, False, "cpu")
    assert out["correct"], out["checks"]
    last = c.config["check"]["tokens_per_request"]
    control = check.verdict(c, check.control_stats(
        c, out["params"], out["sample"], last),
        out["sample"], 0)
    assert not control["correct"]
    assert control["checks"][number]["value"] > \
        control["checks"][number]["limit"]


def _clone(tree):
    return {k: _clone(v) if isinstance(v, dict) else v.clone()
            for k, v in tree.items()}


def _state_unchanged(engine):
    """The decode step's writes to the pool are lost."""
    real = engine.model.decode_step_paged

    def broken(params, pool, *a, **kw):
        logits, _ = real(params, _clone(pool), *a, **kw)
        return logits, pool
    engine.model.decode_step_paged = broken


def _half_the_batch(engine):
    """The decode step computes the first half of the batch's rows only."""
    real = engine.model.decode_step_paged

    def broken(params, pool, tables, tokens, pos, lengths, **kw):
        lengths = lengths.clone()
        lengths[lengths.shape[0] // 2:] = 0
        return real(params, pool, tables, tokens, pos, lengths, **kw)
    engine.model.decode_step_paged = broken


def _token_altered(engine):
    """One row's token a tick is altered where it is produced."""
    real = engine.model.decode_step_paged
    ticks = [0]

    def broken(*a, **kw):
        logits, pool = real(*a, **kw)
        r = ticks[0] % logits.shape[0]
        ticks[0] += 1
        logits = logits.clone()
        logits[r] = logits[r].roll(1, dims=-1)
        return logits, pool
    engine.model.decode_step_paged = broken


@pytest.mark.parametrize("kind", list(CELLS))
@pytest.mark.parametrize("fault", [_state_unchanged, _half_the_batch,
                                   _token_altered],
                         ids=["state_unchanged", "half_the_batch",
                              "token_altered"])
def test_a_broken_timed_path_is_not_correct(root, fault, kind):
    name, number = CELLS[kind]
    c = spec.load_cell(name, root)
    out = harness.run_cell(c, 7, 3.0, False, "cpu", program_hook=fault)
    assert not out["correct"]
    assert out["checks"][number]["value"] > c.config["check"][number]


def test_the_traced_run_records_spans(root):
    c = spec.load_cell("tiny-moe.mix", root)
    seen = []
    out = harness.run_cell(c, 4, 3.0, True, "cpu",
                           program_hook=seen.append)
    # the wrappers are gone once the window has closed
    assert not {"decode_step_paged", "prefill_chunk_packed"} & set(
        vars(seen[0].model))
    run = out["run"]
    ticks = [t for t in run.ticks if t["model"]]
    assert ticks and all(t["t1"] >= t["t0"] for t in ticks)
    kinds = {k for t in ticks for k, *_ in t["model"]}
    assert kinds == {"prefill", "decode"}
    assert any(t["decode_lengths"] for t in ticks)
    assert any(t["prefill_spans"] for t in ticks)
    assert all(t["gate_s"] >= 0 and t["instr_s"] >= 0 for t in ticks)
    assert out["correct"], out["checks"]
