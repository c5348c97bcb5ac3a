"""A throwaway benchmark tree at CPU sizes: the repository's ``bench/``
copied beside a ``BENCHMARK.json`` of two tiny cells (an MoE and a
dense LayerNorm decoder with partial rotary), each with a
configuration and a traffic mix of its own.  The MoE has granite's muP
multipliers, which its weights carry (the decoder family's
``published``), and
is judged by its mean gap, as granite is; it runs in float32: at these
widths one expert of two is half a token's FFN, so a routing decision
that bfloat16 rounding flips moves a logit by tenths (a reading of 0.21
on one seed), which the float8 control's readings do not clear; in
float32 the served tokens are the reference's own."""
from __future__ import annotations

import json
import shutil
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

MOE = {
    "name": "tiny-moe", "source": "test",
    "family": "bench/families/decoder.py",
    "port": {"arch": "granite-moe-3b-a800m", "overrides": {
        "n_layers": 2, "d_model": 64, "n_heads": 4, "n_kv_heads": 2,
        "head_dim": 16, "d_ff": 32, "vocab": 256,
        "moe": {"n_experts": 4, "top_k": 2, "d_ff_expert": 32,
                "capacity_factor": 2.0}, "dtype": "float32"}},
    "model": {
        "hidden_act": "silu", "hidden_size": 64, "intermediate_size": 32,
        "num_hidden_layers": 2, "num_attention_heads": 4,
        "num_key_value_heads": 2, "head_dim": 16, "num_local_experts": 4,
        "num_experts_per_tok": 2, "vocab_size": 256, "rms_norm_eps": 1e-06,
        "rope_theta": 10000.0, "tie_word_embeddings": True,
        "torch_dtype": "float32", "embedding_multiplier": 12.0,
        "attention_multiplier": 0.015625, "residual_multiplier": 0.22,
        "logits_scaling": 6.0},
    "init_std": {"tok": 0.125},
    "check": {"requests": 4, "tokens_per_request": 100,
              "mean_logit_gap": 0.005},
}
DENSE = {
    "name": "tiny-dense", "source": "test",
    "family": "bench/families/decoder.py",
    "port": {"arch": "stablelm-3b", "overrides": {
        "n_layers": 2, "d_model": 64, "n_heads": 4, "n_kv_heads": 4,
        "d_ff": 128, "vocab": 256, "norm_eps": 1e-05}},
    "model": {
        "hidden_act": "silu", "hidden_size": 64, "intermediate_size": 128,
        "num_hidden_layers": 2, "num_attention_heads": 4,
        "num_key_value_heads": 4, "vocab_size": 256,
        "layer_norm_eps": 1e-05, "partial_rotary_factor": 0.25,
        "rope_theta": 10000.0, "tie_word_embeddings": False,
        "torch_dtype": "bfloat16"},
    # some hundreds of served tokens: with a few dozen the float8 control
    # flips too few near-ties to clear the limit
    "check": {"requests": 4, "tokens_per_request": 100,
              "widest_logit_gap": 0.05},
}
MIX = {
    "arrivals": "backlog",
    "prompt_tokens": {"dist": "log_uniform", "min": 20, "max": 60},
    "output_tokens": {"dist": "uniform", "min": 48, "max": 96},
    "block": 4, "first_batch": "residual",
    "engine": {"max_batch": 4, "prefill_chunk": 16, "page_size": 16,
               "max_len": 256, "pool_gib": 0.0005},
    "profile_ticks": 2,
}


def make_tree(dest: Path, extra_cells=()) -> Path:
    """``dest`` holding a copy of ``bench/`` and a BENCHMARK.json whose
    cells are ``tiny-moe.mix`` and ``tiny-dense.mix`` (and
    ``extra_cells``: (config, traffic) names already in the tree)."""
    dest = Path(dest)
    shutil.copytree(ROOT / "bench", dest / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    for c in (MOE, DENSE):
        (dest / "bench" / "configs" / f"{c['name']}.json").write_text(
            json.dumps(c))
    (dest / "bench" / "traffic" / "mix.json").write_text(json.dumps(MIX))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["configs"] = [
        {"name": c["name"], "source": "test",
         "file": f"bench/configs/{c['name']}.json", "reduced": [],
         "why": "test"} for c in (MOE, DENSE)]
    bench["workloads"] = [
        {"name": f"{c}.{t}", "config": c, "traffic": t, "chips": 1,
         "why": "test"}
        for c, t in [("tiny-moe", "mix"), ("tiny-dense", "mix"),
                     *extra_cells]]
    for m in bench["end_to_end"] + bench["per_layer"]:
        m.pop("workloads", None)
    (dest / "BENCHMARK.json").write_text(json.dumps(bench))
    return dest
