"""The port's train step on DTensors across four gloo ranks, a (2, 2)
("data", "model") mesh with fsdp on, on reduced granite-moe-3b-a800m
(the MoE route under DTensor: experts over "model"), against the JAX
package's jitted step on the full batch.  The setup and the tolerances
are ``tests/dist_cases.py``'s."""
import pytest

from dist_cases import match_jax


@pytest.mark.parametrize("compress", ["none", "bf16"])
def test_four_ranks_match_the_jitted_jax_step(tmp_path, compress):
    pl = match_jax(tmp_path, "granite-moe-3b-a800m", 4, 2, True, compress, 2)
    # the rules shard for real: heads over "model", and the embed axis
    # over "data" (so are the moments: ZeRO-1)
    assert pl["blocks/attn/wq"] == ["S1", "S2"]    # (layers, embed, heads, hd)
