"""The decoder family's operation and byte counts against hand counts at
tiny shapes, and bench/roofline.py's bound."""
import pytest

from bench.families import decoder
from bench.families.decoder import Shape
from bench.roofline import bound_s

# 2 layers, d 8, 4 query heads over 2 KV heads of 4, d_ff 16, vocab 10
DENSE = Shape(layers=2, d_model=8, heads=4, kv_heads=2, head_dim=4, d_ff=16,
              vocab=10)
MOE = Shape(layers=2, d_model=8, heads=4, kv_heads=2, head_dim=4, d_ff=16,
            vocab=10, experts=4, top_k=2)


def test_shape_of_a_model_block():
    s = Shape.of({"num_hidden_layers": 32, "hidden_size": 1536,
                  "num_attention_heads": 24, "num_key_value_heads": 8,
                  "intermediate_size": 512, "vocab_size": 49155,
                  "num_local_experts": 40, "num_experts_per_tok": 8})
    assert (s.head_dim, s.kv_bytes, s.elt) == (64, 2 * 8 * 64 * 2, 2)
    # q and o: 1536 x 24 x 64 each; k and v: 1536 x 8 x 64 each
    assert s.attn_params == 1536 * 64 * (2 * 24 + 2 * 8)
    assert s.ffn_per_token() == 8 * 3 * 1536 * 512 + 1536 * 40


def test_decode_tick_by_hand():
    # two rows of lengths 3 and 5 (the written token included)
    flops, n_bytes = decoder.tick_work(DENSE, decode_lengths=[3, 5],
                                        logits_rows=2)
    attn = 8 * 4 * (2 * 4 + 2 * 2)          # 384 projection weights
    ffn = 3 * 8 * 16                         # 384
    want_flops = 2 * (2 * (attn + ffn) * 2   # 2 layers, 2 tokens
                      + 4 * 4 * 4 * (3 + 5))  # 4 heads x 4 x hd 4 x keys
    want_flops += 2 * 8 * 10 * 2             # unembed of 2 rows
    assert flops == want_flops
    kv = 2 * 2 * 4 * 2                       # K and V, 2 heads, bf16
    want_bytes = (2 * (attn + ffn) * 2 + 8 * 10 * 2   # weights, head
                  + 2 * 8 * 2                          # 2 embedded rows
                  + 2 * kv * ((3 + 5) + 2)             # reads + writes
                  + 2 * 10 * 4)                        # f32 logits
    assert n_bytes == want_bytes


def test_prefill_pairs_by_hand():
    # a chunk of 3 tokens after a prefix of 2: queries at 2, 3, 4 see
    # 3 + 4 + 5 = 12 keys
    flops, _ = decoder.ragged_prefill_work(DENSE, [(2, 3)])
    assert flops == 4 * 4 * 4 * 12
    flops, n_bytes = decoder.ragged_prefill_work(DENSE, [(0, 4), (2, 3)])
    assert flops == 4 * 4 * 4 * ((1 + 2 + 3 + 4) + 12)
    # K/V of 4 + 5 tokens read once; q and out of 7 rows, 4 heads of 4
    assert n_bytes == (4 + 5) * 2 * 2 * 4 * 2 + 2 * 7 * 4 * 4 * 2


def test_moe_counts_only_the_chosen_experts():
    one, _ = decoder.tick_work(MOE, decode_lengths=[1])
    dense_like = Shape(**{**MOE.__dict__, "experts": 0})
    per_layer_ffn = 2 * (2 * 3 * 8 * 16 + 8 * 4)   # top-2 + router
    attn = 2 * 8 * 4 * (2 * 4 + 2 * 2) + 4 * 4 * 4 * 1
    assert one == 2 * (per_layer_ffn + attn)
    # an expert is read only where a token can reach it: 1 token x top-2
    _, b1 = decoder.tick_work(MOE, decode_lengths=[1])
    _, b3 = decoder.tick_work(MOE, decode_lengths=[1, 1, 1])
    expert = 3 * 8 * 16 * 2
    assert b3 - b1 == pytest.approx(2 * 2 * expert + 2 * 2 * 8
                                    + 2 * 2 * 2 * 2 * 4 * 2 * 2, abs=0)
    assert dense_like.ffn_read(3) == 3 * 8 * 16


def test_paged_decode_and_bound():
    flops, n_bytes = decoder.paged_decode_work(DENSE, [3, 5])
    assert flops == 4 * 4 * 4 * 8
    assert n_bytes == 8 * 2 * 2 * 4 * 2 + 2 * 2 * 4 * 4 * 2
    assert bound_s(989e12, 0) == pytest.approx(1.0)
    assert bound_s(0, 3.35e12) == pytest.approx(1.0)
