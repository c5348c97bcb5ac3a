"""The benchmark's granite routes drop-free: at capacity_factor =
n_experts / top_k an expert's capacity is every packed row, so the
port's capacity dispatch keeps every (token, expert) pair at any packed
size, and each token's output depends on its own routing alone."""
import json

import pytest
import torch

import tiny
from bench import spec
from repro_torch.kernels.moe.moe import compute_dispatch
from repro_torch.models.moe import routed_experts_grouped

CFG = spec.port_config(json.loads(
    (tiny.ROOT / "bench/configs/granite-moe-3b-a800m.json").read_text()))


def _capacity(S, m):
    # the port's rule (models/moe.py routed_experts_grouped)
    return max(8, int(-(-S * m.top_k * m.capacity_factor // m.n_experts)
                      // 8 * 8))


def test_capacity_is_every_packed_row():
    m = CFG.moe
    assert m.capacity_factor == m.n_experts / m.top_k
    # the engine pads packed prefill rows to multiples of 64, up to a
    # tick of 64 rows x a 512-token chunk
    for S in range(64, 64 * 512 + 1, 64):
        assert _capacity(S, m) >= S


@pytest.mark.parametrize("S", [64, 192, 1024])
def test_no_pair_dropped_when_every_token_picks_the_same_experts(S):
    m = CFG.moe
    idx = torch.arange(m.top_k, dtype=torch.int32).expand(1, S, m.top_k)
    _, keep = compute_dispatch(idx, m.n_experts, _capacity(S, m))
    assert bool(keep.all())


def test_dispatch_equals_each_token_through_its_own_experts():
    """routed_experts_grouped at the benchmark's E, top-k and capacity
    (narrow widths) against a loop over tokens."""
    torch.manual_seed(0)
    m = CFG.moe
    S, D, F = 128, 16, 8
    x = torch.randn(1, S, D)
    p = {"wg": torch.randn(m.n_experts, D, F), "wu": torch.randn(
        m.n_experts, D, F), "wd": torch.randn(m.n_experts, F, D)}
    # half the tokens crowd onto the same experts
    idx = torch.stack([torch.randperm(m.n_experts)[:m.top_k]
                       for _ in range(S)])
    idx[: S // 2] = torch.arange(m.top_k)
    gates = torch.softmax(torch.randn(S, m.top_k), -1)
    got = routed_experts_grouped(p, x, gates[None], idx[None].int(), CFG)[0]
    want = torch.zeros(S, D)
    for t in range(S):
        for j in range(m.top_k):
            e = int(idx[t, j])
            h = torch.nn.functional.silu(x[0, t] @ p["wg"][e]) * (
                x[0, t] @ p["wu"][e])
            want[t] += gates[t, j] * (h @ p["wd"][e])
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
