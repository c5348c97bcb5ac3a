"""The paper's Figure 1, in the PyTorch port's ARGUS DSL.

The twin of ``examples/figure1_dsl.py``: the same output, plus
``--device`` (the DSL's check is compile-time reasoning on the host; the
flag resolves the device as every entry point of the port does, so
``cuda``, the default, needs a card and ``cpu`` does not).  Builds the
flash-attention tile program with explicit tag functions and
tag assertions (the paper's `assert tag(tQ[...]) == tag(tK[...])` become
`assert_conform` ops), validates it, then demonstrates the counterexample
report by mis-lowering the GQA head mapping — the exact failure mode the
paper's invariants exist to catch.

    PYTHONPATH=src python examples/figure1_dsl_torch.py [--device cuda]
"""
import argparse
import sys

sys.path.insert(0, "src")

from repro_torch import resolve_device  # noqa: E402
from repro_torch.core import dsl  # noqa: E402
from repro_torch.core.analysis import check  # noqa: E402
from repro_torch.core.tags import make_tag  # noqa: E402

# Figure-1 constants: d=128, Br=256, Bc=64 (8 q-heads, 1 kv-head GQA)
B, H, HK = 1, 8, 1
SQ = SKV = 2048
D, BR, BC = 128, 256, 64
G = H // HK


def build(wrong_kv_head: bool = False) -> dsl.TileProgram:
    p = dsl.TileProgram("figure1_flash_attention")
    bh = p.add_grid("bh", B * H, "parallel")
    qi = p.add_grid("qi", SQ // BR, "parallel")
    kv = p.add_grid("kv", SKV // BC, "arbitrary")

    # T_Q folds the GQA group (the paper's h_q/gqa component)
    p.tensor("Q", (B, H, SQ, D),
             tag_fn=lambda b, h, r, c: make_tag(b, h // G, r, c))
    p.tensor("K", (B, HK, SKV, D))
    p.tensor("V", (B, HK, SKV, D))
    p.tensor("O", (B, H, SQ, D), kind="output")

    b = bh // H
    h = bh % H
    hk = (bh % H) if wrong_kv_head else (bh % H) // G

    q = p.squeeze(p.load("Q", (b, h, qi * BR, 0), (1, 1, BR, D)))
    k = p.squeeze(p.load("K", (b, hk, kv * BC, 0), (1, 1, BC, D)))

    # line 28 of Figure 1: assert tag(tQ[...]) == tag(tK[...])
    p.assert_conform(q, k, bind=((1, 1),), components=((0, 1, 3),
                                                       (0, 1, 3)))
    s_tag = lambda i, j: make_tag(b, hk, qi * BR + i, kv * BC + j)
    s = p.matmul(q, p.transpose(k), retag=s_tag)

    m = p.reduce(s, axis=1, kind="max",
                 retag=lambda i: make_tag(b, hk, qi * BR + i))
    m_acc = p.alloc((BR,), "f32")
    p.update(m_acc, m, fn="max",
             retag=lambda i: make_tag(b, hk, qi * BR + i))
    p.assert_stable(m_acc, "kv")

    pt = p.elementwise("exp_sub_m", s, retag=s_tag)
    v = p.squeeze(p.load("V", (b, hk, kv * BC, 0), (1, 1, BC, D)))
    # line 34 of Figure 1: the PV pairing assertion
    p.assert_conform(pt, v, bind=((1, 0),), components=((0, 1, 3),
                                                        (0, 1, 2)))
    o_tag = lambda i, c: make_tag(b, hk, qi * BR + i, c)
    acc = p.alloc((BR, D), "f32")
    p.update(acc, fn="rescale", retag=o_tag)
    p.matmul(pt, v, accumulate=True, acc=acc, retag=o_tag)
    p.assert_stable(acc, "kv")

    p.store("O", acc, (b, h, qi * BR, 0))
    p.assert_disjoint_writes("O")
    p.assert_coverage("O")
    return p


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    resolve_device(ap.parse_args(argv).device)
    good = check(build())
    print(good.render())
    assert good.ok, "Figure-1 program must validate"

    print("\n--- mis-lowered GQA head mapping (K indexed by q-head) ---")
    bad = check(build(wrong_kv_head=True))
    print(bad.render())
    assert not bad.ok, "the mis-lowering must be caught"
    print("\nFIGURE-1 DSL DEMO OK")


if __name__ == "__main__":
    main()
