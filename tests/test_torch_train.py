"""The port's training stack against the JAX package's, on the same
numpy inputs: AdamW, clipping and the cosine schedule
(``repro_torch.optim``), the train step (``repro_torch.train``), the
data pipeline (``repro_torch.data``), checkpoints
(``repro_torch.checkpoint``: the format both ways, the manager), the
fault-tolerance helpers (``repro_torch.ft``) and the launchers
(``launch.train``; ``launch.serve --ckpt-dir``), all on the CPU.

Tolerances: the schedule's rates within four float32 ulps (XLA's CPU
cosine and PyTorch's differ in the last bit at a few arguments, two ulps
of the rate at most; the warmup's are equal); AdamW's and the train
step's parameters within 1e-5 of max(1, the leaf's largest |value|)
after the last step (measured: 7e-7; 3e-5 where microbatch gradients
accumulate in bf16, derived at the case); the step's loss within 1e-5 of
its value and its gradient norm within 1e-4 (measured: 2.2e-5 at the
second step of stablelm-3b, where a parameter whose first gradient was
near zero took AdamW's first step, about ``lr`` whatever the gradient's
size, in another rounding); data batches and checkpoint leaves
bit-identical."""
import json
import signal
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from repro import configs as jconfigs
from repro.checkpoint import CheckpointManager as JaxManager
from repro.checkpoint import load_pytree as jax_load
from repro.checkpoint import save_pytree as jax_save
from repro.data import make_dataset as jax_dataset
from repro.optim import adamw_init as jax_adamw_init
from repro.optim import adamw_update as jax_adamw_update
from repro.optim import clip_by_global_norm as jax_clip
from repro.optim import cosine_schedule as jax_cosine
from repro.train import make_train_step as jax_train_step

from repro_torch import configs as tconfigs
from repro_torch.checkpoint import (CheckpointManager, load_pytree,
                                    save_pytree)
from repro_torch.data import make_dataset
from repro_torch.ft import PreemptionHandler, StepTimer, StragglerMonitor
from repro_torch.models import from_jax_numpy
from repro_torch.models.params import leaf_paths
from repro_torch.optim import (AdamWState, adamw_from_jax_numpy,
                               adamw_init, adamw_update,
                               clip_by_global_norm, cosine_schedule)
from repro_torch.train import (make_prefill_step, make_serve_step,
                               make_train_step)

from train_cases import pair

PARAM_TOL = 1e-5


def _close_trees(got, want, tol=PARAM_TOL):
    """Every leaf of ``got`` (tensors) within tol of max(1, max|want|)."""
    want = dict(leaf_paths(jax.tree.map(
        lambda a: np.asarray(a.astype(jnp.float32)), want)))
    for path, t in leaf_paths(got):
        w = want[path]
        scale = max(1.0, float(np.abs(w).max()))
        err = float(np.abs(t.detach().float().numpy() - w).max())
        assert err <= tol * scale, (path, err)


# -- optim ---------------------------------------------------------------------

def test_adamw_reduces_quadratic():
    params = {"w": torch.tensor([3.0, -2.0])}
    opt = adamw_init(params)
    for _ in range(200):
        g = {"w": 2 * params["w"]}
        params, opt = adamw_update(g, opt, params, lr=5e-2,
                                   weight_decay=0.0)
    assert float(params["w"].abs().max()) < 0.2
    assert int(opt.step) == 200 and opt.step.dtype == torch.int32


def test_clip():
    g = {"w": torch.tensor([300.0, 400.0])}
    clipped, norm = clip_by_global_norm(g, 1.0)
    assert abs(float(norm) - 500.0) < 1e-3
    assert abs(float(torch.linalg.norm(clipped["w"])) - 1.0) < 1e-5


def test_schedule_matches_jax():
    for kw in (dict(peak_lr=3e-4, warmup=20, total=100),
               dict(peak_lr=1e-3, warmup=0, total=7, floor_frac=0.2)):
        for s in range(0, 130):
            want = np.float32(jax_cosine(jnp.asarray(s, jnp.int32), **kw))
            got = cosine_schedule(torch.tensor(s, dtype=torch.int32), **kw)
            assert got.dtype == torch.float32
            got = np.float32(got)
            if s < kw["warmup"]:
                assert got == want, (s, got, want)
            assert abs(got - want) <= 4 * np.spacing(want), (s, got, want)


def test_adamw_and_clipping_match_jax_over_ten_steps():
    """bf16 and float32 params, float32 moments; grads drawn from a
    seeded normal each step and clipped at 1; the learning rate from the
    schedule at the optimizer's step."""
    rng = np.random.default_rng(0)
    shapes = {"a": ((7, 5), jnp.float32), "b": {"c": ((11,), jnp.bfloat16)}}
    jp = jax.tree.map(lambda s: jnp.asarray(rng.normal(size=s[0]), s[1]),
                      shapes, is_leaf=lambda s: isinstance(s, tuple))
    tp = from_jax_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    jo = jax_adamw_init(jp)
    to = adamw_from_jax_numpy(jax.tree.map(np.asarray, jo), device="cpu")
    assert isinstance(to, AdamWState) and to.mu["b"]["c"].dtype == \
        torch.float32
    kw = dict(peak_lr=1e-2, warmup=3, total=10)
    for _ in range(10):
        g = jax.tree.map(lambda a: jnp.asarray(
            3 * rng.normal(size=a.shape), a.dtype), jp)
        jg, jn = jax_clip(g, 1.0)
        tg, tn = clip_by_global_norm(
            from_jax_numpy(jax.tree.map(np.asarray, g), device="cpu"), 1.0)
        assert abs(float(tn) - float(jn)) <= 1e-6 * float(jn)
        assert tg["b"]["c"].dtype == torch.bfloat16
        jp, jo = jax_adamw_update(jg, jo, jp, lr=jax_cosine(jo.step, **kw))
        tp, to = adamw_update(tg, to, tp, lr=cosine_schedule(to.step, **kw))
    assert int(to.step) == int(jo.step) == 10
    assert tp["b"]["c"].dtype == torch.bfloat16
    _close_trees(tp, jp)
    _close_trees(to.mu, jo.mu)
    _close_trees(to.nu, jo.nu)


# -- the train step --------------------------------------------------------------

@pytest.mark.parametrize("arch,grad_accum,compress", [
    ("qwen3-1.7b", 1, "bf16"), ("stablelm-3b", 2, "bf16"),
    ("stablelm-3b", 2, None)])
def test_three_train_steps_match_the_jitted_jax_step(arch, grad_accum,
                                                     compress):
    jm, jp, tm, tp = pair(arch, "float32")
    jo = jax_adamw_init(jp)
    to = adamw_from_jax_numpy(jax.tree.map(np.asarray, jo), device="cpu")
    kw = dict(peak_lr=1e-3, warmup=2, total=10)
    jstep = jax.jit(jax_train_step(
        jm, lr_fn=lambda s: jax_cosine(s, **kw), grad_accum=grad_accum,
        compress_grads=compress))
    tstep = make_train_step(tm, lr_fn=lambda s: cosine_schedule(s, **kw),
                            grad_accum=grad_accum, compress_grads=compress)
    ds = make_dataset(tm.cfg, seq_len=16, global_batch=4, seed=1)
    for _ in range(3):
        b = next(ds)
        jp, jo, jmet = jstep(jp, jo, {"tokens": jnp.asarray(b["tokens"])})
        tp, to, tmet = tstep(tp, to, {"tokens": torch.from_numpy(
            b["tokens"])})
        assert set(tmet) == set(jmet) == {"loss", "ce", "aux", "gnorm",
                                          "lr"}
        for k, rel in (("loss", 1e-5), ("ce", 1e-5), ("gnorm", 1e-4)):
            assert abs(float(tmet[k]) - float(jmet[k])) <= \
                rel * abs(float(jmet[k])), k
        assert abs(float(tmet["lr"]) - float(jmet["lr"])) <= 4 * np.spacing(
            np.float32(jmet["lr"]))
        if grad_accum > 1:
            assert float(tmet["aux"]) == 0.0
    assert int(to.step) == 3
    assert all(t.requires_grad for _, t in leaf_paths(tp))
    # bf16 accumulation (grad_accum > 1): an element the two packages'
    # float32 gradients put on either side of a bf16 rounding boundary
    # differs by a bf16 step (2^-8 of it), which moves AdamW's normalised
    # step by up to ~2^-7 of lr each step: 3 * 1e-3 * 2^-7 = 2.3e-5
    tol = 3e-5 if grad_accum > 1 and compress == "bf16" else PARAM_TOL
    _close_trees(tp, jp, tol)
    _close_trees(to.mu, jo.mu, tol)


def test_an_moe_step_trains_the_router_and_leaves_the_aux_free_bias():
    """deepseek's aux-free router bias steers selection only: no gradient
    reaches it (zeros, as jax.grad gives), so AdamW's weight decay alone
    moves it — from 0 it stays 0."""
    _, _, tm, tp = pair("deepseek-v2-lite-16b", "float32")
    step = make_train_step(tm, lr_fn=lambda s: torch.tensor(1e-3))
    b = next(make_dataset(tm.cfg, seq_len=16, global_batch=2))
    before = tp["blocks"]["moe"]["router"].detach().clone()
    tp, _, met = step(tp, adamw_init(tp), {"tokens": torch.from_numpy(
        b["tokens"])})
    assert float(met["aux"]) > 0
    assert not torch.equal(tp["blocks"]["moe"]["router"], before)
    assert not tp["blocks"]["moe"]["router_bias"].any()


def test_serve_and_prefill_steps_call_the_model():
    _, _, tm, tp = pair("qwen3-1.7b", "float32")
    toks = torch.tensor([[5, 6, 7]])
    with torch.no_grad():
        logits, cache = make_prefill_step(tm, 8)(tp, toks)
        want, _ = tm.prefill(tp, toks, 8)
        assert torch.equal(logits, want)
        out, _ = make_serve_step(tm)(tp, cache, torch.tensor([[8]]),
                                     torch.tensor(3))
    assert out.shape == (1, 1, tm.cfg.padded_vocab)


# -- data ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["qwen3-1.7b", "seamless-m4t-large-v2"])
def test_data_batches_are_bit_identical_to_jax(arch):
    for seed in (0, 7):
        jd = jax_dataset(jconfigs.get_reduced(arch), seq_len=32,
                         global_batch=4, seed=seed)
        td = make_dataset(tconfigs.get_reduced(arch), seq_len=32,
                          global_batch=4, seed=seed)
        for _ in range(3):
            jb, tb = next(jd), next(td)
            assert jb.keys() == tb.keys()
            for k in jb:
                assert jb[k].dtype == tb[k].dtype
                np.testing.assert_array_equal(jb[k], tb[k])
        assert td.state() == jd.state() == {"step": 3, "seed": seed}


def test_data_resume_and_seed_check():
    cfg = tconfigs.get_reduced("qwen3-1.7b")
    ref = make_dataset(cfg, seq_len=16, global_batch=2, seed=3)
    stream = [next(ref)["tokens"] for _ in range(6)]
    d = make_dataset(cfg, seq_len=16, global_batch=2, seed=3)
    next(d), next(d)
    d2 = make_dataset(cfg, seq_len=16, global_batch=2, seed=3)
    d2.restore(d.state())
    np.testing.assert_array_equal(next(d2)["tokens"], stream[2])
    with pytest.raises(ValueError):
        d2.restore({"step": 0, "seed": 4})


# -- checkpoints ------------------------------------------------------------------

def test_checkpoints_cross_between_the_packages_bit_identically(tmp_path):
    rng = np.random.default_rng(0)
    jparams = {"w": jnp.asarray(rng.normal(size=(3, 4)), jnp.bfloat16),
               "b": {"c": jnp.asarray(rng.normal(size=(5,)), jnp.float32),
                     "i": jnp.arange(6, dtype=jnp.int32).reshape(2, 3)}}
    jopt = jax_adamw_init(jparams)._replace(step=jnp.asarray(7, jnp.int32))
    jstate = {"params": jparams, "opt": jopt, "data": {"step": 12,
                                                       "seed": 3}}
    tparams = from_jax_numpy(jax.tree.map(np.asarray, jparams),
                             device="cpu")
    topt = adamw_from_jax_numpy(jax.tree.map(np.asarray, jopt),
                                device="cpu")
    tstate = {"params": tparams, "opt": topt, "data": {"step": 12,
                                                       "seed": 3}}

    jax_save(jstate, tmp_path / "from_jax")
    save_pytree(tstate, tmp_path / "from_port")
    # the same files: index and every leaf's bytes
    ji = json.loads((tmp_path / "from_jax" / "index.json").read_text())
    ti = json.loads((tmp_path / "from_port" / "index.json").read_text())
    assert ji == ti
    assert {"opt/0", "opt/1/w", "opt/2/b/c", "params/w", "data/step"} <= \
        set(ti)
    assert ti["params/w"]["dtype"] == "bfloat16"
    for meta in ti.values():
        a = np.load(tmp_path / "from_jax" / meta["file"])
        b = np.load(tmp_path / "from_port" / meta["file"])
        assert a.dtype == b.dtype and np.array_equal(a, b)

    # the port reads JAX's; JAX reads the port's
    back = load_pytree(tstate, tmp_path / "from_jax", device="cpu")
    assert isinstance(back["opt"], AdamWState)
    for (path, got), (_, want) in zip(leaf_paths(back["params"]),
                                      leaf_paths(tparams)):
        assert got.dtype == want.dtype and torch.equal(got, want), path
    assert back["opt"].step.dtype == torch.int32 and int(
        back["opt"].step) == 7
    assert int(back["data"]["step"]) == 12
    jback = jax_load(jstate, tmp_path / "from_port")
    assert jback["params"]["w"].dtype == jnp.bfloat16
    for a, b in zip(jax.tree.leaves(jback), jax.tree.leaves(jstate)):
        assert np.array_equal(np.asarray(a), np.asarray(b))


def test_manager_atomic_keep_latest_and_restore_on_the_device(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=2, async_save=False)
    for step in (10, 20, 30):
        mgr.save(step, {"params": {"w": torch.full((2,), float(step))},
                        "meta": {"step": step}})
    assert mgr.latest_step() == 30
    kept = sorted(p.name for p in Path(tmp_path).glob("step_*"))
    assert kept == ["step_0000000020", "step_0000000030"]   # keep-K GC
    assert not list(Path(tmp_path).glob("*.tmp"))
    back = mgr.restore({"params": {"w": torch.zeros(2)}}, device="cpu")
    assert float(back["params"]["w"][0]) == 30
    assert back["meta"]["step"] == 30
    old = mgr.restore({"params": {"w": torch.zeros(2)}}, step=20,
                      device="cpu")
    assert float(old["params"]["w"][0]) == 20
    # JAX's manager reads the port's directory
    jback = JaxManager(tmp_path, async_save=False).restore(
        {"params": {"w": jnp.zeros((2,))}})
    assert float(jback["params"]["w"][1]) == 30


def test_async_save_snapshots_before_returning(tmp_path):
    """The host snapshot is taken in ``save``: a tensor changed right
    after is saved as it was."""
    mgr = CheckpointManager(tmp_path, keep=3, async_save=True)
    w = torch.ones(8)
    mgr.save(1, {"params": {"w": w}, "meta": {}})
    w.add_(1.0)
    mgr.wait()
    assert mgr.latest_step() == 1
    back = mgr.restore({"params": {"w": w}}, device="cpu")
    assert torch.equal(back["params"]["w"], torch.ones(8))
    with pytest.raises(FileNotFoundError):
        CheckpointManager(tmp_path / "empty").restore({}, device="cpu")


def test_a_failed_async_write_surfaces_on_wait(tmp_path):
    mgr = CheckpointManager(tmp_path / "ck", async_save=True)
    (tmp_path / "ck").rmdir()
    (tmp_path / "ck").write_text("not a directory")
    mgr.save(1, {"params": {"w": torch.ones(2)}, "meta": {}})
    with pytest.raises(RuntimeError, match="async checkpoint write failed"):
        mgr.wait()


# -- fault tolerance ----------------------------------------------------------------

def test_straggler_flagged_and_no_false_positives():
    mon = StragglerMonitor(min_samples=4, threshold=1.5)
    for _ in range(10):
        for h in ("h0", "h1", "h2", "h3"):
            mon.record(h, 1.0 if h != "h2" else 2.5)
    assert mon.check() == ["h2"]
    mon = StragglerMonitor(min_samples=4)
    for i in range(10):
        for h in ("h0", "h1"):
            mon.record(h, 1.0 + 0.01 * i)
    assert mon.check() == []
    with StepTimer() as t:
        pass
    assert t.last is not None and t.last >= 0


def test_preemption_flag_and_restore():
    prev = signal.getsignal(signal.SIGTERM)
    h = PreemptionHandler(signals=(signal.SIGTERM,))
    assert not h.preempted
    h._on_signal(signal.SIGTERM, None)
    assert h.preempted
    h.restore()
    assert signal.getsignal(signal.SIGTERM) is prev
