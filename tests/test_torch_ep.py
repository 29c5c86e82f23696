"""The port's expert parallelism (the ep axis, alone and with dp, tp and
fsdp) across processes, against the unsharded step and the loopback.

This file imports no JAX: the ranks that ``debug_launcher`` spawns import
their worker function from here. ONE launch of 4 gloo ranks (a module
fixture, in a thread) runs every case in turn while this process computes
the references, on ``MoELlamaConfig.tiny`` (vocab 128, 4 experts, top-2,
``capacity_factor`` 1.25 so that tokens drop) from the seed-0 init,
``adamw(3e-4)``, clip 1.0, three global batches of 4 x 16:

- the fused step on ep 2 x dp 2, ep 2 x tp 2 and ep 2 x fsdp 2: the losses
  (1e-5) and every parameter after 3 steps (rtol 1e-3, atol 1e-5, the pins
  of ``tests/test_torch_tp_dist.py``) against the unsharded step, and every
  leaf's gradient of the first batch (the buffer of an accumulation-2
  micro-step; rtol 1e-4, atol 1e-6), the router's, the attention weights'
  and the embedding's named: a rank's gate gradients for its own experts
  only, or a router loss counted once a rank, shows here as a missing or
  doubled term; the loopback of the same layout against the ranks (losses
  1e-5, parameters at the same pins);
- the imperative loop (``model(**rows)``, ``backward``,
  ``clip_grad_norm_``, ``step``) on ep 2 x dp 2, each data rank on its
  rows: the loss carries the router term and ``aux_loss``; the mean of the
  data ranks' losses against the unsharded fused step;
- ``save_state`` on ep 2 x fsdp 2 shards, and ``load_state(reshard=True)``
  of that checkpoint into the unsharded layout, bitwise;
- the nlp example's scheduled path (``examples/nlp_example.py``: its
  loaders, ``inject_hyperparams(adamw)``, ``linear_schedule``) at dp 4 over
  the 4 ranks against dp 1 on the same global batches of 4 x 32 rows: the
  losses and the parameters after each of 3 steps at 1e-5.
"""

import threading
from pathlib import Path

import numpy as np
import pytest
import torch

import accelerate_tpu_torch as T
from accelerate_tpu_torch.utils.tree import flatten_with_paths

N_RANKS = 4
CFG = dict(vocab_size=128)
LR = 3e-4
LOSS_ATOL = 1e-5
PARAM_RTOL, PARAM_ATOL = 1e-3, 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6
NLP_ATOL = 1e-5
LAUNCH_TIMEOUT = 600.0
LAYOUTS = {
    "ep2xdp2": dict(ep_size=2, dp_size=2),
    "ep2xtp2": dict(ep_size=2, tp_size=2, dp_size=1),
    "ep2xfsdp2": dict(ep_size=2, fsdp_size=2, dp_size=1),
}
CASES = tuple(("fused", n) for n in LAYOUTS) + (("imperative", "ep2xdp2"),
                                                ("checkpoint", "ep2xfsdp2"), ("nlp", None))


def step_batches():
    rng = np.random.default_rng(11)
    return [{"input_ids": ids, "labels": ids}
            for ids in (rng.integers(0, CFG["vocab_size"], (4, 16)).astype(np.int32)
                        for _ in range(3))]


def _model():
    model = T.MoELlama(T.MoELlamaConfig.tiny(**CFG), device="cpu")
    model.init_params(0)
    return model


def _full(pm):
    engine = pm.handle.sharded
    if engine is None:
        return {k: v.detach().numpy().copy() for k, v in flatten_with_paths(pm.params)}
    return {layout.path.replace("/", "."): engine.full_leaf(i).numpy().copy()
            for i, layout in enumerate(engine.layouts)}


def _grads(pm, po):
    """The buffer of one accumulation-2 micro-step, times 2: the gradient."""
    engine = pm.handle.sharded
    if engine is None:
        return {k: (2 * v).numpy() for k, v in flatten_with_paths(po.grads)}
    return {layout.path.replace("/", "."): (2 * engine.full_leaf(i, shards=engine.accum[i]))
            .numpy() for i, layout in enumerate(engine.layouts)}


def fused_run(layout=None, loopback=False):
    """Three fused steps (the losses and the full parameters) and, on a
    fresh accumulation-2 run, the gradient of the first batch."""
    def acc_of(**kw):
        if layout is None:
            return T.Accelerator(device="cpu", **kw)
        return T.Accelerator(device="cpu", parallelism_config=T.ParallelismConfig(
            **LAYOUTS[layout]), loopback=T.LoopbackShards(N_RANKS) if loopback else None, **kw)

    acc = acc_of()
    pm, po = acc.prepare(_model(), T.adamw(LR, device="cpu"))
    step = acc.build_train_step(pm, po)
    out = {"losses": np.asarray([float(step(b, clip_norm=1.0)) for b in step_batches()])}
    out.update({f"p.{k}": v for k, v in _full(pm).items()})
    acc = acc_of(gradient_accumulation_steps=2)
    pm, po = acc.prepare(_model(), T.adamw(LR, device="cpu"))
    acc.build_train_step(pm, po)(step_batches()[0], clip_norm=1.0)
    out.update({f"g.{k}": v for k, v in _grads(pm, po).items()})
    return out


def _imperative(layout):
    acc = T.Accelerator(device="cpu", parallelism_config=T.ParallelismConfig(**LAYOUTS[layout]))
    pm, po = acc.prepare(_model(), T.adamw(LR, device="cpu"))
    n_data, d = acc._dp_size_index()
    losses, aux = [], []
    for b in step_batches():
        per = b["input_ids"].shape[0] // n_data
        out = pm(**{k: v[d * per:(d + 1) * per] for k, v in b.items()})
        acc.backward(out["loss"])
        acc.clip_grad_norm_(pm, 1.0)
        po.step()
        po.zero_grad()
        losses.append(float(T.reduce(out["loss"].detach().clone(), reduction="mean",
                                     group=acc._dp_group())))
        aux.append(float(out["aux_loss"]))
    return {"losses": np.asarray(losses), "aux": np.asarray(aux),
            **{f"p.{k}": v for k, v in _full(pm).items()}}


def _checkpoint(layout, save_dir):
    acc = T.Accelerator(device="cpu", parallelism_config=T.ParallelismConfig(**LAYOUTS[layout]))
    pm, po = acc.prepare(_model(), T.adamw(LR, device="cpu"))
    step = acc.build_train_step(pm, po)
    for b in step_batches()[:2]:
        step(b, clip_norm=1.0)
    acc.save_state(save_dir)
    return {f"p.{k}": v for k, v in _full(pm).items()}


def nlp_steps(batch_size, steps=3):
    """The nlp example's scheduled path (``training_function``'s loop) for
    ``steps`` steps: each step's loss (the mean over the data ranks), the
    first step's global rows, and the parameters after each step."""
    from accelerate_tpu_torch.examples import nlp_example as ex

    acc = T.Accelerator(cpu=True)
    lr, vocab = 1e-3, 128
    T.set_seed(42, device=acc.device)
    model = T.BertForSequenceClassification(T.BertConfig.tiny(
        vocab_size=vocab, max_position_embeddings=ex.SEQ_LEN, hidden_dropout_prob=0.0),
        device=acc.device)
    model.init_params(42)
    train_dl, eval_dl = acc.prepare(*ex.get_dataloaders(batch_size, vocab))
    schedule = T.linear_schedule(lr, 0.1 * lr, 5 * len(train_dl))
    opt = T.inject_hyperparams(T.adamw)(learning_rate=lr, device=acc.device)
    model, opt, sched = acc.prepare(model, opt, schedule)
    out = {}
    train_dl.set_epoch(0)
    for i, batch in enumerate(train_dl):
        if i == steps:
            break
        if i == 0:
            out["rows"] = T.gather(batch["input_ids"]).numpy()
        with acc.accumulate(model):
            outputs = model(**batch)
            acc.backward(outputs["loss"])
            opt.step()
            sched.step()
            opt.zero_grad()
        out[f"loss{i}"] = np.asarray(float(T.reduce(outputs["loss"].detach().clone(),
                                                    reduction="mean")))
        out.update({f"p{i}.{k}": v.detach().numpy().copy()
                    for k, v in flatten_with_paths(model.params)})
    return out


def cases_worker(out_dir: str):
    import torch.distributed as dist

    torch.set_num_threads(1)
    rank = dist.get_rank()
    out = Path(out_dir)
    for kind, name in CASES:
        if kind == "fused":
            saved = fused_run(name)
        elif kind == "imperative":
            saved = _imperative(name)
        elif kind == "checkpoint":
            saved = _checkpoint(name, str(out / "ep_ckpt"))
        else:
            saved = nlp_steps(32)
        np.savez(out / f"{kind}_{name}.rank{rank}.npz", **saved)


def load_ranks(out_dir, name, n=N_RANKS):
    return [dict(np.load(Path(out_dir) / f"{name}.rank{r}.npz")) for r in range(n)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The one launch and, while the ranks train, the references."""
    out = tmp_path_factory.mktemp("ep_cases")
    failure = []

    def launch():
        try:
            T.debug_launcher(cases_worker, args=(str(out),), num_processes=N_RANKS,
                             timeout=LAUNCH_TIMEOUT)
        except Exception as exc:  # re-raised below
            failure.append(exc)

    thread = threading.Thread(target=launch)
    thread.start()
    try:
        torch.set_num_threads(2)
        unsharded = fused_run()
        loopbacks = {name: fused_run(name, loopback=True) for name in LAYOUTS}
        nlp = nlp_steps(4 * 32)
    finally:
        thread.join(timeout=LAUNCH_TIMEOUT + 60)
    assert not thread.is_alive(), "the gloo launch did not return"
    if failure:
        raise failure[0]
    return {"out": out, "unsharded": unsharded, "loopback": loopbacks, "nlp": nlp}


def _assert_params(got, want):
    keys = sorted(k for k in want if k.startswith("p."))
    assert keys == sorted(k for k in got if k.startswith("p.")) and len(keys) == 13
    for key in keys:
        np.testing.assert_allclose(got[key], want[key], rtol=PARAM_RTOL, atol=PARAM_ATOL,
                                   err_msg=key)


@pytest.mark.parametrize("name", sorted(LAYOUTS))
def test_ep_step_matches_the_unsharded_step(runs, name):
    want = runs["unsharded"]
    ranks = load_ranks(runs["out"], f"fused_{name}")
    for saved in ranks:
        np.testing.assert_allclose(saved["losses"], want["losses"], atol=LOSS_ATOL, rtol=0)
        assert np.array_equal(saved["losses"], ranks[0]["losses"])
        _assert_params(saved, want)


@pytest.mark.parametrize("name", sorted(LAYOUTS))
def test_ep_gradients_match_leaf_by_leaf(runs, name):
    """The router's, the attention weights' and the embedding's gradients
    (and every other leaf's) of the first batch on every rank."""
    want = {k: v for k, v in runs["unsharded"].items() if k.startswith("g.")}
    for key in ("g.layers.mlp.router", "g.layers.attn.wq", "g.layers.attn.wo",
                "g.embed.weight", "g.layers.mlp.w_gate"):
        assert key in want
    for saved in load_ranks(runs["out"], f"fused_{name}"):
        got = {k: v for k, v in saved.items() if k.startswith("g.")}
        assert sorted(got) == sorted(want)
        for key, w in want.items():
            np.testing.assert_allclose(got[key], w, rtol=GRAD_RTOL, atol=GRAD_ATOL, err_msg=key)


@pytest.mark.parametrize("name", sorted(LAYOUTS))
def test_loopback_matches_the_ranks(runs, name):
    want = load_ranks(runs["out"], f"fused_{name}")[0]
    got = runs["loopback"][name]
    np.testing.assert_allclose(got["losses"], want["losses"], atol=LOSS_ATOL, rtol=0)
    _assert_params(got, want)
    for key in (k for k in want if k.startswith("g.")):
        np.testing.assert_allclose(got[key], want[key], rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                   err_msg=key)


def test_imperative_loop_under_ep_matches_the_fused_step(runs):
    want = runs["unsharded"]
    for saved in load_ranks(runs["out"], "imperative_ep2xdp2"):
        np.testing.assert_allclose(saved["losses"], want["losses"], atol=LOSS_ATOL, rtol=0)
        assert np.isfinite(saved["aux"]).all() and (saved["aux"] > 0).all()
        _assert_params(saved, want)


def test_ep_checkpoint_loads_unsharded_bitwise(runs):
    ranks = load_ranks(runs["out"], "checkpoint_ep2xfsdp2")
    acc = T.Accelerator(device="cpu")
    pm, po = acc.prepare(_model(), T.adamw(LR, device="cpu"))
    acc.build_train_step(pm, po)
    acc.load_state(str(runs["out"] / "ep_ckpt"), reshard=True)
    loaded = _full(pm)
    for saved in ranks:
        for key, value in loaded.items():
            assert np.array_equal(saved[f"p.{key}"], value), key


def test_nlp_example_at_dp4_matches_dp1(runs):
    """Tentpole check of the example's dp 4 run: the same global rows, and
    the same losses and parameters after each step as dp 1 (so the 0.578
    of an 80-step dp 4 run on the card is the schedule's few steps, not a
    fault of the port's dp)."""
    want = runs["nlp"]
    for saved in load_ranks(runs["out"], "nlp_None"):
        assert np.array_equal(saved["rows"], want["rows"])
        for key, value in want.items():
            if key != "rows":
                np.testing.assert_allclose(saved[key], value, atol=NLP_ATOL, rtol=0,
                                           err_msg=key)
