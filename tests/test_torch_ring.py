"""Parity of the port's ring attention and sequence-parallel step with the JAX package's.

Inputs are numpy arrays from a seed, handed to both packages; everything
runs in f32 on the CPU.

- The dense blocks against ``accelerate_tpu.parallel.ring._dense_block_fwd``
  / ``_bwd``: atol 2e-5 (same einsums, another summation order).
- The plain twins of the ring-block kernels (``ring_block_fwd_reference`` /
  ``ring_block_bwd_reference``, merged by ``_merge``) against JAX's
  ``_flash_block_fwd`` / ``_flash_block_bwd``, which run the library flash
  kernel in Pallas interpret mode (``pltpu.force_tpu_interpret_mode``):
  C = 128, D = 64 and 128, modes 0, 1, 2, with and without a kv mask,
  merged into nonzero running stats. Forward atol 2e-5; backward atol 1e-5
  times the largest gradient (the kernel tiles its sums).
- The JAX test's own single-chip 2-chunk simulation of the ring
  (``tests/test_ring_attention.py:139-193``), run with the twins: against
  JAX's dense attention and its gradients, forward 2e-5 and gradients 1e-4
  relative to their largest value (f32 here, where the JAX test's 2e-2 is
  for the TPU kernel's bf16).
- ``LoopbackRing(4)`` against JAX ``ring_attention`` on the 8-device
  virtual mesh (sp = 4, dp = 2, dense blocks), with both of the port's
  block kinds: causal and non-causal, with and without padding; JAX's own
  tolerances, 2e-5 forward and 3e-4 gradients.
- The ``Accelerator`` sp step in 4 gloo processes (``debug_launcher``), as
  sp = 4 and as dp = 2 x sp = 2, from the JAX package's tiny Llama weights,
  against JAX's step on ``ParallelismConfig(sp_size=4, dp_size=2)``
  (``tests/test_ring_attention.py:90-107``), adamw(3e-4), clip 1.0, three
  steps on global (2, 32) batches, one with right padding: losses atol
  1e-5, parameters atol 5e-5 (the tolerances of ``test_torch_train.py``;
  Adam divides by sqrt(v), which magnifies a gradient's last-bit
  differences where it is near zero); every rank's parameters identical;
  the prepare-time refusals of JAX raise.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax
from jax.experimental.pallas import tpu as pltpu

from accelerate_tpu import Accelerator as JAccelerator
from accelerate_tpu.models.llama import Llama as JLlama, LlamaConfig as JConfig
from accelerate_tpu.ops.attention import dense_attention as j_dense_attention
from accelerate_tpu.parallel import ring as jring
from accelerate_tpu.parallel.mesh import ParallelismConfig as JParallelismConfig
from accelerate_tpu.state import AcceleratorState, PartialState

import accelerate_tpu_torch as T
from accelerate_tpu_torch.parallel import ring
from test_torch_ring_dist import load_ranks, sp_step_worker

torch.set_num_threads(2)

FWD_ATOL, BWD_REL = 2e-5, 1e-5
RING_FWD_ATOL, RING_GRAD_ATOL = 2e-5, 3e-4
LOSS_ATOL, PARAM_ATOL = 1e-5, 5e-5


def _t(x):
    return torch.as_tensor(np.array(x))


def _arrays(*shapes, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


# --------------------------------------------------------------- dense blocks
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("masked", [False, True])
def test_dense_blocks_match_jax(causal, masked):
    B, C, H, D = 2, 16, 4, 16
    q, k, v, do, a0 = _arrays(*[(B, C, H, D)] * 5)
    m0, l0, lse, delta = _arrays(*[(B, H, C)] * 4, seed=1)
    l0, lse = np.abs(l0) + 0.5, lse + 3.0
    mask = np.ones((B, C), np.int32)
    mask[0, 11:] = 0
    mask = mask if masked else None
    pos_q, pos_k = 2 * C + np.arange(C), C + np.arange(C)  # rank 2 sees block 1
    if not causal:
        pos_k = 3 * C + np.arange(C)
    jm = None if mask is None else jnp.asarray(mask)
    tm = None if mask is None else _t(mask)
    want = jring._dense_block_fwd(*map(jnp.asarray, (q, k, v)), jm, jnp.asarray(pos_q),
                                  jnp.asarray(pos_k), *map(jnp.asarray, (m0, l0, a0)), causal)
    got = ring._dense_block_fwd(*map(_t, (q, k, v)), tm, _t(pos_q), _t(pos_k),
                                *map(_t, (m0, l0, a0)), causal)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=FWD_ATOL, rtol=0)
    want = jring._dense_block_bwd(*map(jnp.asarray, (q, k, v)), jm, jnp.asarray(pos_q),
                                  jnp.asarray(pos_k), jnp.asarray(lse), jnp.asarray(do),
                                  jnp.asarray(delta), causal)
    got = ring._dense_block_bwd(*map(_t, (q, k, v)), tm, _t(pos_q), _t(pos_k), _t(lse), _t(do),
                                _t(delta), causal)
    for a, b in zip(got, want):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, atol=BWD_REL * np.abs(b).max(), rtol=0)


# ------------------------------------------------- twins vs the library kernel
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("mode", [0, 1, 2])
@pytest.mark.parametrize("D", [64, 128])
def test_plain_twins_match_jax_flash_blocks_in_interpret_mode(D, mode, masked):
    B, C, H = 1, 128, 2
    q, k, v, do, a0 = _arrays(*[(B, C, H, D)] * 5, seed=D + mode)
    m0, l0, lse, delta = _arrays(*[(B, H, C)] * 4, seed=7)
    l0, lse = np.abs(l0) + 0.5, lse + 3.0
    lse[0, 0, 5] = np.inf  # a row that saw no key anywhere: P = 0
    mask = None
    if masked:
        mask = np.ones((B, C), np.int32)
        mask[0, 100:] = 0
    jm = None if mask is None else jnp.asarray(mask)
    tm = None if mask is None else _t(mask)
    jmode = jnp.asarray(mode, jnp.int32)
    with pltpu.force_tpu_interpret_mode():
        want = jring._flash_block_fwd(*map(jnp.asarray, (q, k, v)), jm, jmode,
                                      *map(jnp.asarray, (m0, l0, a0)))
        want_bwd = jring._flash_block_bwd(
            *map(jnp.asarray, (q, k, v)), jm, jmode, jring._lse_to_l(jnp.asarray(lse)),
            jring._lse_to_m(jnp.asarray(lse)), jnp.asarray(do), jnp.asarray(delta))
    o, l, m = ring.ring_block_fwd_reference(*map(_t, (q, k, v)), tm, mode)
    got = ring._merge(*map(_t, (m0, l0, a0)), o, l, m)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=FWD_ATOL, rtol=0)
    acc = [torch.zeros((B, C, H, D)) for _ in range(3)]
    ring.ring_block_bwd_reference(*map(_t, (q, k, v)), tm, mode, ring._lse_to_m(_t(lse)), _t(do),
                                  _t(delta), *acc)
    for a, b in zip(acc, want_bwd):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, atol=BWD_REL * max(np.abs(b).max(), 1.0),
                                   rtol=0)


def test_two_chunk_simulation_of_the_jax_test_with_the_twins():
    """``test_flash_block_path_matches_dense_on_tpu`` step for step, with
    the port's twins and merge in place of the TPU kernel."""
    B, S, H, D = 2, 512, 4, 128
    C = S // 2
    q, k, v = _arrays(*[(B, S, H, D)] * 3)
    tq, tk, tv = map(_t, (q, k, v))
    qs, kc, vc = ([x[:, :C], x[:, C:]] for x in (tq, tk, tv))
    outs, lses = [], []
    for qi in range(2):
        m = torch.full((B, H, C), ring.NEG_INF)
        l = torch.zeros((B, H, C))
        acc = torch.zeros((B, C, H, D))
        for kj in range(2):
            rel = 0 if kj == qi else (1 if kj < qi else 2)
            m, l, acc = ring._merge(m, l, acc, *ring.ring_block_fwd_reference(
                qs[qi], kc[kj], vc[kj], None, rel))
        l_safe = torch.where(l > 0, l, 1.0)
        outs.append(acc / l_safe.transpose(1, 2)[..., None])
        lses.append(torch.where(l > 0, m + torch.log(l_safe), torch.inf))
    out = torch.cat(outs, 1)
    ref = np.asarray(j_dense_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                       causal=True))
    np.testing.assert_allclose(out.numpy(), ref, atol=FWD_ATOL, rtol=0)
    g_ref = jax.grad(lambda q, k, v: (j_dense_attention(q, k, v, causal=True) ** 2).sum(),
                     argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    dout = 2 * _t(ref)
    delta = (out * dout).sum(-1).transpose(1, 2)
    dq, dk, dv = ([torch.zeros((B, C, H, D)) for _ in range(2)] for _ in range(3))
    for qi in range(2):
        for kj in range(2):
            rel = 0 if kj == qi else (1 if kj < qi else 2)
            ring.ring_block_bwd_reference(
                qs[qi], kc[kj], vc[kj], None, rel, ring._lse_to_m(lses[qi]),
                dout[:, qi * C:(qi + 1) * C], delta[..., qi * C:(qi + 1) * C].contiguous(),
                dq[qi], dk[kj], dv[kj])
    for mine, want in zip((torch.cat(dq, 1), torch.cat(dk, 1), torch.cat(dv, 1)), g_ref):
        want = np.asarray(want)
        rel = np.abs(mine.numpy() - want).max() / max(np.abs(want).max(), 1e-6)
        assert rel < 1e-4, rel


# ---------------------------------------------------- the whole ring vs JAX's
@pytest.mark.parametrize("block_impl", ["dense", "flash"])
@pytest.mark.parametrize("causal,masked", [(True, False), (False, False), (True, True),
                                           (False, True)])
def test_loopback_ring_matches_jax_ring_attention(causal, masked, block_impl):
    state = PartialState()
    cfg = JParallelismConfig(sp_size=4, dp_size=2)
    mesh = cfg.build_mesh()
    state.set_mesh(mesh, cfg)
    B, S, H, D = 2, 32, 4, 16
    q, k, v = _arrays(*[(B, S, H, D)] * 3)
    mask = None
    if masked:
        mask = np.ones((B, S), np.int32)
        mask[0, 24:] = 0
        mask[1, 13:] = 0

    def loss_jax(q, k, v):
        out = jring.ring_attention(q, k, v, causal=causal, mesh=mesh, block_impl="dense",
                                   mask=None if mask is None else jnp.asarray(mask))
        return (out ** 2).sum(), out

    (_, want), g_want = jax.value_and_grad(loss_jax, argnums=(0, 1, 2), has_aux=True)(
        *map(jnp.asarray, (q, k, v)))
    leaves = [[s.clone().requires_grad_() for s in _t(x).chunk(4, dim=1)] for x in (q, k, v)]
    outs = ring.ring_attention(*leaves, causal=causal, group=ring.LoopbackRing(4),
                               mask=None if mask is None else list(_t(mask).chunk(4, dim=1)),
                               block_impl=block_impl)
    sum((o ** 2).sum() for o in outs).backward()
    np.testing.assert_allclose(torch.cat(outs, 1).detach().numpy(), np.asarray(want),
                               atol=RING_FWD_ATOL, rtol=0)
    for shards, g in zip(leaves, g_want):
        np.testing.assert_allclose(torch.cat([s.grad for s in shards], 1).numpy(),
                                   np.asarray(g), atol=RING_GRAD_ATOL, rtol=0)


# ------------------------------------------------- the sp step vs JAX's step
def _sp_batches():
    rng = np.random.default_rng(11)
    out = []
    for i in range(3):
        ids = rng.integers(0, 256, (2, 32)).astype(np.int32)
        batch = {"input_ids": ids, "labels": ids}
        if i == 1:  # right padding that ends inside a shard of row 1
            mask = np.ones((2, 32), np.int32)
            mask[1, 21:] = 0
            batch["attention_mask"] = mask
        out.append(batch)
    return out


@pytest.fixture(scope="module")
def jax_sp_reference():
    AcceleratorState._reset_state(reset_partial_state=True)
    jacc = JAccelerator(mixed_precision="no",
                        parallelism_config=JParallelismConfig(sp_size=4, dp_size=2))
    jm = JLlama(JConfig.tiny(attention_impl="ring"))
    jm.init_params(jax.random.key(0))
    start = jax.tree_util.tree_map(np.asarray, jm.params)
    jpm, jpo = jacc.prepare(jm, optax.adamw(3e-4))
    jstep = jacc.build_train_step(jpm, jpo)
    losses = np.asarray([float(jstep(b, clip_norm=1.0)) for b in _sp_batches()])
    params = [np.asarray(p) for p in jax.tree_util.tree_leaves(jpm.handle.params)]
    AcceleratorState._reset_state(reset_partial_state=True)
    return start, losses, params


LAYOUTS = {"sp4": (4, 1), "dp2xsp2": (2, 2)}


@pytest.fixture(scope="module")
def port_sp_runs(jax_sp_reference, tmp_path_factory):
    """``run(layout)``: the four ranks' saved results, one launch a layout."""
    cache = {}

    def run(layout):
        if layout not in cache:
            sp, dp = LAYOUTS[layout]
            out = tmp_path_factory.mktemp(layout)
            T.debug_launcher(sp_step_worker, args=(str(out), sp, dp, jax_sp_reference[0],
                                                   _sp_batches(), layout == "sp4"),
                             num_processes=4)
            cache[layout] = load_ranks(out)
        return cache[layout]

    return run


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_sp_step_losses_match_jax(port_sp_runs, jax_sp_reference, layout):
    for saved in port_sp_runs(layout):
        np.testing.assert_allclose(saved["losses"], jax_sp_reference[1], atol=LOSS_ATOL, rtol=0)


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_sp_step_params_match_jax(port_sp_runs, jax_sp_reference, layout):
    ranks, want = port_sp_runs(layout), jax_sp_reference[2]
    assert len([k for k in ranks[0] if k.startswith("param")]) == len(want) == 12
    for i, w in enumerate(want):
        np.testing.assert_allclose(ranks[0][f"param{i}"], w, atol=PARAM_ATOL, rtol=0)


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_sp_step_every_rank_holds_identical_params(port_sp_runs, layout):
    ranks = port_sp_runs(layout)
    sp, dp = LAYOUTS[layout]
    # rank = dp_index * sp + sp_index, the JAX package's axis order (the
    # mesh's pp axis before them and fsdp and ep axes between them have size 1).
    assert [tuple(r["coordinate"]) for r in ranks] == [(0, i // sp, 0, 0, i % sp, 0)
                                                        for i in range(4)]
    for saved in ranks[1:]:
        for key, value in ranks[0].items():
            if key.startswith("param") or key == "losses":
                assert np.array_equal(saved[key], value), key


def test_sp_prepare_refuses_what_jax_refuses(port_sp_runs):
    for saved in port_sp_runs("sp4"):
        for name in ("window", "layer_windows", "softcap", "query_scale", "flash_impl"):
            assert bool(saved[f"refused_{name}"]), name
