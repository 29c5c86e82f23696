"""Guards on the PyTorch port as a package.

- No module of ``accelerate_tpu_torch``, and not ``chip_smoke.py``, imports
  ``jax`` or ``accelerate_tpu`` (an AST scan of every import statement).
- Entry points run on the card by default and raise without one unless the
  caller passes ``device="cpu"``; nothing drops to the CPU quietly.
- The CUDA kernel wrappers refuse CPU tensors; only the registry routes CPU
  tensors (or an explicit ``kernels="off"``) to the plain version.
- Options not ported yet raise ``NotImplementedError``, never a silent
  fallback.
- Kernel vs plain version on the card, for every kernel, and the training
  step's kernel arm against its ``kernels="off"`` arm: marked ``cuda``,
  skipped on hosts without a GPU (chip_smoke.py runs the same comparisons at
  the Llama-3-8B shapes on the card). They live here because this file
  imports no JAX, which the card's machine does not have.
"""

import ast
import math
from pathlib import Path

import numpy as np
import pytest
import torch

import accelerate_tpu_torch as T
from accelerate_tpu_torch import optim
from accelerate_tpu_torch.utils.tree import tree_leaves
from chip_smoke import (
    CKPT_AT,
    CKPT_STEPS,
    FLASH_BWD_REL,
    FLASH_FWD_TILE_REL,
    PAGED_DECODE_ROW_REL,
    ckpt_build,
    ckpt_diff,
    ckpt_state,
    ckpt_steps,
    engine_forwards,
    plain_without_cap_derivative,
    row_rel_err,
    splash_grad_rel,
    tile_rel_err,
)
from accelerate_tpu_torch.ops import registry
from accelerate_tpu_torch.ops.attention import (
    flash_attention_reference,
    splash_attention_reference,
)
from accelerate_tpu_torch.ops.kernels import _build
from accelerate_tpu_torch.ops.fused_update import leaf_update, plan_fused_update
from accelerate_tpu_torch.ops.int8 import int8_matmul_reference
from accelerate_tpu_torch.ops.kernels.flash_attention import flash_attention_cuda
from accelerate_tpu_torch.ops.kernels.fused_update import fused_update_cuda
from accelerate_tpu_torch.ops.kernels.int8_matmul import (
    int8_matmul_cuda,
    quotient_disagreements as int8_matmul_quotient_disagreements,
)
from accelerate_tpu_torch.ops.kernels.paged_decode import paged_decode_cuda
from accelerate_tpu_torch.ops.kernels.paged_decode import plan as plan_paged_decode
from accelerate_tpu_torch.ops.kernels.paged_gather import paged_gather
from accelerate_tpu_torch.ops.kernels.ring_block import ring_block_bwd_cuda, ring_block_fwd_cuda
from accelerate_tpu_torch.ops.kernels.splash_attention import splash_attention_cuda
from accelerate_tpu_torch.ops.paged_attention import gather_block_view, paged_attention_plain

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_port_never_imports_jax_or_the_jax_package():
    files = sorted((ROOT / "accelerate_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    scanned = {f.relative_to(ROOT / "accelerate_tpu_torch").as_posix() for f in files[:-1]}
    assert {"data_loader.py", "scheduler.py", "optimizer.py", "ops/norms.py", "models/bert.py",
            "utils/operations.py", "utils/tqdm.py", "utils/memory.py", "utils/random.py",
            "examples/nlp_example.py", "checkpointing.py", "tracking.py", "logging.py",
            "utils/other.py", "utils/safetensors_io.py", "utils/constants.py",
            "examples/complete_nlp_example.py", "big_modeling.py", "hooks.py",
            "utils/modeling.py", "utils/offload.py", "utils/quantization.py",
            "models/vision.py", "examples/cv_example.py",
            "examples/complete_cv_example.py", "launchers.py", "utils/environment.py",
            "utils/imports.py", "commands/__init__.py", "commands/accelerate_cli.py",
            "commands/config.py", "commands/config_args.py", "commands/env.py",
            "commands/estimate.py", "commands/launch.py", "commands/menu.py",
            "commands/merge.py", "commands/test.py", "test_utils/__init__.py",
            "test_utils/test_script.py", "test_utils/training.py"} <= scanned
    bad = [(f.relative_to(ROOT).as_posix(), mod) for f in files for mod in _imports(f)
           if mod.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "accelerate_tpu")]
    assert bad == []


def test_entry_points_raise_without_cuda_unless_cpu_requested(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = T.LlamaConfig.tiny()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        T.Llama(cfg)
    model = T.Llama(cfg, device="cpu")
    model.init_params(0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        T.init_kv_pool(model, 4, 4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        T.generate(model, np.ones((1, 3), np.int32), max_new_tokens=2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        T.ContinuousBatcher(model, batch_slots=2, max_new_tokens=2, max_cache_len=64)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        T.Accelerator()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        T.Accelerator(mixed_precision="bf16")
    for make in (lambda: T.adamw(3e-4), lambda: T.adam(1e-3), lambda: T.sgd(0.1),
                 lambda: T.sgd(0.1, momentum=0.9), lambda: T.optim.chain(T.optim.Scale(-1.0))):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        T.set_seed(0)
    # The canonical loop's entry points (slice 11).
    bert_cfg = T.BertConfig.tiny()
    loader = torch.utils.data.DataLoader(list(range(8)), batch_size=4)
    for make in (lambda: T.BertForSequenceClassification(bert_cfg),
                 lambda: T.inject_hyperparams(T.adamw)(learning_rate=1e-3),
                 lambda: T.adamw(T.linear_schedule(1e-3, 0.0, 10)),
                 lambda: T.prepare_data_loader(loader),
                 lambda: T.Accelerator(cpu=False)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
    assert T.Accelerator(cpu=True).device.type == "cpu"
    assert T.prepare_data_loader(loader, device="cpu").device.type == "cpu"
    assert T.resolve_device("cpu").type == "cpu"
    # The training entry points run end to end when the CPU is asked for.
    acc = T.Accelerator(device="cpu")
    pm, po = acc.prepare(model, T.adamw(3e-4, device="cpu"))
    step = acc.build_train_step(pm, po)
    ids = np.arange(1, 9, dtype=np.int32)[None]
    assert bool(torch.isfinite(step({"input_ids": ids, "labels": ids})))
    assert T.set_seed(0, device="cpu").device.type == "cpu"
    # The explicit CPU request works end to end.
    engine = T.ContinuousBatcher(model, batch_slots=2, max_new_tokens=2, max_cache_len=64,
                                 bucket_sizes=(8,), block_size=4, device="cpu")
    rid = engine.submit(np.arange(1, 4))
    assert engine.run()[rid].shape == (2,)


def test_kernel_wrapper_refuses_cpu_tensors_and_counts_nothing():
    registry.reset_launch_counts()
    pool = torch.zeros((2, 5, 4, 2, 16))
    tables = torch.zeros((2, 3), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA tensors"):
        paged_gather(pool, tables)
    q = torch.zeros((1, 128, 2, 64), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA tensors"):
        flash_attention_cuda(q, q, q)
    plan = plan_fused_update(T.adamw(3e-4, device="cpu"))
    p, one = torch.zeros(8), torch.ones(())
    with pytest.raises(ValueError, match="CUDA tensors"):
        fused_update_cuda(p, p.clone(), (p.clone(), p.clone()), one, one, one, plan=plan)
    with pytest.raises(ValueError, match="CUDA tensors"):
        int8_matmul_cuda(torch.zeros((2, 8)), torch.zeros((8, 4)))
    with pytest.raises(ValueError, match="CUDA tensors"):
        paged_decode_cuda(torch.zeros((2, 1, 4, 16)), pool[0], pool[0], tables,
                          q_positions=torch.zeros((1,), dtype=torch.int32))
    with pytest.raises(ValueError, match="CUDA tensors"):
        ring_block_fwd_cuda(q, q, q, None, 0)
    f32 = torch.zeros((1, 2, 128))
    acc = torch.zeros((1, 128, 2, 64))
    with pytest.raises(ValueError, match="CUDA tensors"):
        ring_block_bwd_cuda(q, q, q, None, 1, f32, q, f32, acc, acc, acc)
    assert registry.launch_counts == {}
    assert registry.known_ops() == ("flash_attention", "fused_update", "int8_matmul",
                                    "paged_decode", "paged_gather", "ring_block_bwd",
                                    "ring_block_fwd", "splash_attention")
    with pytest.raises(KeyError):
        registry.dispatch("no_such_op", pool)


def test_splash_wrapper_refuses_cpu_tensors_and_counts_nothing():
    """The registry routes CPU tensors to the plain version; the wrapper
    itself refuses them."""
    registry.reset_launch_counts()
    q = torch.zeros((1, 128, 2, 64), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA tensors"):
        splash_attention_cuda(q, q, q, window=32, softcap=5.0)
    assert registry.launch_counts == {}


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    assert _build.sources() == ["flash_attention", "fused_update", "int8_matmul", "paged_decode",
                                "paged_gather", "splash_attention"]
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()


def test_library_name_hashes_the_shared_headers(monkeypatch, tmp_path):
    """A source's library name changes with any ``csrc/*.cuh``, so a header
    edit never loads a stale build; both attention sources include the
    shared headers they use (the common helpers and the Hopper ones)."""
    for name in ("flash_attention", "splash_attention"):
        text = (_build.CSRC / f"{name}.cu").read_text()
        assert '#include "attn_common.cuh"' in text
        assert '#include "hopper_common.cuh"' in text
    (tmp_path / "k.cu").write_text('#include "h.cuh"\n')
    (tmp_path / "h.cuh").write_text("// one\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    first = _build.library_path("k")
    assert _build.library_path("k") == first
    (tmp_path / "h.cuh").write_text("// two\n")
    assert _build.library_path("k") != first
    assert _build.sources() == ["k"]


@pytest.mark.parametrize("option,match", [
    (dict(speculative_k=2), "speculative"),
    (dict(draft_model=object()), "speculative"),
    (dict(slo=object()), "slo"),
    (dict(paged=False), "paged=False"),
    (dict(trace_requests=True), "tracer"),
])
def test_unported_engine_options_raise(option, match):
    model = T.Llama(T.LlamaConfig.tiny(), device="cpu")
    model.init_params(0)
    with pytest.raises(NotImplementedError, match=match):
        T.ContinuousBatcher(model, batch_slots=2, max_new_tokens=2, max_cache_len=64,
                            device="cpu", **option)


@pytest.mark.parametrize("option", [dict(num_beams=2), dict(assistant_model=object())])
def test_unported_generate_options_raise(option):
    model = T.Llama(T.LlamaConfig.tiny(), device="cpu")
    model.init_params(0)
    with pytest.raises(NotImplementedError):
        T.generate(model, np.ones((1, 3), np.int32), max_new_tokens=2, device="cpu", **option)


@pytest.mark.cuda
@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8-dequant"])
def test_kernel_matches_plain_version_on_the_card(quant):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; chip_smoke.py runs this comparison on the card")
    g = torch.Generator(device="cuda").manual_seed(0)
    L, N, bs, H, D, B, M = 4, 33, 16, 8, 128, 6, 5
    if quant:
        pool = torch.randint(-127, 128, (L, N, bs, H, D), generator=g, device="cuda",
                             dtype=torch.int8)
        scales = torch.rand((L, N, bs), generator=g, device="cuda")
    else:
        pool = torch.randn((L, N, bs, H, D), generator=g, device="cuda", dtype=torch.bfloat16)
        scales = None
    tables = torch.randint(0, N, (B, M), generator=g, device="cuda", dtype=torch.int32)
    active = torch.tensor([1, 0, 1, 1, 0, 1], dtype=torch.bool, device="cuda")
    kw = dict(active=active, scales=scales, out_dtype=torch.bfloat16 if quant else None)
    registry.reset_launch_counts()
    got = paged_gather(pool, tables, **kw)
    ref = gather_block_view(pool, tables, **kw)
    torch.cuda.synchronize()
    assert registry.launch_counts == {"paged_gather_dequant" if quant else "paged_gather": 1}
    assert torch.equal(got[:, active].view(torch.int16), ref[:, active].view(torch.int16))
    assert bool((got[:, ~active] == 0).all())


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; chip_smoke.py runs this comparison on the card")


# Flash cases on the card: (S, pads of batch row 1 as slices, or None).
# The kernels work in 128-row tiles over S that is a multiple of 64: an odd
# multiple leaves the last tile half past the end, and padding may start or
# stop inside a tile.
FLASH_CARD_CASES = {
    "causal": (256, None),
    "padded": (256, [slice(-50, None)]),
    "ragged-192": (192, None),
    "ragged-1088": (1088, [slice(-300, None)]),
    "pads-inside-tiles": (320, [slice(0, 100), slice(270, None)]),
}


def _flash_card_inputs(S, pads, D, B=2, H=4, seed=0):
    g = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v, do = (torch.randn((B, S, H, D), generator=g, device="cuda", dtype=torch.bfloat16)
                   for _ in range(4))
    seg = None
    if pads is not None:
        seg = torch.full((B, S), 2, dtype=torch.int32, device="cuda")
        for pad in pads:
            seg[1, pad] = 1
    return q, k, v, do, seg


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(FLASH_CARD_CASES))
@pytest.mark.parametrize("D", [64, 128])
def test_flash_kernel_matches_plain_version_on_the_card(case, D):
    """bf16 in and out; the kernel rounds P to bf16 before P.V and the
    plain version does not, and both round the output to bf16, each a
    relative error of about 2^-9 an element. Outputs shrink along a causal
    sequence, so the forward is held per 64-row query tile of real-token
    rows: relative Frobenius error <= 1e-2 in every tile; gradients'
    relative Frobenius error <= 2e-2 (chip_smoke.py holds the 8B shapes to
    the same pins)."""
    _needs_card()
    B = 2
    S, pads = FLASH_CARD_CASES[case]
    q, k, v, do, seg = _flash_card_inputs(S, pads, D, B=B)
    scale = 1.0 / math.sqrt(D)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    ref_leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    registry.reset_launch_counts()
    out = flash_attention_cuda(*leaves, segment_ids=seg, causal=True, sm_scale=scale)
    out.backward(do)
    ref = flash_attention_reference(*ref_leaves, segment_ids=seg, causal=True, sm_scale=scale)
    ref.backward(do)
    torch.cuda.synchronize()
    assert registry.launch_counts == {"flash_attention_fwd": 1, "flash_attention_bwd": 1}
    real = torch.ones((B, S), dtype=torch.bool, device="cuda") if seg is None else seg == 2
    assert tile_rel_err(out.detach(), ref.detach(), real) <= 1e-2
    for a, b in zip(leaves, ref_leaves):
        rel = float((a.grad.float() - b.grad.float()).norm() / b.grad.float().norm())
        assert rel <= 2e-2


@pytest.mark.cuda
@pytest.mark.parametrize("op", ["flash", "ring_block"])
def test_flash_backward_is_deterministic_on_the_card(op):
    """The backward has one writer per output element and no atomics, so
    two runs on the same inputs agree bit for bit (the four-card ring's
    bitwise check against the loopback ring rests on this)."""
    _needs_card()
    from accelerate_tpu_torch.ops.kernels import flash_attention as fk

    S, pads = FLASH_CARD_CASES["ragged-1088"]
    q, k, v, do, seg = _flash_card_inputs(S, pads, 128)
    runs = []
    for _ in range(2):
        if op == "flash":
            o, lse = fk._forward(q, k, v, seg, True, 1.0 / math.sqrt(128))
            runs.append(fk._backward(q, k, v, seg, o, lse, do, True, 1.0 / math.sqrt(128)))
        else:
            mask = None if seg is None else (seg == 2).to(torch.int32)
            o, l, m = ring_block_fwd_cuda(q, k, v, mask, 1)
            lse = (m + torch.log(l.clamp(min=1e-30))).contiguous()
            delta = (o.float() * do.float()).sum(-1).transpose(1, 2).contiguous()
            acc = [torch.zeros(q.shape, device="cuda") for _ in range(3)]
            ring_block_bwd_cuda(q, k, v, mask, 1, lse, do, delta, *acc)
            runs.append(acc)
    torch.cuda.synchronize()
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["adamw", "adam", "sgd", "sgd_momentum"])
@pytest.mark.parametrize("n", [0, 1, 4097, 1 << 20])
def test_fused_update_kernel_matches_plain_version_on_the_card(family, n):
    """Bitwise: both round every f32 operation on its own, in one order."""
    _needs_card()
    tx = {"adamw": optim.adamw(3e-4, weight_decay=0.01), "adam": optim.adam(0.1),
          "sgd": optim.sgd(0.1), "sgd_momentum": optim.sgd(0.1, momentum=0.9)}[family]
    plan = plan_fused_update(tx)
    gen = torch.Generator(device="cuda").manual_seed(0)
    p = torch.randn(n, generator=gen, device="cuda")
    g = torch.randn(n, generator=gen, device="cuda")
    moments = tuple(torch.rand(n, generator=gen, device="cuda")
                    for _ in range({"adam": 2, "sgd_momentum": 1, "sgd": 0}[plan.kind]))
    p2, g2, moments2 = p.clone(), g.clone(), tuple(m.clone() for m in moments)
    factor = torch.tensor(0.7, device="cuda")
    bc1, bc2 = torch.tensor(0.271, device="cuda"), torch.tensor(0.002997, device="cuda")
    registry.reset_launch_counts()
    fused_update_cuda(p, g, moments, factor, bc1, bc2, plan=plan)
    leaf_update(p2, g2, moments2, factor, bc1, bc2, plan=plan)
    torch.cuda.synchronize()
    assert registry.launch_counts == ({f"fused_{plan.describe()}_update": 1} if n else {})
    assert torch.equal(p.view(torch.int32), p2.view(torch.int32))
    assert all(torch.equal(a.view(torch.int32), b.view(torch.int32))
               for a, b in zip(moments, moments2))
    assert bool((g == 0).all()) and bool((g2 == 0).all())


@pytest.mark.cuda
def test_train_step_on_the_card_matches_kernels_off():
    """bf16 training on the card with ``attention_impl="flash"``: the kernel
    arm launches flash fwd/bwd once per layer per micro-step and the fused
    adamw update once per leaf per update; its losses agree with the plain
    arm's to 2e-2 (bf16 compute, losses about 5.5)."""
    _needs_card()
    widths = dict(hidden_size=256, num_attention_heads=4, num_key_value_heads=2,
                  attention_impl="flash")
    rng = np.random.default_rng(5)
    batches = []
    for _ in range(3):
        ids = rng.integers(0, 256, (8, 128)).astype(np.int32)
        batches.append({"input_ids": ids, "labels": ids})
    losses = {}
    for spec in (None, "off"):
        model = T.Llama(T.LlamaConfig.tiny(**widths))
        model.init_params(0)
        acc = T.Accelerator(mixed_precision="bf16", kernels=spec)
        pm, po = acc.prepare(model, T.adamw(3e-4))
        step = acc.build_train_step(pm, po)
        registry.reset_launch_counts()
        losses[spec] = [float(step(b, clip_norm=1.0)) for b in batches]
        if spec is None:
            L = model.config.num_hidden_layers
            assert registry.launch_counts == {"flash_attention_fwd": 3 * L,
                                              "flash_attention_bwd": 3 * L,
                                              "fused_adamw_update": 3 * 12}
        else:
            assert registry.launch_counts == {}
    np.testing.assert_allclose(losses[None], losses["off"], atol=2e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dtype,N", [
    ((2, 17, 33), torch.float32, 29), ((8, 16), torch.bfloat16, 29),
    ((300, 64), torch.float32, 300), ((16, 256, 384), torch.bfloat16, 160),
    ((8, 4096), torch.bfloat16, 1024),  # one decode step's wk projection at Llama-3-8B width
    # Llama-3-8B's gate (4096 x 14336) and w_down (14336 x 4096) at a decode
    # step (8 rows) and a prefill chunk (128 rows); rows of 24 (tiles of 32);
    # K = 4100, not a multiple of the kernel's 128-deep blocks.
    ((8, 4096), torch.bfloat16, 14336), ((8, 14336), torch.bfloat16, 4096),
    ((128, 4096), torch.bfloat16, 14336), ((128, 14336), torch.bfloat16, 4096),
    ((3, 8, 4096), torch.bfloat16, 1024), ((8, 4100), torch.bfloat16, 1024),
], ids=["odd-3d-f32", "bf16", "tiles-f32", "chunk-bf16", "llama-wk-bf16", "llama-gate-m8",
        "llama-down-m8", "llama-gate-m128", "llama-down-m128", "rows-24-bf16", "ragged-k-4100"])
def test_int8_matmul_kernel_bitwise_equals_plain_version_on_the_card(shape, dtype, N):
    """Bitwise: the integer contraction is exact, and the scale, rounding and
    rescale are the same correctly rounded f32 operations in one order."""
    _needs_card()
    g = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(shape, generator=g, device="cuda").to(dtype)
    w = torch.randn((shape[-1], N), generator=g, device="cuda").to(dtype)
    x[..., 1, :] = 0  # an all-zero row: scale 1
    registry.reset_launch_counts()
    got = int8_matmul_cuda(x, w)
    ref = int8_matmul_reference(x, w)
    torch.cuda.synchronize()
    assert registry.launch_counts == {"int8_matmul": 1}
    assert got.dtype == ref.dtype == dtype and got.shape == ref.shape
    bits = torch.int16 if dtype == torch.bfloat16 else torch.int32
    assert torch.equal(got.view(bits), ref.view(bits))


@pytest.mark.cuda
def test_int8_matmul_division_self_check_on_the_card():
    """The kernel's bf16 division (``__fdiv_rn``'s fast path with the
    reciprocal formed once a column) agrees with ``__fdiv_rn`` over every
    61st significand of the scale and every bf16 value it meets;
    chip_smoke.py runs all 2^23 significands."""
    _needs_card()
    bad, pairs = int8_matmul_quotient_disagreements(stride=61)
    assert bad == 0 and pairs == -(-(1 << 23) // 61) * 11 * 128


PAGED_GEOMETRIES = {  # B, N, Hkv, H, M, chain lengths in blocks (0: inactive)
    "small": (6, 40, 2, 8, 5, (5, 0, 3, 1, 0, 4)),
    "llama-m256": (6, 1100, 8, 32, 256, (256, 0, 200, 129, 0, 256)),
    "one-slot-4096": (1, 300, 8, 32, 256, (256,)),
}


def _paged_case(quant, dtype, S=1, seed=0, geometry="small"):
    """A pool with ragged chains, trash-block tails, mask holes and the
    inactive slots the geometry names (chain length 0), made on the card."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    B, N, Hkv, H, M, lengths = PAGED_GEOMETRIES[geometry]
    bs, D = 16, 128
    rng = np.random.default_rng(seed)
    tables = np.zeros((B, M), np.int32)
    free = rng.permutation(np.arange(1, N))
    pos = np.zeros((B, S), np.int32)
    for b, n in enumerate(lengths):
        tables[b, :n], free = free[:n], free[n:]
        pos[b] = max(n * bs - S, 0) + np.arange(S)
    mask = (rng.random((N, bs)) > 0.2).astype(np.int32)
    mask[0] = 0
    if quant:
        k, v = (torch.randint(-127, 128, (N, bs, Hkv, D), generator=g, device="cuda",
                              dtype=torch.int8) for _ in range(2))
        scales = dict(k_scale=torch.rand((N, bs), generator=g, device="cuda") * 0.05,
                      v_scale=torch.rand((N, bs), generator=g, device="cuda") * 0.05)
    else:
        k, v = (torch.randn((N, bs, Hkv, D), generator=g, device="cuda").to(dtype)
                for _ in range(2))
        scales = {}
    q = torch.randn((B, S, H, D), generator=g, device="cuda").to(dtype)
    active = torch.tensor([n > 0 for n in lengths], dtype=torch.bool, device="cuda")
    kw = dict(q_positions=torch.tensor(pos, device="cuda"), active=active,
              pool_mask=torch.tensor(mask, device="cuda"), **scales)
    return (q, k, v, torch.tensor(tables, device="cuda")), kw, active


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["bf16", "int8-pool", "f32", "bf16-window-softcap",
                                  "int8-window-chunk", "no-mask", "llama-m256",
                                  "llama-m256-int8", "one-slot-4096", "split-cuts-window",
                                  "no-visible-key"])
def test_paged_decode_kernel_matches_plain_version_on_the_card(case):
    """Per (slot, query, head) row, the relative L2 error against the plain
    version is at most 1e-2 (the kernel sums in another order; chip_smoke.py
    holds the Llama-3-8B geometry to the same pin); inactive slots are
    exact zeros. ``llama-m256`` and ``one-slot-4096``: Llama-3-8B's 32/8
    heads of 128 on 4096-token chains, over several splits; in
    ``split-cuts-window`` (S = 3, a window of 20 valid slots) every block is
    a split, so the window's edge crosses a split boundary over the mask's
    holes; in ``no-visible-key`` slot 0's chain is all holes and slot 2's
    query sits at -1, so their rows see no key and take the plain version's
    uniform answer."""
    _needs_card()
    quant = case.startswith("int8") or case.endswith("int8")
    dtype = torch.float32 if case == "f32" else torch.bfloat16
    geometry = next((g for g in PAGED_GEOMETRIES if case.startswith(g)), "small")
    S = 3 if "chunk" in case or case == "split-cuts-window" else 1
    args, kw, active = _paged_case(quant, dtype, S=S, geometry=geometry)
    if "window" in case:
        kw.update(window=20, softcap=30.0)
    if case == "split-cuts-window":
        kw.pop("softcap")
        assert plan_paged_decode(*args[0].shape[:1], S, 8, 2, 128, 16, 5,
                                 use_rank=True)["split_blocks"] == 1
    if case == "no-mask":
        kw["pool_mask"] = None
    if case == "no-visible-key":
        kw["pool_mask"][args[3][0]] = 0
        kw["q_positions"][2] = -1
    registry.reset_launch_counts()
    got = paged_decode_cuda(*args, **kw)
    ref = paged_attention_plain(*args, **kw)
    torch.cuda.synchronize()
    assert registry.launch_counts == {"paged_decode": 1}
    assert got.dtype == ref.dtype and got.shape == ref.shape
    assert row_rel_err(got, ref, active) <= PAGED_DECODE_ROW_REL
    assert bool((got[~active] == 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8-pool"])
def test_paged_decode_kernel_is_bitwise_run_to_run_on_the_card(quant):
    """The splits are merged in a fixed order and nothing is atomic: two
    calls on the same inputs give the same bits."""
    _needs_card()
    args, kw, _ = _paged_case(quant, torch.bfloat16, geometry="llama-m256")
    a = paged_decode_cuda(*args, **kw)
    b = paged_decode_cuda(*args, **kw)
    torch.cuda.synchronize()
    bits = torch.int32 if a.dtype == torch.float32 else torch.int16
    assert torch.equal(a.view(bits), b.view(bits))


@pytest.mark.cuda
def test_int8_engine_on_the_card_matches_kernels_off():
    """Int8 weights and an int8 pool on a small bf16 model: every block
    projection launches the int8 kernel, and the tokens equal the plain
    arm's (both kernels on the path are bitwise)."""
    _needs_card()
    model = T.Llama(T.LlamaConfig.tiny(hidden_size=256, num_attention_heads=4,
                                       num_key_value_heads=2))
    model.init_params(0, dtype=torch.bfloat16)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(1, 256, (n,)).astype(np.int32) for n in (20, 5, 9)]
    outs = {}
    for spec in (None, "off"):
        engine = T.ContinuousBatcher(model, batch_slots=2, max_new_tokens=6, max_cache_len=256,
                                     bucket_sizes=(8, 16), sync_every=2, block_size=16,
                                     max_tokens_per_request=64, kv_quant="int8",
                                     matmul_precision="int8", kernels=spec)
        rids = [engine.submit(p) for p in prompts]
        registry.reset_launch_counts()
        out = engine.run()
        outs[spec] = [out[r] for r in rids]
        if spec is None:
            L = model.config.num_hidden_layers
            assert registry.launch_counts["int8_matmul"] == 7 * L * engine_forwards(engine)
            assert registry.launch_counts["paged_gather_dequant"] > 0
        else:
            assert registry.launch_counts == {}
    for a, b in zip(outs[None], outs["off"]):
        np.testing.assert_array_equal(a, b)


def _splash_card_case(D, S, window, softcap, padded, logit_std=1.0):
    """bf16 inputs on the card from a seed, q pre-scaled so that the logits
    have standard deviation ``logit_std``; right padding on row 1."""
    B, H = 2, 4
    g = torch.Generator(device="cuda").manual_seed(0)
    q, k, v, do = (torch.randn((B, S, H, D), generator=g, device="cuda", dtype=torch.bfloat16)
                   for _ in range(4))
    q = (q * (logit_std * D ** -0.5)).to(torch.bfloat16)
    seg = None
    if padded:
        seg = torch.full((B, S), 2, dtype=torch.int32, device="cuda")
        seg[1, -70:] = 1
    real = torch.ones((B, S), dtype=torch.bool, device="cuda") if seg is None else seg == 2
    return (q, k, v, do), dict(segment_ids=seg, window=window, softcap=softcap), real


def _splash_run(fn, q, k, v, do, kw):
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = fn(*leaves, **kw)
    out.backward(do)
    return out.detach(), leaves


@pytest.mark.cuda
@pytest.mark.parametrize("D,S,window,softcap,padded,logit_std", [
    (256, 512, 128, 50.0, False, 1.0),
    (256, 512, None, 50.0, True, 1.0),
    (256, 320, 100, 30.0, True, 1.0),
    (128, 512, 64, None, True, 1.0),
    (128, 320, 100, 20.0, False, 1.0),
    (64, 256, None, None, False, 1.0),
    (256, 512, 128, 50.0, True, 16.0),
    (128, 320, 100, 5.0, False, 1.0),
    (256, 1088, 300, 50.0, True, 1.0),
], ids=["d256-window-softcap", "d256-global-padded", "d256-first-tile-masked-padded",
        "d128-window-padded", "d128-first-tile-masked", "d64-causal",
        "d256-logits-at-the-cap-padded", "d128-softcap-5", "d256-ragged-1088-padded"])
def test_splash_kernel_matches_plain_version_on_the_card(D, S, window, softcap, padded,
                                                         logit_std):
    """bf16 in and out, q pre-scaled. The kernel rounds P and dS to bf16 for
    the tensor cores and the plain version does not; the pins are flash's:
    relative Frobenius error <= 1e-2 in every (batch, head, 64-row query
    tile) block of real-token rows, gradients' <= 2e-2 (chip_smoke.py holds
    the Gemma-2-9B shapes to the same pins). A window of 100 makes rows whose
    first visited KV tile is wholly masked for them; S=1088, an odd multiple
    of 64, leaves the last 128-row query tile half past the end. Unit logits barely
    reach a cap of 20-50, so two cases make the cap bite: logits of standard
    deviation 16 against 50, and unit logits against 5."""
    _needs_card()
    (q, k, v, do), kw, real = _splash_card_case(D, S, window, softcap, padded, logit_std)
    registry.reset_launch_counts()
    out, leaves = _splash_run(splash_attention_cuda, q, k, v, do, kw)
    ref, ref_leaves = _splash_run(splash_attention_reference, q, k, v, do, kw)
    torch.cuda.synchronize()
    assert registry.launch_counts == {"splash_attention_fwd": 1, "splash_attention_bwd": 1}
    fwd_rel = tile_rel_err(out, ref, real)
    assert fwd_rel <= FLASH_FWD_TILE_REL, fwd_rel
    for name, rel in splash_grad_rel(leaves, ref_leaves).items():
        assert rel <= FLASH_BWD_REL, (name, rel)


@pytest.mark.cuda
def test_splash_backward_is_deterministic_on_the_card():
    """The splash backward has one writer per output element and no
    atomics, so two runs on the same inputs agree bit for bit (ragged S,
    padding, window and softcap at D=256)."""
    _needs_card()
    from accelerate_tpu_torch.ops.kernels import splash_attention as sk

    (q, k, v, do), kw, _ = _splash_card_case(256, 1088, 300, 50.0, True)
    runs = []
    for _ in range(2):
        o, lse = sk._forward(q, k, v, kw["segment_ids"], 300, 50.0)
        runs.append((o, lse) + sk._backward(q, k, v, kw["segment_ids"], o, lse, do, 300, 50.0))
    torch.cuda.synchronize()
    for a, b in zip(*runs):
        assert torch.equal(a, b)


def test_plain_without_cap_derivative_drops_only_the_cap_derivative():
    """The control the softcap cases use, on the CPU: the same forward as
    the plain version, the same dv, and dq/dk that differ from its own
    exactly where the cap bends the logits (a cap far above the logits
    leaves them alike)."""
    g = torch.Generator().manual_seed(0)
    q, k, v, do = (torch.randn((1, 256, 2, 64), generator=g) for _ in range(4))
    for softcap, bent in ((5.0, True), (1e4, False)):
        kw = dict(segment_ids=None, window=64, softcap=softcap)
        ref, ref_leaves = _splash_run(splash_attention_reference, q, k, v, do, kw)
        out, leaves = _splash_run(plain_without_cap_derivative, q, k, v, do, kw)
        torch.testing.assert_close(out, ref, atol=1e-5, rtol=0)
        rel = splash_grad_rel(leaves, ref_leaves)
        assert rel["dv"] < 1e-5
        assert (min(rel["dq"], rel["dk"]) > 0.1) if bent else (max(rel["dq"], rel["dk"]) < 1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("D,S,window,softcap,padded,logit_std", [
    (256, 512, 128, 50.0, True, 16.0),
    (128, 320, 100, 5.0, False, 1.0),
], ids=["d256-logits-at-the-cap-padded", "d128-softcap-5"])
def test_splash_softcap_cases_tell_a_kernel_without_the_cap(D, S, window, softcap, padded,
                                                           logit_std):
    """The controls of the cases above whose logits reach the cap: the
    kernel run without the softcap misses the capped plain version beyond
    the forward and gradient pins, and so does the plain version with the
    cap's derivative left out of its backward (a backward without the
    factor 1 - tanh^2) on dq and dk. So those cases would fail a kernel
    that dropped either."""
    _needs_card()
    (q, k, v, do), kw, real = _splash_card_case(D, S, window, softcap, padded, logit_std)
    ref, ref_leaves = _splash_run(splash_attention_reference, q, k, v, do, kw)
    out, leaves = _splash_run(splash_attention_cuda, q, k, v, do, dict(kw, softcap=None))
    assert tile_rel_err(out, ref, real) > FLASH_FWD_TILE_REL
    rel = splash_grad_rel(leaves, ref_leaves)
    assert rel["dq"] > FLASH_BWD_REL and rel["dk"] > FLASH_BWD_REL, rel
    _, st_leaves = _splash_run(plain_without_cap_derivative, q, k, v, do, kw)
    rel = splash_grad_rel(st_leaves, ref_leaves)
    assert rel["dq"] > FLASH_BWD_REL and rel["dk"] > FLASH_BWD_REL, rel


@pytest.mark.cuda
def test_gemma2_train_step_on_the_card_matches_kernels_off():
    """A small Gemma-2 (one local and one global layer, head_dim 256,
    softcaps, query scale, the fused loss) trained in bf16 with
    ``attention_impl="splash"``: the kernel arm launches splash fwd/bwd
    once per layer per step, no flash, and the fused adamw update once per
    leaf (13); its losses agree with the plain arm's to 2e-2 (bf16 compute,
    losses about 7)."""
    _needs_card()
    hf = dict(vocab_size=1000, hidden_size=256, intermediate_size=512, num_hidden_layers=2,
              num_attention_heads=4, num_key_value_heads=2, head_dim=256,
              max_position_embeddings=512, rms_norm_eps=1e-6, sliding_window=128,
              query_pre_attn_scalar=256, attn_logit_softcapping=50.0,
              final_logit_softcapping=30.0)
    cfg = T.gemma2_config_from_hf(hf)
    cfg.attention_impl, cfg.fused_loss, cfg.fused_loss_chunk = "splash", True, 384
    rng = np.random.default_rng(5)
    batches = []
    for _ in range(3):
        ids = rng.integers(0, 1000, (2, 512)).astype(np.int32)
        batches.append({"input_ids": ids, "labels": ids})
    losses = {}
    for spec in (None, "off"):
        model = T.Llama(cfg)
        model.init_params(0)
        acc = T.Accelerator(mixed_precision="bf16", kernels=spec)
        pm, po = acc.prepare(model, T.adamw(3e-4))
        step = acc.build_train_step(pm, po)
        registry.reset_launch_counts()
        losses[spec] = [float(step(b, clip_norm=1.0)) for b in batches]
        if spec is None:
            assert registry.launch_counts == {"splash_attention_fwd": 6,
                                              "splash_attention_bwd": 6,
                                              "fused_adamw_update": 3 * 13}
        else:
            assert registry.launch_counts == {}
    np.testing.assert_allclose(losses[None], losses["off"], atol=2e-2)


def _bert_loop_arm(spec, steps, accum=1):
    """The canonical loop on a small BERT on the card (bf16 compute), with a
    constant adamw; returns the accelerator, model, optimizer, losses and
    the fused update's launch count after each step."""
    cfg = T.BertConfig.tiny(vocab_size=1000, max_position_embeddings=128,
                            hidden_dropout_prob=0.0)
    model = T.BertForSequenceClassification(cfg)
    model.init_params(0)
    acc = T.Accelerator(mixed_precision="bf16", kernels=spec, gradient_accumulation_steps=accum)
    pm, po = acc.prepare(model, T.adamw(1e-3))
    rng = np.random.default_rng(3)
    losses, counts = [], []
    registry.reset_launch_counts()
    for _ in range(steps):
        batch = {"input_ids": rng.integers(0, 1000, (8, 128)).astype(np.int32),
                 "token_type_ids": np.repeat([[0] * 64 + [1] * 64], 8, axis=0).astype(np.int32),
                 "labels": rng.integers(0, 2, (8,)).astype(np.int32)}
        with acc.accumulate(pm):
            loss = pm(**batch)["loss"]
            acc.backward(loss)
            if acc.sync_gradients:
                acc.clip_grad_norm_(pm, 1.0)
            po.step()
            po.zero_grad()
        losses.append(float(loss.detach()))
        counts.append(registry.launch_counts.get("fused_adamw_update", 0))
    return acc, pm, po, losses, counts


@pytest.mark.cuda
def test_loop_optimizer_step_launches_the_kernel_bitwise_to_its_plain_version_on_the_card():
    """``optimizer.step()`` of the imperative loop with a constant adamw:
    one fused update launch per BERT parameter leaf (25), and, from the
    same banked gradients, parameters and moments bitwise equal to the
    ``kernels="off"`` arm's (the plain version)."""
    _needs_card()
    arms = {spec: _bert_loop_arm(spec, 0)[:3] for spec in (None, "off")}
    rng = np.random.default_rng(4)
    batch = {"input_ids": rng.integers(0, 1000, (8, 128)).astype(np.int32),
             "labels": rng.integers(0, 2, (8,)).astype(np.int32)}
    for acc, pm, _ in arms.values():
        acc.backward(pm(**batch)["loss"])
    (kacc, kpm, kpo), (oacc, opm, opo) = arms[None], arms["off"]
    for a, b in zip(tree_leaves(opo.grads), tree_leaves(kpo.grads)):
        a.copy_(b)  # the same banked gradients on both arms
    for acc, pm, _ in arms.values():
        acc.clip_grad_norm_(pm, 1.0)
    registry.reset_launch_counts()
    kpo.step()
    opo.step()
    torch.cuda.synchronize()
    assert registry.launch_counts == {"fused_adamw_update": 25}
    for a, b in zip(tree_leaves(kpm.params), tree_leaves(opm.params)):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    for name in ("mu", "nu"):
        for a, b in zip(tree_leaves(getattr(kpo.opt_state[0], name)),
                        tree_leaves(getattr(opo.opt_state[0], name))):
            assert torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.cuda
def test_loop_on_the_card_matches_kernels_off():
    """Four steps of the loop (bf16 compute, a constant adamw): the kernel
    arm launches the update 25 times a step, the plain arm never; losses
    agree to 2e-2 (bf16 compute, losses about 0.7). With accumulation 2 the
    update launches only at the boundaries."""
    _needs_card()
    _, _, _, losses, counts = _bert_loop_arm(None, 4)
    assert counts == [25, 50, 75, 100]
    _, _, _, off, off_counts = _bert_loop_arm("off", 4)
    assert off_counts == [0, 0, 0, 0]
    np.testing.assert_allclose(losses, off, atol=2e-2)
    _, _, _, _, acc_counts = _bert_loop_arm(None, 4, accum=2)
    assert acc_counts == [0, 25, 25, 50]


def test_complete_example_runs_on_the_card_unless_cpu(monkeypatch, tmp_path):
    from accelerate_tpu_torch.examples import complete_nlp_example

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        complete_nlp_example.main(["--output_dir", str(tmp_path), "--num_epochs", "1"])


def test_background_checkpoint_write_failure_raises_at_finish_pending_saves(monkeypatch,
                                                                            tmp_path):
    """A non-blocking save whose write fails raises at the join, never
    swallowed; a blocking save raises at once. Nothing is left queued."""
    from accelerate_tpu_torch import checkpointing

    acc = T.Accelerator(cpu=True)
    model = T.BertForSequenceClassification(T.BertConfig.tiny(), device="cpu")
    model.init_params(0)
    acc.prepare(model, T.adamw(1e-3, device="cpu"))

    def broken(path, tensors):
        raise OSError("disk full")

    monkeypatch.setattr(checkpointing, "_commit_item", broken)
    acc.save_state(str(tmp_path / "a"), blocking=False)
    with pytest.raises(RuntimeError, match="disk full"):
        acc.finish_pending_saves()
    assert checkpointing._PENDING_SAVES == []
    with pytest.raises(OSError, match="disk full"):
        acc.save_state(str(tmp_path / "b"))
    acc.save_state(str(tmp_path / "c"), blocking=False)
    with pytest.raises(RuntimeError, match="disk full"):
        acc.end_training()


@pytest.mark.cuda
def test_checkpoint_resume_on_the_card_is_bitwise():
    """Phase 12's arm B at a tiny width (dropout 0.1): 20 steps, a blocking
    save, fresh objects from another seed, ``load_state`` (bitwise the
    state at the save), 20 more steps: losses, batches and final state
    bitwise an uninterrupted run's, 25 fused-update launches in every step
    after the load. The snapshot of CUDA tensors goes through pinned host
    memory (never the CPU-only clone)."""
    import shutil
    import tempfile

    from accelerate_tpu_torch import checkpointing

    _needs_card()
    cfg = T.BertConfig.tiny(hidden_dropout_prob=0.1)
    a = ckpt_build(cfg, 0, inject=False)
    ckpt_steps(a, CKPT_STEPS)
    want = ckpt_state(a)
    b = ckpt_build(cfg, 0, inject=False)
    ckpt_steps(b, CKPT_AT)
    copies = checkpointing._host_copies(b["model"].params)
    assert copies and all(t.is_pinned() for t in copies.values())
    at_save = ckpt_state(b)
    root = tempfile.mkdtemp()
    try:
        b["acc"].save_state(root)
        first = b["losses"] + []
        c = ckpt_build(cfg, 1, inject=False)
        c["acc"].load_state(root)
        assert ckpt_diff(ckpt_state(c), at_save) == []
        registry.reset_launch_counts()
        ckpt_steps(c, CKPT_STEPS - CKPT_AT)
    finally:
        shutil.rmtree(root)
    assert [float(x) for x in first + c["losses"]] == [float(x) for x in a["losses"]]
    assert all(torch.equal(x, y) for x, y in zip(b["ids"][:CKPT_AT] + c["ids"], a["ids"]))
    assert ckpt_diff(ckpt_state(c), want) == []
    assert c["launches"] == [25] * (CKPT_STEPS - CKPT_AT)


def test_unported_checkpoint_options_raise(tmp_path):
    acc = T.Accelerator(cpu=True)
    with pytest.raises(NotImplementedError, match="preemption"):
        acc.checkpoint_on_preemption()
    # DeviceBatchPrefetcher is ported: it feeds the card by default (and
    # raises without one), the CPU when asked.
    with pytest.raises(RuntimeError, match="device='cpu'"):
        T.data_loader.DeviceBatchPrefetcher([], prefetch=2)
    assert list(T.data_loader.DeviceBatchPrefetcher([], prefetch=2, device="cpu")) == []
    from accelerate_tpu_torch.checkpointing import export_full_weights

    with pytest.raises(NotImplementedError, match="msgpack"):
        export_full_weights({"w": torch.zeros(2)}, str(tmp_path), safe_serialization=False)
