"""Guards on the PyTorch port as a package.

- No module of ``accelerate_tpu_torch``, and not ``chip_smoke.py``, imports
  ``jax`` or ``accelerate_tpu`` (an AST scan of every import statement).
- Entry points run on the card by default and raise without one unless the
  caller passes ``device="cpu"``; nothing drops to the CPU quietly.
- The CUDA kernel wrapper refuses CPU tensors; only the registry routes CPU
  tensors (or an explicit ``kernels="off"``) to the plain version.
- Options not ported yet raise ``NotImplementedError``, never a silent
  fallback.
- Kernel vs plain version on the card: marked ``cuda``, skipped on hosts
  without a GPU (chip_smoke.py runs the same comparison at the engine's
  shapes on the card).
"""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

import accelerate_tpu_torch as T
from accelerate_tpu_torch.ops import registry
from accelerate_tpu_torch.ops.kernels import _build
from accelerate_tpu_torch.ops.kernels.paged_gather import paged_gather
from accelerate_tpu_torch.ops.paged_attention import gather_block_view

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
    assert T.resolve_device("cpu").type == "cpu"
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
    assert registry.launch_counts == {}
    assert registry.known_ops() == ("paged_gather",)
    with pytest.raises(KeyError):
        registry.dispatch("no_such_op", pool)


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    assert _build.sources() == ["paged_gather"]
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()


@pytest.mark.parametrize("option,match", [
    (dict(speculative_k=2), "speculative"),
    (dict(draft_model=object()), "speculative"),
    (dict(matmul_precision="int8"), "int8"),
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


@pytest.mark.parametrize("option", [dict(num_beams=2), dict(assistant_model=object()),
                                    dict(matmul_precision="int8")])
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
