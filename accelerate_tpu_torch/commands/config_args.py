"""The launch configuration file — the counterpart of
``accelerate_tpu/commands/config_args.py:32-247``.

:class:`ClusterConfig` has the JAX package's fields, names and defaults (but
``distributed_type``'s, ``MULTI_GPU``), so a file either package writes
loads into the other's with the same fields. The format (yaml, or json for
a ``.json`` path) and the default location
(``utils/other.default_config_file``: ``$ACCELERATE_TPU_HOME``, else the
cache folder's ``accelerate_tpu/default_config.yaml``) are the JAX
package's; a yaml file needs ``pyyaml``, and without it reading or writing
one raises ``ImportError``, as in the JAX package.

A field whose launch-contract key no module of the port reads is in
:data:`UNPORTED_FIELDS`: the launcher raises when it holds anything but its
default, naming the field and where ROADMAP.md queues it
(:func:`check_ported`), so nothing is dropped silently. ``kernels`` is
among them for good: no environment variable switches the port's kernel
backend.
"""

from __future__ import annotations

import json
import os
from dataclasses import asdict, dataclass, field, fields

from ..utils.constants import MESH_AXIS_ORDER
from ..utils.other import default_config_file

_XLA = "an XLA setting with no PyTorch counterpart (ROADMAP.md, Queue 1 item 10)"
_RESILIENCE = "resilience/ is not ported yet (ROADMAP.md, Queue 1 item 6)"
_HEALTH = "health/ is not ported yet (ROADMAP.md, Queue 1 item 6)"
_TELEMETRY = "telemetry/ is not ported yet (ROADMAP.md, Queue 1 item 6)"
_SERVING = "the serving levers are not ported yet (ROADMAP.md, Queue 1 item 7)"
_SERVING_NET = "serving_net/ is not ported yet (ROADMAP.md, Queue 1 item 9)"
UNPORTED_FIELDS = {
    "compute_environment": "TPU pods have no GPU counterpart; on several machines run "
                           "`launch --num_machines M --machine_rank r` on each "
                           "(ROADMAP.md, Queue 1 item 10)",
    "cpu_virtual_devices": _XLA,
    "downcast_bf16": _XLA,
    "compile_cache_dir": _XLA,
    "xla_preset": _XLA,
    "dcn_size": "the dcn axis is not ported yet (ROADMAP.md, Queue 1 item 5)",
    "handle_preemption": _RESILIENCE,
    "fault_plan": _RESILIENCE,
    "elastic": _RESILIENCE,
    "min_data_parallel": _RESILIENCE,
    "guard_numerics": _HEALTH,
    "spike_zscore": _HEALTH,
    "hang_timeout": _HEALTH,
    "telemetry": _TELEMETRY,
    "metrics_port": _TELEMETRY,
    "straggler_threshold": _TELEMETRY,
    "fleet_metrics": _TELEMETRY,
    "slo_step_time": _TELEMETRY,
    "journal_dir": _TELEMETRY,
    "trace_ring": _TELEMETRY,
    "flight_ring": _TELEMETRY,
    "profile_steps": _TELEMETRY,
    "profile_slow_zscore": _TELEMETRY,
    "slo_ttft": _SERVING,
    "slo_tpot": _SERVING,
    "speculative_k": _SERVING,
    "draft_model": _SERVING,
    "kv_quant": _SERVING,
    "serving_role": _SERVING_NET,
    "router_endpoint": _SERVING_NET,
    "serving_retry_budget": _SERVING_NET,
    "serving_lease_ttl": _SERVING_NET,
    "drain_grace_s": _SERVING_NET,
    "tune_budget": "tune/ is not ported yet (ROADMAP.md, Queue 1 item 10)",
    "kernels": "the port's kernel backend follows the tensor's device and never an "
               "environment variable (pass kernels='off' to the Accelerator instead)",
}


def load_config_from_file(config_file: str | None):
    """A :class:`ClusterConfig` from a yaml or json file, or None when no
    file is named and the default one does not exist. Unknown keys are kept
    in ``extra``."""
    path = config_file if config_file is not None else default_config_file()
    if config_file is not None and not os.path.isfile(path):
        raise FileNotFoundError(f"The passed configuration file `{path}` does not exist. "
                                "Run `accelerate-tpu-torch config` to create one.")
    if not os.path.isfile(path):
        return None
    with open(path, encoding="utf-8") as f:
        text = f.read()
    if path.endswith(".json"):
        data = json.loads(text)
    else:
        data = _yaml().safe_load(text)
    if data is None:
        return None
    known = {f_.name for f_ in fields(ClusterConfig)}
    cfg = ClusterConfig(**{k: v for k, v in data.items() if k in known})
    cfg.extra = {k: v for k, v in data.items() if k not in known}
    return cfg


def _yaml():
    try:
        import yaml
    except ImportError as err:
        raise ImportError("pyyaml is required to read and write yaml config files "
                          "(a .json path needs nothing)") from err
    return yaml


@dataclass
class ClusterConfig:
    """One launch configuration (the JAX package's fields; module
    docstring). ``num_processes`` is the processes of one machine, one per
    card (or gloo ranks with ``use_cpu``); the job has ``num_machines`` x
    ``num_processes`` ranks. The mesh sizes reach the processes as
    ``ACCELERATE_MESH_SHAPE``; ``dp_size`` 0 takes the ranks left over."""

    compute_environment: str = "LOCAL_MACHINE"
    distributed_type: str = "MULTI_GPU"  # MULTI_GPU | MULTI_CPU | NO
    num_machines: int = 1
    machine_rank: int = 0
    num_processes: int = 1
    main_process_ip: str | None = None
    main_process_port: int | None = None
    mixed_precision: str = "no"  # no | bf16 | fp16 | fp8
    use_cpu: bool = False
    debug: bool = False
    dp_size: int = 0
    fsdp_size: int = 1
    tp_size: int = 1
    pp_size: int = 1
    sp_size: int = 1
    ep_size: int = 1
    dcn_size: int = 0
    max_restarts: int = 0
    cpu_virtual_devices: int = 0
    downcast_bf16: bool = False
    gradient_accumulation_steps: int = 1
    fsdp_min_shard_size: int = 0
    fsdp_cpu_offload: bool = False
    pp_schedule: str = ""
    pp_microbatches: int = 0
    project_dir: str | None = None
    checkpoint_total_limit: int = 0
    checkpoint_auto_naming: bool = False
    log_with: str = ""
    compile_cache_dir: str = ""
    handle_preemption: bool = False
    fault_plan: str = ""
    elastic: bool | None = None
    min_data_parallel: int = 0
    guard_numerics: bool | None = None
    spike_zscore: float | None = None
    hang_timeout: float = 0.0
    telemetry: bool | None = None
    metrics_port: int = 0
    straggler_threshold: float = 0.0
    fleet_metrics: bool | None = None
    slo_step_time: float | None = None
    slo_ttft: float | None = None
    slo_tpot: float | None = None
    serving_role: str | None = None
    router_endpoint: str | None = None
    serving_retry_budget: float | None = None
    serving_lease_ttl: float | None = None
    drain_grace_s: float | None = None
    speculative_k: int | None = None
    draft_model: str | None = None
    kv_quant: str | None = None
    journal_dir: str | None = None
    trace_ring: int | None = None
    flight_ring: int | None = None
    train_window: int | None = None
    xla_preset: str = ""
    zero_sharding: bool | None = None
    kernels: str | None = None
    profile_steps: str | None = None
    profile_slow_zscore: float | None = None
    tune_budget: int | None = None
    extra: dict = field(default_factory=dict)

    def to_dict(self) -> dict:
        d = asdict(self)
        d.update(d.pop("extra", {}) or {})
        return {k: v for k, v in d.items() if v is not None}

    def to_yaml_file(self, path: str) -> None:
        yaml = _yaml()
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w", encoding="utf-8") as f:
            yaml.safe_dump(self.to_dict(), f, sort_keys=True)

    def to_json_file(self, path: str) -> None:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w", encoding="utf-8") as f:
            json.dump(self.to_dict(), f, indent=2)

    def mesh_shape_env(self) -> str:
        """The mesh axes for ``ACCELERATE_MESH_SHAPE`` (``axis:size,...``)."""
        return ",".join(f"{name}:{getattr(self, f'{name}_size')}" for name in MESH_AXIS_ORDER)


def check_ported(cfg: ClusterConfig) -> None:
    """Raise for a field the port cannot honour (:data:`UNPORTED_FIELDS`)
    set to anything but its default, and for unknown keys. The mesh's dcn
    axis passes at its neutral sizes (0 or 1)."""
    defaults = ClusterConfig()
    for name, why in UNPORTED_FIELDS.items():
        value = getattr(cfg, name)
        if name == "dcn_size" and value in (0, 1):
            continue
        if value != getattr(defaults, name):
            raise NotImplementedError(f"launch: `{name}` = {value!r} cannot be honoured by the "
                                      f"PyTorch port: {why}")
    if cfg.extra:
        raise NotImplementedError(f"launch: unknown config keys {sorted(cfg.extra)}; the port "
                                  "reads only ClusterConfig's fields")
