"""The configuration of `hyperion_tpu/config.py`: its hardware,
optimization, distributed, train and benchmarking blocks with the
reference's fields and defaults (the MoE knobs, the six mesh axes and
the pipeline's microbatch count among them), and its JSON surface:
`Config.to_dict`, `save`, `load`, `from_dict` (unknown keys ignored, JSON
lists back into tuple fields) and dotted `override`, and
`default_config()`. A JSON either package saves loads into the other
field by field.

What differs by design: `HardwareConfig` describes the card (platform
"gpu", 80 GB: an H100) where the reference's describes a v5e chip.
Fields the port keeps only for that round trip, read by nothing here:
`optimization.donate_state` (JAX buffer donation; PyTorch updates the
state in place), `train.log_every`, `distributed.max_devices` (set
from `--devices` as the reference sets it; torchrun sizes the world)
and the coordinator fields (`torchrun`'s environment names the ranks),
and the `benchmarking` block.
"""

from __future__ import annotations

import dataclasses
import json
import typing
from pathlib import Path
from typing import Any

from hyperion_tpu_torch.runtime.mesh import MeshSpec


def _from_dict(cls, d: dict):
    hints = typing.get_type_hints(cls)
    names = {f.name for f in dataclasses.fields(cls)}
    kwargs = {}
    for k, v in d.items():
        if k not in names:
            continue  # forward and backward compatible: unknown keys go
        t = hints.get(k)
        if dataclasses.is_dataclass(t) and isinstance(v, dict):
            v = _from_dict(t, v)
        elif t is tuple and isinstance(v, list):
            v = tuple(v)  # JSON arrays come back as lists
        kwargs[k] = v
    return cls(**kwargs)


@dataclasses.dataclass
class HardwareConfig:
    platform: str = "gpu"
    chips_expected: int = 0          # 0 = whatever torch.cuda reports
    hbm_gb_per_chip: float = 80.0    # H100 SXM


@dataclasses.dataclass
class OptimizationConfig:
    precision: str = "bf16"          # fp32 | bf16 | bf16_full
    remat: str = "none"              # none | full | dots | dots_no_batch
    grad_accum_steps: int = 1
    grad_clip_norm: float = 0.0      # 0 disables
    compile_tier: str = "jit"        # jit (plain ops) | jit+pallas (kernels)
    attention_impl: str | None = None  # override just attention
    donate_state: bool = True        # the reference's; read by nothing here
    # where the CUDA kernels' libraries are built and loaded from
    # (ops/build.py; `train --compile-cache`): empty = the
    # HYPERION_COMPILE_CACHE variable, else build/hyperion_tpu_torch
    compile_cache: str = ""


@dataclasses.dataclass
class TrainConfig:
    model: str = "transformer_lm"    # train_llama: llama_tiny|llama_7b|llama_70b
    epochs: int = 3
    batch_size: int = 32             # per-step global batch
    learning_rate: float = 2e-4
    lr_schedule: str = "constant"    # constant | cosine | warmup_cosine
    warmup_steps: int = 0
    weight_decay: float = 0.0
    seq_len: int = 128
    train_split: str = "train"
    steps_per_epoch: int = 0         # 0 = full pass; >0 caps train and eval
    validate: bool = True
    telemetry: bool = True           # <base_dir>/telemetry.jsonl + heartbeat
    heartbeat_every: int = 25
    seed: int = 0
    base_dir: str = "data"           # run outputs; data too unless data_dir
    data_dir: str = ""
    log_every: int = 50              # the reference's; read by nothing here
    lora: bool = False               # train_llama: adapters on a frozen base
    lora_rank: int = 16              # reference LoraConfig r=16, alpha=32
    lora_alpha: float = 32.0
    lora_dropout: float = 0.05       # read by nothing, as in the reference
    export_merged: bool = False      # also export base + adapters merged
    health_policy: str = "warn"      # off | warn | checkpoint | abort
    prefetch_depth: int = 2          # batches assembled ahead (0 = inline)
    async_checkpoint: bool = True    # epoch saves write in the background
    chaos: str = ""                  # fault plan (testing/chaos.py)
    profile_dir: str = ""            # torch.profiler trace of one epoch
    moe_experts: int = 0             # >0: language jobs use the MoE LM
    moe_top_k: int = 2
    moe_every: int = 2               # every k-th block is sparse
    dry_init: bool = False           # plan the TrainState's memory only


@dataclasses.dataclass
class DistributedConfig:
    """The mesh's axis sizes (`runtime/mesh.py`): -1 on one axis means
    the rest of the world; an axis > 1 needs as many ranks (a single
    process with one raises)."""

    data: int = -1
    fsdp: int = 1
    model: int = 1
    seq: int = 1
    pipe: int = 1
    pipe_microbatches: int = 0       # 0 = one per stage (GPipe M >= S)
    expert: int = 1                  # expert-parallel shards (ops.moe)
    # the reference's device cap and coordinator; torchrun's environment
    # names the ranks here
    max_devices: int = 0
    coordinator_address: str | None = None
    num_processes: int | None = None
    process_id: int | None = None

    def mesh_spec(self) -> MeshSpec:
        return MeshSpec(data=self.data, fsdp=self.fsdp, model=self.model,
                        seq=self.seq, pipe=self.pipe, expert=self.expert)


@dataclasses.dataclass
class BenchmarkingConfig:
    batch_sizes: tuple = (1, 2, 4, 8, 16, 32, 64, 128)
    models: tuple = ("resnet50", "vit_b16", "custom_transformer")
    precisions: tuple = ("fp32", "bf16")
    iterations: int = 50
    warmup_iterations: int = 10


@dataclasses.dataclass
class Config:
    hardware: HardwareConfig = dataclasses.field(
        default_factory=HardwareConfig)
    optimization: OptimizationConfig = dataclasses.field(
        default_factory=OptimizationConfig)
    distributed: DistributedConfig = dataclasses.field(
        default_factory=DistributedConfig)
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)
    benchmarking: BenchmarkingConfig = dataclasses.field(
        default_factory=BenchmarkingConfig)

    def to_dict(self) -> dict[str, Any]:
        return dataclasses.asdict(self)

    def save(self, path: str | Path) -> None:
        Path(path).write_text(json.dumps(self.to_dict(), indent=2,
                                         default=list))

    @classmethod
    def load(cls, path: str | Path) -> "Config":
        return cls.from_dict(json.loads(Path(path).read_text()))

    @classmethod
    def from_dict(cls, d: dict) -> "Config":
        return _from_dict(cls, d)

    def override(self, **kv) -> "Config":
        """Dotted-path overrides: cfg.override(**{"train.epochs": 5})."""
        cfg = Config.from_dict(self.to_dict())
        for key, val in kv.items():
            obj = cfg
            *parents, leaf = key.split(".")
            for name in parents:
                obj = getattr(obj, name)
            if not hasattr(obj, leaf):
                raise AttributeError(f"no config field {key!r}")
            setattr(obj, leaf, val)
        return cfg


def default_config() -> Config:
    return Config()
