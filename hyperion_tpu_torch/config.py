"""The trainers' configuration — the `train` and `optimization` fields of
`hyperion_tpu/config.py` that the port's language and Llama trainers
read, with the reference's defaults.

Fields for features the port does not have yet stay, so that asking
for one raises `NotImplementedError` naming its ROADMAP item instead of
being ignored. Two defaults differ from the reference's because the
reference's default turns such a feature on: `health_policy` is "off"
(the reference's "warn" runs the health monitor) and `prefetch_depth`
is 0 (the reference's 2 runs the background prefetcher).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class OptimizationConfig:
    precision: str = "bf16"          # fp32 | bf16 | bf16_full
    remat: str = "none"              # none | full | dots | dots_no_batch
    grad_accum_steps: int = 1
    grad_clip_norm: float = 0.0      # 0 disables
    compile_tier: str = "jit"        # jit (plain ops) | jit+pallas (kernels)
    attention_impl: str | None = None  # override just attention


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
    lora: bool = False               # train_llama: adapters on a frozen base
    lora_rank: int = 16              # reference LoraConfig r=16, alpha=32
    lora_alpha: float = 32.0
    lora_dropout: float = 0.05       # read by nothing, as in the reference
    export_merged: bool = False      # also export base + adapters merged
    # not ported: set, they raise (ROADMAP A7, A8)
    health_policy: str = "off"
    prefetch_depth: int = 0
    chaos: str = ""
    profile_dir: str = ""
    moe_experts: int = 0


@dataclasses.dataclass
class Config:
    optimization: OptimizationConfig = dataclasses.field(
        default_factory=OptimizationConfig)
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)
