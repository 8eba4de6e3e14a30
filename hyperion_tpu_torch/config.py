"""The trainers' configuration — the `train`, `optimization` and
`distributed` fields of `hyperion_tpu/config.py` that the port's
language and Llama trainers read, with the reference's defaults: the
MoE knobs (`moe_experts`, `moe_top_k`, `moe_every`), the six mesh axes
and the pipeline's microbatch count among them.
"""

from __future__ import annotations

import dataclasses

from hyperion_tpu_torch.runtime.mesh import MeshSpec


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

    def mesh_spec(self) -> MeshSpec:
        return MeshSpec(data=self.data, fsdp=self.fsdp, model=self.model,
                        seq=self.seq, pipe=self.pipe, expert=self.expert)


@dataclasses.dataclass
class Config:
    optimization: OptimizationConfig = dataclasses.field(
        default_factory=OptimizationConfig)
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)
    distributed: DistributedConfig = dataclasses.field(
        default_factory=DistributedConfig)
