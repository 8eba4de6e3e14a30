"""The port's partition rules and memory plan against the JAX package's,
on the CPU, with no process group: `parallel/partition.py` reads each
torch parameter as its flax leaf (`jax_view`: path, flax shape, the
torch dim of each flax dim) and runs the JAX rules on it, so its specs
equal `hyperion_tpu/parallel/partition.py`'s leaf for leaf; the torch
dims they map to are what FSDP2 and the TP styles shard. `plan_train_
state` plans on the meta device: its bytes per device equal the JAX
plan's, up to the rounding of 4-byte step counts (torch's AdamW keeps
one per parameter, optax one in all), except for LoRA, where the port
keeps the adapters replicated and the JAX plan shards the frozen base
over fsdp (ROADMAP C).
"""

from __future__ import annotations

import jax
import numpy as np
import optax
import pytest
import torch
from flax import traverse_util

from hyperion_tpu.models import llama as jl
from hyperion_tpu.models import transformer_lm as jt
from hyperion_tpu.parallel import partition as jp
from hyperion_tpu.runtime.mesh import MeshSpec as JaxMeshSpec
from hyperion_tpu.runtime.mesh import make_abstract_mesh as jax_abstract
from hyperion_tpu.train.state import make_optimizer as jax_optimizer
from hyperion_tpu.train.state import plan_train_state as jax_plan
from hyperion_tpu_torch.models import llama as tl
from hyperion_tpu_torch.models import transformer_lm as tt
from hyperion_tpu_torch.parallel import partition as pp
from hyperion_tpu_torch.runtime.mesh import MeshSpec, make_abstract_mesh
from hyperion_tpu_torch.train.state import plan_train_state

LM = dict(vocab_size=256, d_model=64, n_heads=4, n_layers=2, ff_dim=256,
          max_len=32, dropout=0.0)
# (data, fsdp, model): FSDP at 2 and 4, TP at 2, FSDP x TP
MESHES = [(1, 2, 1), (1, 4, 1), (1, 1, 2), (1, 2, 2), (2, 2, 1)]


def _jax_specs(params, shape, fsdp=True):
    mesh = jax_abstract(JaxMeshSpec(*shape))
    specs = jp.partition_specs(params, mesh, jp.TRANSFORMER_TP_RULES,
                               fsdp=fsdp)
    flat = traverse_util.flatten_dict(specs, sep="/")
    return {k: tuple(v) for k, v in flat.items()}


def _pairs():
    """(jax param shapes, port meta model) for the two families."""
    jlm = jax.eval_shape(lambda r: jt.TransformerLM(
        jt.simple_lm_config(**LM)).init_params(r), jax.random.key(0))
    plm = tt.TransformerLM(tt.simple_lm_config(**LM), device="meta")
    cfg = jl.llama_tiny_config()
    jll = jax.eval_shape(lambda r: jl.Llama(cfg).init_params(r, seq=32),
                         jax.random.key(0))
    pll = tl.Llama(tl.llama_tiny_config(), device="meta")
    return {"lm": (jlm, plm), "llama": (jll, pll)}


PAIRS = _pairs()


@pytest.mark.parametrize("family", sorted(PAIRS))
def test_views_are_the_jax_tree(family):
    """Every torch parameter maps onto one flax leaf of the same shape,
    and every flax leaf is reached."""
    jparams, model = PAIRS[family]
    flat = {k: tuple(v.shape) for k, v in
            traverse_util.flatten_dict(jparams, sep="/").items()}
    views = {pp.jax_view(n, tuple(p.shape), model.cfg.head_dim)
             for n, p in model.named_parameters()}
    assert {v.path: v.shape for v in views} == flat


@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("family", sorted(PAIRS))
def test_partition_specs_equal_the_jax_specs(family, shape):
    jparams, model = PAIRS[family]
    want = _jax_specs(jparams, shape)
    sizes = dict(zip(("data", "fsdp", "model"), shape))
    views = {n: pp.jax_view(n, tuple(p.shape), model.cfg.head_dim)
             for n, p in model.named_parameters()}
    got = pp.partition_specs({v.path: v.shape for v in views.values()},
                             sizes, pp.TRANSFORMER_TP_RULES)
    assert got == want
    # the torch dims: each split flax dim lands on its torch dim
    layouts = pp.torch_layouts({n: tuple(p.shape) for n, p in
                                model.named_parameters()},
                               model.cfg.head_dim, sizes)
    for n, v in views.items():
        spec = want[v.path] + (None,) * (len(v.shape) - len(want[v.path]))
        lay = layouts[n]
        for axis, dim in (("model", lay.model), ("fsdp", lay.fsdp)):
            assert (axis in spec) == (dim is not None), (n, spec, lay)
            if dim is not None:
                assert v.dims[spec.index(axis)] == dim


def test_fsdp_leaves_stay_replicated_below_the_threshold():
    """At fsdp 2 only leaves of 2^14 elements or more shard: the token
    table, the MLP and the head; norms, biases, the attention and the
    32-row position table stay replicated (FSDP2's ignored params)."""
    _, model = PAIRS["lm"]
    layouts = pp.model_layouts(model, {"data": 1, "fsdp": 2, "model": 1})
    sharded = sorted(n for n, lay in layouts.items() if lay.fsdp is not None)
    assert sharded == ["block_0.fc1.weight", "block_0.fc2.weight",
                       "block_1.fc1.weight", "block_1.fc2.weight",
                       "lm_head.weight", "tok_emb.embedding"]


def test_indivisible_tp_raises_like_the_reference():
    cfg = dict(LM, n_heads=3, d_model=48)
    jparams = jax.eval_shape(lambda r: jt.TransformerLM(
        jt.simple_lm_config(**cfg)).init_params(r), jax.random.key(0))
    with pytest.raises(ValueError, match="not divisible"):
        _jax_specs(jparams, (1, 1, 2))
    model = tt.TransformerLM(tt.simple_lm_config(**cfg), device="meta")
    with pytest.raises(ValueError, match="not divisible"):
        pp.model_layouts(model, {"data": 1, "fsdp": 1, "model": 2})


def test_shardings_like_follows_the_params_by_shape():
    shapes = {"a": (4, 8), "b": (8,)}
    specs = {"a": ("fsdp",), "b": ()}
    assert pp.shardings_like({"mu/a": (4, 8), "count": ()}, shapes, specs) \
        == {"mu/a": ("fsdp",), "count": ()}


def _policy_model(model, dtype, lora=False):
    with torch.no_grad():
        for n, p in model.named_parameters():
            p.data = p.data.to(dtype)
            p.requires_grad_(not lora or n.endswith(("lora_a", "lora_b")))
    return model


PLAN_KEYS = ("params_gb", "opt_state_gb", "total_gb", "per_device_gb",
             "param_count", "params_by_dtype_gb")


@pytest.mark.parametrize("shape, fsdp", [((1, 2, 1), True),
                                         ((1, 4, 1), True),
                                         ((1, 1, 2), False),
                                         ((2, 2, 2), True)])
def test_lm_plan_equals_the_jax_plan(shape, fsdp):
    """The language model at its trainer's widths (GPT-2 vocab, d 256;
    fp32 masters under "bf16")."""
    kw = dict(max_len=128, dropout=0.1)
    if shape[2] > 1:
        kw["vocab_size"] = 50258  # padded to the model axis, as trained
    jmodel = jt.TransformerLM(jt.simple_lm_config(**kw))
    want = jax_plan(lambda r: {"params": jmodel.init_params(r)},
                    jax_optimizer(1e-4, grad_clip_norm=1.0),
                    jax_abstract(JaxMeshSpec(*shape)), jax.random.key(0),
                    policy="bf16", tp_rules=jp.TRANSFORMER_TP_RULES,
                    fsdp=fsdp)[2]
    model = tt.TransformerLM(tt.simple_lm_config(**kw), device="meta")
    got = plan_train_state(_policy_model(model, torch.float32),
                           make_abstract_mesh(MeshSpec(*shape)), fsdp=fsdp)
    for k in PLAN_KEYS:
        assert got[k] == want[k], k
    assert got["grads_per_device_gb"] == got["params_per_device_gb"]


def test_llama_7b_fsdp_bf16_plan_equals_the_jax_plan():
    """The `--dry-init` plan the chip smoke prints: Llama-2-7B
    `fsdp_bf16` on an abstract fsdp-4 mesh, bf16 params throughout."""
    jmodel = jl.Llama(jl.llama2_7b_config(max_len=4096))
    want = jax_plan(lambda r: {"params": jmodel.init_params(r, seq=128)},
                    jax_optimizer(1e-5, weight_decay=0.01,
                                  grad_clip_norm=1.0),
                    jax_abstract(JaxMeshSpec(1, 4)), jax.random.key(0),
                    policy="bf16_full", tp_rules=jp.TRANSFORMER_TP_RULES,
                    fsdp=True)[2]
    model = tl.Llama(tl.llama2_7b_config(max_len=4096), device="meta")
    got = plan_train_state(_policy_model(model, torch.bfloat16),
                           make_abstract_mesh(MeshSpec(1, 4)))
    for k in PLAN_KEYS:
        assert got[k] == want[k], k
    assert got["param_count"] == 6_738_415_616
    assert np.isclose(got["per_device_gb"] * 4, got["total_gb"], rtol=1e-3)


def test_lora_plan_differs_where_roadmap_c_says():
    """LoRA: the port keeps the adapters (and the frozen base)
    replicated, the JAX plan shards the base over fsdp: the global bytes
    agree, the per-device bytes do not."""
    cfg = jl.llama_tiny_config(d_model=128, ff_dim=512)
    jmodel = jl.Llama(cfg)
    from hyperion_tpu.models.lora import LoraConfig, init_lora_params

    lcfg = LoraConfig(rank=4, alpha=8.0)

    def init(r):
        base = jmodel.init_params(r, seq=32)
        return {"params": {"base": base, "lora": init_lora_params(
            jax.random.fold_in(r, 1), base, lcfg)}}

    opt = optax.multi_transform(
        {"train": jax_optimizer(1e-5), "freeze": optax.set_to_zero()},
        param_labels={"base": "freeze", "lora": "train"})
    want = jax_plan(init, opt, jax_abstract(JaxMeshSpec(1, 2)),
                    jax.random.key(0), policy="fp32",
                    tp_rules=jp.TRANSFORMER_TP_RULES, fsdp=True)[2]
    from hyperion_tpu_torch.models import lora as tlora

    pcfg = tl.llama_tiny_config(d_model=128, ff_dim=512)
    shapes = tl.jax_kernel_shapes(pcfg)
    targets = tlora.target_module_names(tlora.init_lora_params(
        torch.Generator().manual_seed(0), shapes,
        tlora.LoraConfig(rank=4, alpha=8.0)))
    import dataclasses

    pcfg = dataclasses.replace(pcfg, lora_rank=4, lora_scale=2.0,
                               lora_targets=targets)
    model = _policy_model(tl.Llama(pcfg, device="meta"), torch.float32,
                          lora=True)
    got = plan_train_state(model, make_abstract_mesh(MeshSpec(1, 2)),
                           fsdp=False)
    assert got["params_gb"] == want["params_gb"]
    assert got["param_count"] == want["param_count"]
    assert got["per_device_gb"] > want["per_device_gb"]
