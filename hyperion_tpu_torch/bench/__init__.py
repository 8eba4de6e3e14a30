"""Benchmarks of the port: the scaling sweep (`scaling.py`) and the
reference's Phase-1 tools, each `python -m hyperion_tpu_torch.bench.<name>`:
`hw_explore` (matmul rates by dtype, memory bandwidth), `baseline`
(ResNet-50, ViT-B/16, the reference's fallback CNN and the encoder:
forward, backward and optimizer time, batch scaling, precisions),
`attention_bench` (materialized scores against the flash kernels by
sequence length), `compile_bench` (eager, CUDA-graph and hand-kernel
tiers) and `decode_bench` (prefill and chained decode, float and int8,
speculative rows). Their default outputs go under `results/torch/`."""
