"""Operators: plain PyTorch attention math and the hand-written CUDA
kernels with their wrappers (`flash_attention`, `fused_ce`,
`fused_norm`, `paged_attention`)."""
