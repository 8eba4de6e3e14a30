"""`python -m hyperion_tpu_torch.infer` — the inference CLI
(`generate.main`)."""

from hyperion_tpu_torch.infer.generate import main

if __name__ == "__main__":
    raise SystemExit(main())
