"""CLI launcher of the port — `hyperion_tpu/cli/main.py`: the trainer
launcher (the default surface, `train` its explicit alias) and the
`serve` and `route` verbs.

    python -m hyperion_tpu_torch.cli.main train --model language_ddp \\
        [--train-split test --data_dir data] [--supervise] ...
    python -m hyperion_tpu_torch.cli.main serve --ckpt model.npz ...
    python -m hyperion_tpu_torch.cli.main route --replicas 2 --ckpt ...

`serve/server.py` and `serve/router.py` own their verbs' flags. The
trainer launcher takes the reference's flags, plus `--device` (cuda by
default, `--device cpu` for the plain PyTorch path), and returns the
reference's exit codes: 0 done, 4 the health policy aborted a diverged
run, 75 preempted with a resumable checkpoint (2 a usage error; 3 a
supervisor that gave up). Jobs and verbs not ported yet exit 2 and name
their ROADMAP item. The module imports no torch: `--supervise` runs the
trainer as a child process.

Several ranks, as the reference launched them:

    torchrun --nproc-per-node N -m hyperion_tpu_torch.cli.main train \
        --model language_fsdp [--mesh data,fsdp,model,seq] ...
    python -m torch.distributed.run --nproc-per-node 2 -m \
        hyperion_tpu_torch.cli.main train --device cpu ...    # gloo

`--mesh` sets the axes (default: all data, or all fsdp for
language_fsdp and a full Llama fine-tune); `--dry-init` prints the
TrainState's memory plan on the mesh and trains nothing (with explicit
axes it needs no process group and no device).
"""

from __future__ import annotations

import argparse
import sys

MODELS = ("language_ddp", "cifar", "language_fsdp", "llama", "all", "scaling")
DEFERRED_JOBS = {"cifar": "A9", "all": "A9", "scaling": "A9"}
DEFERRED_VERBS = {"obs": "A6", "simulate": "A9"}

_JOB_DEFAULTS = {
    # the reference's per-job hyperparameters
    "language_ddp": dict(batch_size=32, learning_rate=2e-4),
    "language_fsdp": dict(batch_size=32, learning_rate=1e-4),
    "llama": dict(batch_size=8, learning_rate=1e-5, weight_decay=0.01),
}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="hyperion_tpu_torch", description=__doc__.splitlines()[0])
    p.add_argument("--model", choices=MODELS, default="language_ddp")
    p.add_argument("--epochs", type=int, default=3)
    p.add_argument("--base_dir", default="data")
    p.add_argument("--data_dir", default="",
                   help="load corpora from here instead of base_dir "
                        "(base_dir stays the run-output root)")
    p.add_argument("--batch_size", type=int, default=None,
                   help="global batch (defaults per job: LM 32, llama 8)")
    p.add_argument("--lora", action="store_true",
                   help="llama: LoRA adapters instead of a full fine-tune")
    p.add_argument("--export-merged", action="store_true",
                   help="LoRA runs: also export base+adapters merged")
    p.add_argument("--llama_size", choices=["tiny", "7b", "70b"],
                   default="7b")
    p.add_argument("--steps-per-epoch", type=int, default=0,
                   help="cap steps per epoch (0 = full pass)")
    p.add_argument("--seq_len", type=int, default=0,
                   help="token window for LM jobs (0 = the reference's "
                        "128)")
    p.add_argument("--precision", choices=["fp32", "bf16", "bf16_full"],
                   default="bf16")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--dry-init", action="store_true",
                   help="plan-only: print the TrainState's memory plan "
                        "(global and per-device bytes of params, grads "
                        "and AdamW state) on the mesh, and train nothing")
    p.add_argument("--mesh", default=None,
                   help="axis sizes data,fsdp,model,seq[,pipe[,expert]] "
                        "(e.g. 2,2,1,1); default: all-data, or all-fsdp "
                        "for language_fsdp and a full Llama fine-tune; "
                        "seq, pipe and expert > 1 are ROADMAP A8")
    p.add_argument("--no-validate", action="store_true",
                   help="skip the per-epoch validation pass")
    p.add_argument("--no-telemetry", action="store_true",
                   help="skip <base_dir>/telemetry.jsonl and the "
                        "heartbeat that rides it")
    p.add_argument("--heartbeat-every", type=int, default=25,
                   help="rewrite <base_dir>/heartbeat.json every N steps "
                        "(0 = phase transitions only)")
    p.add_argument("--health-policy", default="warn",
                   choices=["off", "warn", "checkpoint", "abort"],
                   help="in-band anomaly escalation (obs/health.py); "
                        "abort stops a non-finite run with exit 4")
    p.add_argument("--profile-dir", default="",
                   help="torch.profiler trace of the first epoch run "
                        "into this directory")
    p.add_argument("--prefetch-depth", type=int, default=2,
                   help="assemble batches this many steps ahead on a "
                        "background thread (0 = inline)")
    p.add_argument("--no-async-checkpoint", action="store_true",
                   help="make every checkpoint save block until its "
                        "bytes and manifest are committed")
    p.add_argument("--chaos", default="",
                   help="deterministic fault plan (testing/chaos.py): "
                        "kill@step=N, sigterm@step=N, nan_loss@step=N, "
                        "stall@step=N:SECS, corrupt_ckpt@latest, "
                        "io_fail@p=X; step faults fire once per lineage")
    p.add_argument("--supervise", action="store_true",
                   help="run the trainer as a supervised subprocess "
                        "(train/supervisor.py)")
    p.add_argument("--max-restarts", type=int, default=2,
                   help="--supervise: restarts before giving up (exit 3)")
    p.add_argument("--lr", type=float, default=None)
    p.add_argument("--lr-schedule", default="constant",
                   choices=["constant", "cosine", "warmup_cosine"])
    p.add_argument("--warmup-steps", type=int, default=0)
    p.add_argument("--grad_accum", type=int, default=1)
    p.add_argument("--remat", choices=["none", "full", "dots",
                                       "dots_no_batch"], default=None,
                   help="activation remat (default: full for llama 7b/70b, "
                        "none otherwise)")
    p.add_argument("--compile-tier", choices=["jit", "jit+pallas"],
                   default="jit",
                   help="jit+pallas runs the hand kernels")
    p.add_argument("--attention-impl",
                   choices=["xla", "pallas", "auto", "ring", "ulysses"],
                   default=None,
                   help="override just attention (ring/ulysses: A8)")
    p.add_argument("--train-split", default="train",
                   help="corpus split LM jobs optimize on; 'test' trains "
                        "on the committed real WikiText-2 test split")
    p.add_argument("--device", default="cuda",
                   help="torch device (the plain PyTorch path runs with "
                        "--device cpu)")
    return p


def make_config(args, job: str):
    from hyperion_tpu_torch.config import Config

    cfg = Config()
    d = _JOB_DEFAULTS[job]
    t, o = cfg.train, cfg.optimization
    t.epochs = args.epochs
    t.base_dir = args.base_dir
    t.data_dir = args.data_dir
    t.batch_size = args.batch_size or d["batch_size"]
    t.learning_rate = args.lr or d["learning_rate"]
    t.lr_schedule = args.lr_schedule
    t.warmup_steps = args.warmup_steps
    t.weight_decay = d.get("weight_decay", 0.0)
    t.steps_per_epoch = args.steps_per_epoch
    if args.seq_len:
        t.seq_len = args.seq_len
    t.train_split = args.train_split
    t.chaos = args.chaos
    t.validate = not args.no_validate
    t.telemetry = not args.no_telemetry
    t.heartbeat_every = args.heartbeat_every
    t.health_policy = args.health_policy
    t.profile_dir = args.profile_dir
    t.prefetch_depth = args.prefetch_depth
    t.async_checkpoint = not args.no_async_checkpoint
    t.seed = args.seed
    t.lora = args.lora
    t.export_merged = args.export_merged
    t.dry_init = args.dry_init
    if job == "llama":
        t.model = f"llama_{args.llama_size}"
    if job in ("language_fsdp", "llama"):
        o.grad_clip_norm = 1.0  # the reference's clip 1.0
    o.precision = args.precision
    o.grad_accum_steps = args.grad_accum
    needs_remat = job == "llama" and args.llama_size in ("7b", "70b")
    o.remat = args.remat or ("full" if needs_remat else "none")
    o.compile_tier = args.compile_tier
    o.attention_impl = args.attention_impl
    dcfg = cfg.distributed
    if args.mesh:
        sizes = [int(x) for x in args.mesh.split(",")]
        if len(sizes) not in (4, 5, 6):
            raise SystemExit("--mesh wants data,fsdp,model,seq[,pipe"
                             f"[,expert]], got {args.mesh!r}")
        for name, v in zip(("data", "fsdp", "model", "seq", "pipe",
                            "expert"), sizes):
            setattr(dcfg, name, v)
    elif job == "language_fsdp" or (job == "llama" and not args.lora):
        dcfg.data, dcfg.fsdp = 1, -1  # the whole world on the fsdp axis
    return cfg


def run_job(args, job: str):
    from hyperion_tpu_torch.train import trainer

    cfg = make_config(args, job)
    if job == "llama":
        return trainer.train_llama(cfg, "llama", device=args.device)
    return trainer.train_language_model(cfg, job, device=args.device)


def train_main(argv: list[str]) -> int:
    p = build_parser()
    args = p.parse_args(argv)
    if args.model in DEFERRED_JOBS:
        print(f"hyperion_tpu_torch.cli.main: --model {args.model} is not "
              f"ported yet (ROADMAP {DEFERRED_JOBS[args.model]})",
              file=sys.stderr)
        return 2
    if args.supervise:
        # the supervisor imports no torch and re-execs THIS command
        # (minus the supervision flags) as the child it watches
        from hyperion_tpu_torch.supervisor import strip_flags
        from hyperion_tpu_torch.train.supervisor import supervise

        child = [sys.executable, "-m", "hyperion_tpu_torch.cli.main",
                 "train", *strip_flags(argv, {"--supervise"},
                                       {"--max-restarts"})]
        return supervise(child, base_dir=args.base_dir,
                         max_restarts=args.max_restarts)
    from hyperion_tpu_torch.supervisor import (
        EXIT_HEALTH_ABORT,
        EXIT_PREEMPTED,
    )

    from hyperion_tpu_torch.runtime import dist

    try:
        res = run_job(args, args.model)
        primary = dist.is_primary()  # cleanup forgets the rank
    finally:
        dist.cleanup()
    if primary:
        print("hyperion_tpu_torch.cli.main: the scaling report waits for "
              "metrics/scaling_report.py (ROADMAP A9); skipped",
              file=sys.stderr)
    if res.preempted == "health_abort":
        return EXIT_HEALTH_ABORT
    return EXIT_PREEMPTED if res.preempted else 0


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    verb = argv[0] if argv else ""
    if verb == "serve":
        from hyperion_tpu_torch.serve.server import main as serve_main

        return serve_main(argv[1:])
    if verb == "route":
        # the router process imports no torch; only its replicas do
        from hyperion_tpu_torch.serve.router import main as route_main

        return route_main(argv[1:])
    if verb in DEFERRED_VERBS:
        print(f"hyperion_tpu_torch.cli.main: `{verb}` is not ported yet "
              f"(ROADMAP {DEFERRED_VERBS[verb]})", file=sys.stderr)
        return 2
    return train_main(argv[1:] if verb == "train" else argv)


if __name__ == "__main__":
    raise SystemExit(main())
