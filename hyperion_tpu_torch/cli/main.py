"""CLI launcher of the port — `hyperion_tpu/cli/main.py`: the trainer
launcher (the default surface, `train` its explicit alias) and the
`serve`, `route`, `obs` and `simulate` verbs.

    python -m hyperion_tpu_torch.cli.main train --model language_ddp \\
        [--train-split test --data_dir data] [--supervise] ...
    python -m hyperion_tpu_torch.cli.main serve --ckpt model.npz ...
    python -m hyperion_tpu_torch.cli.main route --replicas 2 --ckpt ...
    python -m hyperion_tpu_torch.cli.main obs doctor <run dir>
    python -m hyperion_tpu_torch.cli.main simulate failover

`serve/server.py`, `serve/router.py`, `obs/report.py` (summarize,
doctor, diff, trace, top, profile) and `serve/simulate.py` own their
verbs' flags. The trainer launcher takes the reference's flags, plus
`--device` (cuda by default, `--device cpu` for the plain PyTorch
path), and runs the
reference's jobs: language_ddp, cifar (ResNet-18 on CIFAR-10),
language_fsdp, llama, `all` (the four in that order) and `scaling` (the
sweep of `bench/scaling.py`: on the visible cards, or on gloo CPU
ranks with `--simulate-cpu` or `--device cpu`). The primary
writes the scaling report over `{base_dir}/distributed` at the end of
every run that trains (a sweep writes its own; a `--dry-init` plan
trains nothing). It returns the reference's
exit codes: 0 done, 4 the health policy aborted a diverged run, 75
preempted with a resumable checkpoint (under `all` an abort outranks a
preemption; 2 a usage error; 3 a supervisor that gave up). The module
imports no torch: `--supervise` runs the trainer as a child process,
and the `obs` and `simulate` verbs are host tools.

Several ranks, as the reference launched them:

    torchrun --nproc-per-node N -m hyperion_tpu_torch.cli.main train \
        --model language_fsdp [--mesh data,fsdp,model,seq] ...
    python -m torch.distributed.run --nproc-per-node 2 -m \
        hyperion_tpu_torch.cli.main train --device cpu ...    # gloo

`--mesh` sets the axes (default: all data, or all fsdp for
language_fsdp and a full Llama fine-tune; seq runs with
`--attention-impl ring` or `ulysses`, pipe with `--pipe_microbatches`,
expert with `--moe_experts`); `--dry-init` prints the
TrainState's memory plan on the mesh and trains nothing (with explicit
axes it needs no process group and no device).
"""

from __future__ import annotations

import argparse
import sys

MODELS = ("language_ddp", "cifar", "language_fsdp", "llama", "all", "scaling")
ALL_JOBS = ("language_ddp", "cifar", "language_fsdp", "llama")

_JOB_DEFAULTS = {
    # the reference's per-job hyperparameters
    "language_ddp": dict(batch_size=32, learning_rate=2e-4),
    "language_fsdp": dict(batch_size=32, learning_rate=1e-4),
    "cifar": dict(batch_size=64, learning_rate=1e-3),
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
                   help="global batch (defaults per job: LM 32, CIFAR 64, "
                        "llama 8)")
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
    p.add_argument("--devices", type=int, default=0,
                   help="the world size this run expects (the sweep's "
                        "device count; 0 = any): a mismatch is a usage "
                        "error")
    p.add_argument("--scaling_devices", type=int, nargs="*", default=None,
                   help="device counts for --model scaling (default "
                        "1,2,4,8 cut to the visible cards, or to 8 "
                        "simulated)")
    p.add_argument("--scaling_jobs", nargs="*", default=None,
                   help="jobs for --model scaling (default: the four "
                        "reference jobs)")
    p.add_argument("--simulate-cpu", action="store_true",
                   help="scaling: run the sweep on gloo CPU ranks under "
                        "<base_dir>/simulated_cpu (also with --device cpu; "
                        "otherwise it runs on the visible cards)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--dry-init", action="store_true",
                   help="plan-only: print the TrainState's memory plan "
                        "(global and per-device bytes of params, grads "
                        "and AdamW state) on the mesh, and train nothing")
    p.add_argument("--mesh", default=None,
                   help="axis sizes data,fsdp,model,seq[,pipe[,expert]] "
                        "(e.g. 2,2,1,1 or 2,1,1,1,4); default: all-data, "
                        "or all-fsdp for language_fsdp and a full Llama "
                        "fine-tune")
    p.add_argument("--pipe_microbatches", type=int, default=0,
                   help="GPipe microbatches when the mesh has a pipe "
                        "axis (0 = one per stage)")
    p.add_argument("--moe_experts", type=int, default=0,
                   help="language jobs: >0 swaps in the MoE LM with this "
                        "many experts (shard them with --mesh's expert "
                        "axis)")
    p.add_argument("--moe_top_k", type=int, default=2)
    p.add_argument("--moe_every", type=int, default=2,
                   help="every k-th block of the MoE LM is sparse")
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
    p.add_argument("--compile-cache", default="",
                   help="directory the CUDA kernels' libraries are built "
                        "into and loaded from (one subdir per hash of "
                        "the sources and flags), so --supervise restarts "
                        "load them instead of rebuilding; default: the "
                        "HYPERION_COMPILE_CACHE variable, else "
                        "build/hyperion_tpu_torch. Rides through to "
                        "supervised children verbatim and is applied "
                        "in-process (never by mutating the environment)")
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
                   help="override just attention; ring/ulysses = "
                        "sequence parallelism over the mesh's seq axis")
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
    o.compile_cache = args.compile_cache
    t.moe_experts = args.moe_experts
    t.moe_top_k = args.moe_top_k
    t.moe_every = args.moe_every
    dcfg = cfg.distributed
    dcfg.max_devices = args.devices  # the reference's; the world is torchrun's
    dcfg.pipe_microbatches = args.pipe_microbatches
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


def setup_compile_cache(cache_dir: str | None):
    """Point the CUDA kernels' library cache (ops/build.py) at
    `cache_dir`, else the HYPERION_COMPILE_CACHE variable, else leave it
    at build/hyperion_tpu_torch: in-process, never by mutating the
    environment, as the reference applies its compile cache. Returns the
    resolved dir or None."""
    from hyperion_tpu_torch.ops import build

    resolved = build.resolve_cache_dir(cache_dir)
    build.set_cache_dir(resolved)
    if resolved is not None:
        print(f"[compile-cache] CUDA kernel libraries under {resolved}",
              flush=True)
    return resolved


def run_job(args, job: str):
    from hyperion_tpu_torch.train import trainer

    cfg = make_config(args, job)
    if job == "llama":
        return trainer.train_llama(cfg, "llama", device=args.device)
    if job == "cifar":
        return trainer.train_cifar_model(cfg, "cifar_ddp", device=args.device)
    return trainer.train_language_model(cfg, job, device=args.device)


def train_main(argv: list[str]) -> int:
    import os

    p = build_parser()
    args = p.parse_args(argv)
    if args.dry_init and args.model == "scaling":
        p.error("--dry-init plans a single job's TrainState; it does not "
                "apply to the scaling sweep (pick one of its jobs instead)")
    world = int(os.environ.get("WORLD_SIZE", "1") or 1)
    if args.devices and not args.dry_init and args.devices != world:
        p.error(f"--devices {args.devices} but the world has {world} "
                "rank(s): launch it with torchrun --nproc-per-node "
                f"{args.devices}")
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
    setup_compile_cache(args.compile_cache)
    from hyperion_tpu_torch.supervisor import (
        EXIT_HEALTH_ABORT,
        EXIT_PREEMPTED,
    )

    from hyperion_tpu_torch.metrics.scaling_report import (
        create_scaling_report,
    )
    from hyperion_tpu_torch.runtime import dist

    if args.model == "scaling":  # the sweep writes its own report
        from hyperion_tpu_torch.bench.scaling import (
            SCALING_JOBS,
            run_scaling_experiment,
        )

        try:
            run_scaling_experiment(
                device_counts=args.scaling_devices,
                models=args.scaling_jobs or SCALING_JOBS,
                epochs=args.epochs, base_dir=args.base_dir,
                steps_per_epoch=args.steps_per_epoch or 20,
                simulate_on_cpu=args.simulate_cpu or args.device == "cpu",
                batch_size=args.batch_size, validate=not args.no_validate,
                data_dir=args.data_dir)
        except RuntimeError as e:  # no card for any count
            p.error(str(e))
        return 0
    rc = 0
    try:
        jobs = ALL_JOBS if args.model == "all" else (args.model,)
        for job in jobs:  # `all` runs the four jobs in turn
            res = run_job(args, job)
            # a diverged verdict outranks a preemption from an earlier
            # job of `all`
            if res.preempted == "health_abort":
                rc = EXIT_HEALTH_ABORT
            elif res.preempted and rc == 0:
                rc = EXIT_PREEMPTED
        primary = dist.is_primary()  # cleanup forgets the rank
    finally:
        dist.cleanup()
    if primary and not args.dry_init:  # a plan trains nothing to report
        create_scaling_report(f"{args.base_dir}/distributed")
    return rc


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
    if verb == "obs":
        # telemetry tools (summarize, doctor, diff, trace, top, profile):
        # files and sockets only, no device touched
        from hyperion_tpu_torch.obs.report import main as obs_main

        return obs_main(argv[1:])
    if verb == "simulate":
        # the fleet flight simulator: the routing and queueing policy
        # code on a virtual clock, no device and no subprocess
        from hyperion_tpu_torch.serve.simulate import main as sim_main

        return sim_main(argv[1:])
    return train_main(argv[1:] if verb == "train" else argv)


if __name__ == "__main__":
    raise SystemExit(main())
