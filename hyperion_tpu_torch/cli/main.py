"""CLI launcher of the port — `hyperion_tpu/cli/main.py`'s `serve` and
`route` verbs:

    python -m hyperion_tpu_torch.cli.main serve --ckpt model.npz ...
    python -m hyperion_tpu_torch.cli.main route --replicas 2 --ckpt ...

`serve/server.py` and `serve/router.py` own each verb's flags. The
reference's other verbs (the trainer launcher, `train`, `obs`,
`simulate`) are not ported yet: each exits 2 and names ROADMAP A9.
"""

from __future__ import annotations

import sys

DEFERRED = ("train", "obs", "simulate")


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
    what = f"`{verb}`" if verb in DEFERRED else "the trainer launcher"
    print(f"hyperion_tpu_torch.cli.main: {what} is not ported yet "
          "(ROADMAP A9); the port's verbs are `serve` and `route`",
          file=sys.stderr)
    return 2


if __name__ == "__main__":
    raise SystemExit(main())
