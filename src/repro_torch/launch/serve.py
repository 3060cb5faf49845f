"""Serving launcher: continuous-batching engine over synthetic requests.

Port of ``repro.launch.serve``, on the card by default:

    PYTHONPATH=src python -m repro_torch.launch.serve --requests 8
    PYTHONPATH=src python -m repro_torch.launch.serve --reduced --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-2.7b
    PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-2.7b \
        --reduced --device cpu

The default arch is qwen2.5-3b (dense, K5 and K6 on the card);
mamba2-2.7b serves the ssm family, whose prefill runs K7 once per layer.

The flags are the JAX launcher's, without ``--mesh`` (serving across cards
is ROADMAP queue 1) and with ``--device``.  ``--reduced`` is a real switch
here, off by default, so the full config is served unless it is asked
for; the JAX launcher reduces whatever the flag says.  Weights are random,
drawn from ``--seed``.
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from .. import configs
from ..models import api
from ..serve import Engine, Request


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=configs.ARCH_IDS, default="qwen2.5-3b")
    ap.add_argument("--reduced", action=argparse.BooleanOptionalAction,
                    default=False)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=12)
    ap.add_argument("--max-seq", type=int, default=256)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' runs the "
                         "kernels' plain versions)")
    args = ap.parse_args(argv)

    cfg = (configs.get_reduced if args.reduced else configs.get_config)(
        args.arch)
    if cfg.encoder_only:
        print(f"{args.arch} is encoder-only: no serving path")
        return 2
    device = api.resolve_device(args.device)
    params = api.init_params(cfg, args.seed, device=device)
    engine = Engine(cfg, params, slots=args.slots, max_seq=args.max_seq,
                    device=device)

    rng = np.random.default_rng(args.seed)
    t0 = time.time()
    for i in range(args.requests):
        plen = int(rng.integers(4, 24))
        engine.submit(Request(
            rid=i, prompt=rng.integers(0, cfg.vocab, plen).astype(np.int32),
            max_new=args.max_new))
    finished = engine.run()
    dt = time.time() - t0
    tokens = sum(len(r.generated) for r in finished)
    where = ("CPU" if device.type == "cpu"
             else torch.cuda.get_device_name(device))
    print(f"served {len(finished)} requests, {tokens} tokens "
          f"in {dt:.1f}s ({tokens/dt:.1f} tok/s on {where})")
    for r in finished[:3]:
        print(f"  req{r.rid}: prompt[:4]={r.prompt[:4].tolist()} "
              f"-> {r.generated[:8]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
