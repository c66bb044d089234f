"""Train a WGAN-GP on the 8-mode Gaussian mixture with LocalAdaSEG through
the PyTorch port's Parameter-Server engine (paper §5, offline proxy).

    PYTHONPATH=src python examples/torch_wgan_train.py
    PYTHONPATH=src python examples/torch_wgan_train.py --hetero --alpha 0.3
    PYTHONPATH=src python examples/torch_wgan_train.py --q8
    PYTHONPATH=src python examples/torch_wgan_train.py --device cpu

The port's counterpart of ``examples/wgan_train.py``; it imports nothing
of JAX. The generator/critic game runs as a ``repro_torch.models.
ModelWorker`` on ``repro_torch.ps.PSEngine`` with the fused update and
merge kernels (on the card; their plain versions on the CPU), driven
incrementally (``run(until_round=r)``) and evaluated on the global output
iterate z̄ (Line 14). ``--hetero`` gives each worker its own mixture of the
modes from a Dirichlet(α) row (``repro_torch.ps.heterogeneous_wgan``, as
``benchmarks/bench_wgan.py`` builds it); ``--q8`` sends 8-bit
stochastically quantized uplinks with error feedback.
"""
import argparse

import torch

from repro_torch import random as jr
from repro_torch.core import AdaSEGConfig
from repro_torch.models import ModelWorker
from repro_torch.problems import make_wgan_problem
from repro_torch.problems.wgan import NET_LEAVES
from repro_torch.ps import (
    PSConfig,
    PSEngine,
    StochasticQuantizeCompressor,
    heterogeneous_wgan,
)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workers", type=int, default=4)
    ap.add_argument("--k-local", type=int, default=20)
    ap.add_argument("--rounds", type=int, default=10)
    ap.add_argument("--rounds-total", type=int, default=50)
    ap.add_argument("--hetero", action="store_true")
    ap.add_argument("--alpha", type=float, default=0.6)
    ap.add_argument("--q8", action="store_true",
                    help="q8 stochastic-quantize uplinks + error feedback")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    dev = args.device
    wg = make_wgan_problem(jr.PRNGKey(0, device=dev))
    problem = wg.problem
    if args.hetero:
        problem = heterogeneous_wgan(wg, args.workers,
                                     jr.PRNGKey(7, device=dev),
                                     alpha=args.alpha)
        print(f"heterogeneous: Dirichlet(α={args.alpha}) mode weights/worker")

    cfg = AdaSEGConfig(g0=50.0, diameter=1.0, alpha=1.0, k=args.k_local,
                       average_output=False)
    eval_rng = jr.PRNGKey(99, device=dev)
    engine = PSEngine(
        problem,
        PSConfig(
            worker=ModelWorker(cfg, backend="fused", arch=problem.name),
            local_k=args.k_local, num_workers=args.workers,
            rounds=args.rounds_total, codec_backend="fused",
            compressor=(StochasticQuantizeCompressor(bits=8) if args.q8
                        else None),
        ),
        rng=jr.PRNGKey(1, device=dev),
        eval_fn=lambda z: wg.wasserstein_estimate(z, eval_rng),
        device=dev,
    )
    for r in range(args.rounds, args.rounds_total + 1, args.rounds):
        z = engine.run(until_round=r)
        w_est = float(wg.wasserstein_estimate(z, eval_rng))
        md = float(wg.moment_distance(z, eval_rng))
        print(f"rounds {r:3d}: W-estimate = {w_est:+.4f}   "
              f"moment-distance = {md:.4f}")
    samples = wg.generate(engine.z_bar()[:NET_LEAVES],
                          jr.PRNGKey(3, device=dev), 8)
    print("generated samples (first 8):")
    print(torch.round(samples.cpu(), decimals=2))


if __name__ == "__main__":
    main()
