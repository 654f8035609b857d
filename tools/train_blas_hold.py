#!/usr/bin/env python3
"""Hold the one-card float32 train step of ``tools/train_mesh_cards.py``'s
hold cell against the same step computed in another order on the same
card, by that tool's bound.

Run from the root of a checkout on a host with a card::

    python3 tools/train_blas_hold.py [--seed 0]

The cell is the hold part's: qwen3-8b at its published widths, 2 of 36
blocks, float32 compute, remat, one step of 2 × 4,096 tokens from the
state ``--seed`` draws, mesh-less. The reference runs as that tool's
one-card reference does. Each variant runs the same step where only the
order of float32 sums differs:

  * ``micro2`` — ``make_train_step(microbatch=2)``: each weight gradient
    summed over two halves of the tokens, then averaged;
  * ``cublaslt`` — ``torch.backends.cuda.preferred_blas_library
    ("cublaslt")``: the GEMMs through cuBLASLt's kernels.

For each variant and leaf it reports max |g − g_ref| over the largest
|g_ref| (the gradients read off the first moments, ``grad_rel``) and the
elements beyond the first Adam step's bound (`train_mesh_cards._hold_leaf`,
1e-6 of the leaf's largest gradient carried through the step). It prints
the card's name and power limit and a JSON line, writes it to
``chiprun_out/train_blas_hold.json``, and exits 0 whether or not the
bound holds: it measures the bound, it is not a check of the port.
``--rehearse`` runs the ``micro2`` variant at the smoke config on the CPU.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parents[1]


def _run(cfg, batch, opt, dev, seed, microbatch=None):
    """One step from the seed's state: ``{leaf: (param, mu, nu)}`` on the
    host, and the learning rate."""
    import torch

    from repro_torch.train import init_state, make_train_step

    state = init_state(torch.Generator(device=dev).manual_seed(seed), cfg,
                       opt, device=dev)
    metrics = make_train_step(cfg, opt, device=dev,
                              microbatch=microbatch)(state, batch)[1]
    out = {n: (p.detach().cpu(), state.opt_state["mu"][n].cpu(),
               state.opt_state["nu"][n].cpu())
           for n, p in state.model.named_parameters()}
    return out, float(metrics["lr"])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--rehearse", action="store_true",
                    help="the micro2 variant at the smoke config on the CPU")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(REPO / "src"))
    sys.path.insert(0, str(REPO / "tools"))
    import torch

    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.optim import AdamWConfig, warmup_cosine
    from train_mesh_cards import _cfgs, _hold_leaf

    if args.rehearse:
        dev = torch.device("cpu")
    else:
        if not torch.cuda.is_available():
            print("train_blas_hold: needs a CUDA card", file=sys.stderr)
            return 2
        dev = torch.device("cuda", 0)
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip(), flush=True)
    cfg, _, rows, seq = _cfgs(args.rehearse)
    opt = AdamWConfig(lr=warmup_cosine(3e-4, 2, 10))
    batch = TokenPipeline(cfg.vocab, seq, rows, seed=args.seed).batch_at(0)
    ref, lr = _run(cfg, batch, opt, dev, args.seed)
    variants = {"micro2": dict(microbatch=2)}
    if not args.rehearse:
        variants["cublaslt"] = dict(blas="cublaslt")
    out = {"device": str(dev), "variants": {}}
    for name, v in variants.items():
        if "blas" in v:
            torch.backends.cuda.preferred_blas_library(v["blas"])
        got, _ = _run(cfg, batch, opt, dev, args.seed, v.get("microbatch"))
        if "blas" in v:
            torch.backends.cuda.preferred_blas_library("cublas")
        bad, g_rel = [], {}
        for n, r in ref.items():
            msgs, g_rel[n] = _hold_leaf([t.to(dev) for t in got[n]],
                                        [t.to(dev) for t in r], lr=lr,
                                        b1=opt.b1, b2=opt.b2, eps=opt.eps,
                                        what=n)
            bad += msgs
        del got
        worst = max(g_rel, key=g_rel.get)
        out["variants"][name] = {"grad_rel": g_rel, "failures": bad,
                                 "worst": [worst, g_rel[worst]]}
        print(f"{name}: gradients within {g_rel[worst]:.3e} of a leaf's "
              f"largest ({worst}); beyond the bound: {bad or 'none'}",
              flush=True)
    print(json.dumps(out))
    dest = REPO / "chiprun_out"
    dest.mkdir(exist_ok=True)
    (dest / ("train_blas_hold_rehearsal.json" if args.rehearse
             else "train_blas_hold.json")).write_text(json.dumps(out,
                                                                indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
