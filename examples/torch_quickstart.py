"""Quickstart on the PyTorch port: quantize a vector with every registered
method (the paper's and ours), on the card.

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]

The vector is the reference quickstart's (numpy seed 0, 2,000 normals
rounded to 2 decimals, so values repeat); ``quantize`` runs on the
tensor's device. Returns (``main``) each spec's n_values, l2 loss, bytes
and seconds, and kmeans_ls@16's compression.
"""
import argparse
import sys
import time

import numpy as np
import torch

from repro_torch.core import quantize, registry
from repro_torch.device import resolve_device, where


def spec_of(method: str) -> str:
    """The spec the quickstart runs a method at."""
    return (f"{method}:lam=0.05"
            if registry.get(method).param_kind == "lam" else f"{method}@16")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; fails without a GPU) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    rng = np.random.default_rng(0)
    w_np = rng.normal(0, 1, 2000).round(2)   # duplicates -> 'm' unique values
    w = torch.from_numpy(w_np).to(dev)
    card = where(dev)

    print(f"{'spec':20s} {'n_values':>8s} {'l2_loss':>10s} {'bytes':>7s} "
          f"{'time':>8s}   on {card}")
    rows = {}
    for method in registry.methods():
        spec = spec_of(method)
        t0 = time.perf_counter()
        qt, info = quantize(w, spec)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        dt = time.perf_counter() - t0
        rows[spec] = {"n_values": info["n_values"],
                      "l2_loss": info["l2_loss"],
                      "bytes": info["compressed_bytes"], "time_s": dt}
        print(f"{spec:20s} {info['n_values']:8d} {info['l2_loss']:10.4f} "
              f"{info['compressed_bytes']:7d} {dt * 1e3:7.1f}ms")

    qt, info = quantize(w, "kmeans_ls@16")
    dense = w_np.size * 4
    ratio = dense / qt.nbytes()
    print(f"\ndense bytes: {dense}, compressed: {qt.nbytes()} "
          f"({ratio:.1f}x), codebook: "
          f"{qt.codebook.cpu().numpy()[:5]}...")
    return {"device": dev.type, "card": card, "methods": rows,
            "kmeans_ls16": {"dense_bytes": dense,
                            "compressed_bytes": qt.nbytes(),
                            "ratio": ratio}}


if __name__ == "__main__":
    main(sys.argv[1:])
