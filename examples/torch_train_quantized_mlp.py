"""The paper's end-to-end scenario (§4.1) on the PyTorch port: train the
784-256-128-64-10 MLP, quantize its last layer at 4, 8 and 16 values,
measure the accuracy it costs, then recover it with 100 steps of QAT
(straight-through) fine-tuning.

    PYTHONPATH=src python examples/torch_train_quantized_mlp.py [--device cpu]

The data is the synthetic MNIST stand-in (``models.mlp.synthetic_mnist``,
seed 0) and the initial weights are drawn on the host from torch seed 0,
then moved to the device. Returns (``main``) the baseline accuracies and,
per codebook size, the PTQ and the QAT-recovered test accuracy.
"""
import argparse
import sys
import time

import torch

from repro_torch.core import quantize
from repro_torch.device import resolve_device, where
from repro_torch.models.mlp import (init_mlp, mlp_accuracy, qat_recover,
                                    synthetic_mnist, train_paper_mlp)
from repro_torch.tree import tree_map


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; fails without a GPU) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    card = where(dev)

    t0 = time.perf_counter()
    (xtr, ytr), (xte, yte) = synthetic_mnist(seed=0)
    xtr, ytr, xte, yte = (torch.from_numpy(a).to(dev)
                          for a in (xtr, ytr, xte, yte))
    p0 = init_mlp(torch.Generator().manual_seed(0), device="cpu")
    params = train_paper_mlp(tree_map(lambda t: t.to(dev), p0), xtr, ytr)
    acc_tr = float(mlp_accuracy(params, xtr, ytr))
    acc_te = float(mlp_accuracy(params, xte, yte))
    print(f"baseline: train {acc_tr:.4f}  test {acc_te:.4f}  on {card}")
    w = params[-1]["w"].detach()

    out = {}
    for l in (4, 8, 16):
        qt, info = quantize(w, f"kmeans_ls@{l}:weighted=true")
        ptq = params[:-1] + [dict(params[-1], w=qt.to_dense())]
        acc_q = float(mlp_accuracy(ptq, xte, yte))
        # QAT recovery: fine-tune through the quantizer
        qat = qat_recover(params, qt.codebook, xtr, ytr)
        acc_qat = float(mlp_accuracy(qat, xte, yte))
        out[l] = {"ptq": acc_q, "qat": acc_qat,
                  "n_values": info["n_values"], "l2_loss": info["l2_loss"]}
        print(f"l={l:3d}: PTQ test acc {acc_q:.4f}  ->  QAT-recovered "
              f"{acc_qat:.4f}  (n_values={info['n_values']}, "
              f"l2={info['l2_loss']:.4f})")
    dt = time.perf_counter() - t0
    print(f"{dt:.1f} s on {card}")
    return {"device": dev.type, "card": card, "acc_train": acc_tr,
            "acc_test": acc_te, "by_values": out, "seconds": dt}


if __name__ == "__main__":
    main(sys.argv[1:])
