"""Paper §5 on the port: HI as a binary relevance filter, the dog-breed use
case (the torch copy of ``examples/dog_filter_hi.py``).

S-ML = 0.23 MB binary CNN (dog / not-dog) on the ED, trained by the port's
``train_cnn``; images classified as dogs (p >= 0.5) are the COMPLEX samples
and are offloaded to a (per the paper, assumed-perfect) dog-breed L-ML at
the ES.  Irrelevant images never leave the device.

Prints the Table-3 comparison next to the paper's exact published counts.
On the card by default; ``--device cpu`` trains on the CPU.

  PYTHONPATH=src python examples/dog_filter_hi_torch.py [--fast]
"""
import argparse

import numpy as np

from repro_torch.core import replay
from repro_torch.data import images
from repro_torch.models import cnn
from repro_torch.training.cnn_trainer import predict_logits, train_cnn


def main(fast: bool = False, device: str = "cuda", sizes=None) -> dict:
    n_tr, n_te, epochs = sizes or ((3000, 1000, 2) if fast
                                   else (8000, 10_000, 4))
    x_tr, y_tr = images.make_dataset(n_tr, seed=0)
    x_te, y_te = images.make_dataset(n_te, seed=7)
    b_te = images.binary_labels(y_te)

    # train recall-oriented: oversample dogs to 50% (with the natural 10%
    # prior a tiny filter collapses to always-negative)
    b_all = images.binary_labels(y_tr)
    rng = np.random.default_rng(0)
    pos, neg = np.flatnonzero(b_all == 1), np.flatnonzero(b_all == 0)
    idx = rng.permutation(np.concatenate(
        [rng.choice(pos, size=len(neg), replace=True), neg]))
    x_bal, b_bal = x_tr[idx], b_all[idx]

    print(f"training S-ML relevance filter ({cnn.SML_BINARY.name}) ...")
    ps = train_cnn(cnn.SML_BINARY, x_bal, b_bal, epochs=epochs, verbose=True,
                   device=device)
    print(f"S-ML size {cnn.model_size_mb(ps):.2f} MB int8 (paper: 0.23 MB)")

    # decision rule (paper SS5): offload iff p >= 0.5
    p = 1 / (1 + np.exp(-predict_logits(ps, cnn.SML_BINARY, x_te)[:, 0]))
    offload = p >= 0.5

    dogs = b_te == 1
    tp = int((offload & dogs).sum())          # dogs reaching the L-ML
    fn = int((~offload & dogs).sum())         # missed dogs
    fp = int((offload & ~dogs).sum())         # irrelevant images offloaded
    n_dogs = int(dogs.sum())
    acc = tp / max(n_dogs, 1)                 # paper's accuracy metric

    print(f"\n=== Table 3 (synthetic-data reproduction, N={n_te}, "
          f"{n_dogs} dogs) ===")
    print(f"offloaded: {tp + fp} ({tp} dogs + {fp} false positives)")
    print(f"missed dogs (false negatives): {fn}")
    print(f"accuracy (dogs reaching L-ML): {acc:.1%}")
    print(f"HI cost: {tp}*beta + {fp}")
    print(f"full-offload cost: {n_dogs}*beta + {n_te - n_dogs}")
    reduction = {}
    for beta in (0.1, 0.5, 0.9):
        hi_c = tp * beta + fp
        full_c = n_dogs * beta + (n_te - n_dogs)
        reduction[beta] = 1 - hi_c / full_c
        print(f"  beta={beta}: cost reduction {reduction[beta]:.1%}")

    print("\n=== Table 3 (paper's published counts, replayed exactly) ===")
    d = replay.DogReplay()
    print(f"offloaded: {d.n_offloaded} ({d.offloaded_dogs} dogs + "
          f"{d.false_positives} false positives); accuracy {d.accuracy:.1%}")
    print(f"HI cost: {d.offloaded_dogs}*beta + {d.false_positives}")
    replayed = {}
    for beta in (0.1, 0.5, 0.9):
        replayed[beta] = d.cost_reduction(beta)
        print(f"  beta={beta}: cost reduction {replayed[beta]:.1f}% "
              f"(paper range: 50-60%)")
    return {"p": p, "offload": offload, "tp": tp, "fn": fn, "fp": fp,
            "n_dogs": n_dogs, "accuracy": acc, "reduction": reduction,
            "replayed": replayed}


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--fast", action="store_true")
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args()
    main(a.fast, a.device)
