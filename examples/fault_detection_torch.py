"""Paper §3 on the port: HI for rolling-element (REB) fault diagnosis (the
torch copy of ``examples/fault_detection.py``).

S-ML = the paper's moving-average threshold rule (mean |x| of a 4096-sample
window vs 0.07) running on the sensor; L-ML = the 8-layer CNN of [38]
classifying the 10 machine states, deployed at the ES and trained here by
the port's ``train_cnn``.  Only windows the threshold flags as NOT-normal
are offloaded.  On the card by default; ``--device cpu`` trains on the CPU.
``--fast`` cuts the data and epochs (the reference's budget is 1,000 windows
and 20 epochs).

  PYTHONPATH=src python examples/fault_detection_torch.py [--fast]
"""
import argparse

from repro_torch.data import vibration as vib
from repro_torch.models import cnn
from repro_torch.training.cnn_trainer import accuracy, train_cnn


def main(windows_per_state: int = 100, epochs: int = 20,
         device: str = "cuda") -> dict:
    # --- train the L-ML fault CNN on (balanced) fault data -----------------
    x_tr, y_tr, _ = vib.make_dataset(windows_per_state=windows_per_state,
                                     seed=0)
    x_te, y_te, means_te = vib.make_dataset(windows_per_state=25, seed=1)
    print(f"training {cnn.FAULT_CNN.name} on {len(x_tr)} windows ...")
    params = train_cnn(cnn.FAULT_CNN, x_tr, y_tr, epochs=epochs, batch=64,
                       lr=2e-3, device=device)
    cnn_acc = accuracy(params, cnn.FAULT_CNN, x_te, y_te)
    print(f"L-ML (CNN) 10-state accuracy: {cnn_acc:.1%} "
          f"(paper's CNN [38]: 99.6%)")

    # --- the S-ML threshold rule (paper: theta = 0.07) ----------------------
    is_fault_pred = vib.threshold_sml(means_te, theta=0.07)
    is_fault_true = y_te != 0
    tp = (is_fault_pred & is_fault_true).sum()
    tn = (~is_fault_pred & ~is_fault_true).sum()
    sml_acc = (tp + tn) / len(y_te)
    print(f"threshold S-ML normal-vs-fault accuracy: {sml_acc:.1%}  "
          f"(paper: 100%)")

    # --- HI deployment: realistic duty cycle (machines mostly normal) ------
    x_op, y_op, means_op = vib.make_dataset(windows_per_state=40, seed=2,
                                            normal_fraction=0.98)
    offload = vib.threshold_sml(means_op, 0.07)
    frac = offload.mean()
    print(f"\noperational stream: {len(y_op)} windows, "
          f"{(y_op == 0).mean():.1%} normal")
    print(f"HI offloads {offload.sum()}/{len(y_op)} windows ({frac:.2%})")

    full_bw = vib.bandwidth_required(num_machines=100)
    print(f"full-offload bandwidth for 100 machines: {full_bw:.1f} Mbps "
          f"(paper: >= 76.8 Mbps)")
    print(f"HI bandwidth: {full_bw * frac:.2f} Mbps "
          f"-> {(1 - frac):.1%} bandwidth saved")

    # fault windows that do offload get classified by the CNN
    acc_off = None
    if offload.any():
        acc_off = accuracy(params, cnn.FAULT_CNN,
                           x_op[offload], y_op[offload])
        print(f"CNN accuracy on offloaded windows: {acc_off:.1%}")

    missed = int((~offload & (y_op != 0)).sum())
    print(f"fault windows missed by the threshold: {missed}")
    return {"cnn_acc": cnn_acc, "sml_acc": float(sml_acc),
            "offload": offload, "offload_frac": float(frac),
            "full_bw": full_bw, "acc_offloaded": acc_off, "missed": missed}


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--fast", action="store_true")
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args()
    main(*((30, 6) if a.fast else (100, 20)), device=a.device)
