"""Training entry point: the reference's ``launch/train.py``, on one device or,
with ``mesh=`` (a ``launch/mesh.Mesh``), data parallel over its ``data``
axis (``trainer.make_train_step``), every rank feeding the same batches.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-1.5b \
      --steps 50 --batch 8 --seq 64

Runs on the card by default; ``--device cpu`` runs on the CPU (the tests).
Reduced configs by default; ``--full`` trains the published config.  The
enc-dec and VLM families get random ``frames`` / ``patches`` from a torch
generator seeded per step (the reference draws them from ``jax.random``,
so those numbers differ).
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.checkpoint import io as ckpt_io
from repro_torch.configs.base import TrainConfig
from repro_torch.configs.registry import ARCHS
from repro_torch.data import tokens as token_data
from repro_torch.models import model_zoo
from repro_torch.optim import adamw
from repro_torch.training import trainer


def run(arch: str, *, reduced: bool = True, steps: int = 50, batch: int = 8,
        seq: int = 64, lr: float = 1e-3, grad_accum: int = 1,
        ckpt_dir: str = "", log_every: int = 10, seed: int = 0,
        device: str = "cuda", mesh=None):
    """Train ``steps`` steps and return the losses.  ``run.stats`` then
    holds the step loop's ``seconds`` and ``tokens_per_s`` (set-up and the
    checkpoint excluded, as in the reference's report).  On ``mesh`` the
    run uses the mesh's device."""
    if mesh is not None:
        device = mesh.device
    cfg = ARCHS[arch]
    if reduced:
        cfg = cfg.reduced()
    tcfg = TrainConfig(lr=lr, total_steps=steps, warmup_steps=max(1, steps // 10),
                       grad_accum=grad_accum, bf16_state=False, remat=False)
    gen = torch.Generator(device=device).manual_seed(seed)
    params = model_zoo.init_params(gen, cfg)
    opt = adamw.init_state(params, tcfg)
    step_fn = trainer.make_train_step(cfg, tcfg, mesh)

    losses = []
    t0 = time.time()
    for i, batch_np in enumerate(token_data.lm_batches(cfg.vocab_size, batch,
                                                       seq, steps, seed)):
        b = {k: torch.as_tensor(v).to(device) for k, v in batch_np.items()}
        noise = torch.Generator(device=device).manual_seed(i)
        if cfg.family == "encdec":
            b["frames"] = torch.randn((batch, cfg.num_audio_frames,
                                       cfg.d_model), generator=noise,
                                      device=device)
        if cfg.family == "vlm":
            b["patches"] = torch.randn((batch, cfg.num_patches, cfg.d_model),
                                       generator=noise, device=device)
        params, opt, metrics = step_fn(params, opt, b)
        losses.append(float(metrics["loss"]))
        if i % log_every == 0:
            print(f"step {i:4d} loss {losses[-1]:.4f} "
                  f"lr {float(metrics['lr']):.2e} "
                  f"gnorm {float(metrics['grad_norm']):.2f}")
    dt = time.time() - t0
    run.stats = {"seconds": dt, "tokens_per_s": steps * batch * seq / dt}
    print(f"trained {steps} steps in {dt:.1f}s "
          f"({steps * batch * seq / dt:.0f} tok/s); "
          f"loss {losses[0]:.3f} -> {losses[-1]:.3f}")
    if ckpt_dir:
        ckpt_io.save(ckpt_dir, params, step=steps)
        print("saved checkpoint to", ckpt_dir)
    return losses


run.stats = {}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=sorted(ARCHS))
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--ckpt", default="")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    run(args.arch, reduced=args.reduced, steps=args.steps, batch=args.batch,
        seq=args.seq, lr=args.lr, grad_accum=args.grad_accum,
        ckpt_dir=args.ckpt, device=args.device)


if __name__ == "__main__":
    main()
