"""End-to-end training driver on the PyTorch port: train a causal LM for a few hundred steps.

    PYTHONPATH=src python examples/torch_train_lm.py                 # tiny, on the card
    PYTHONPATH=src python examples/torch_train_lm.py --preset 100m --steps 300
    PYTHONPATH=src python examples/torch_train_lm.py --arch mamba2-2.7b --smoke
    PYTHONPATH=src python examples/torch_train_lm.py --smoke --device cpu

Demonstrates the full substrate: seekable data pipeline → train step (grad
accumulation, bf16 grads, fp32 masters; attention through the K6 kernel and
Mamba-2's SSD through K7 on the card) → atomic checkpointing → crash-resume
(kill it mid-run and re-invoke: the trajectory continues from the last
checkpoint in ``--workdir``).
``--preset 100m`` is the deliverable-scale configuration for a real
accelerator host; the default runs in seconds.

``--device cuda`` (the default) trains on the card and fails when there is
none; ``--device cpu`` trains on the CPU (the kernels' plain versions).
"""

import argparse
import os
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).parents[1] / "src"))

from repro_torch.configs import ARCH_IDS, get_smoke
from repro_torch.core.engine import resolve_device
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models.config import ModelConfig, ShapeSpec
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train.loop import Trainer, TrainerConfig


def preset_100m() -> ModelConfig:
    """~100M-parameter llama-family config (deliverable (b) scale)."""
    return ModelConfig(
        name="llama-100m",
        n_layers=12,
        d_model=768,
        n_heads=12,
        n_kv_heads=4,
        d_ff=2048,
        vocab_size=32000,
    )


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b", help=f"{ARCH_IDS}")
    ap.add_argument("--preset", choices=["smoke", "100m"], default="smoke")
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--workdir", default=os.path.join(tempfile.gettempdir(), "repro_torch_train"))
    ap.add_argument("--smoke", action="store_true",
                    help="tiny CI run: smoke preset, 3 steps")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        print(f"torch_train_lm: {e}", file=sys.stderr)
        return 1
    if args.smoke:
        args.preset, args.steps = "smoke", min(args.steps, 3)
        args.seq, args.batch = min(args.seq, 32), min(args.batch, 2)

    cfg = preset_100m() if args.preset == "100m" else get_smoke(args.arch)
    mesh = make_host_mesh()
    shape = ShapeSpec("train", seq_len=args.seq, global_batch=args.batch, kind="train")
    trainer = Trainer(
        cfg, shape, mesh, args.workdir,
        TrainerConfig(total_steps=args.steps, checkpoint_every=max(args.steps // 5, 1),
                      log_every=max(args.steps // 10, 1)),
        opt=AdamWConfig(lr_peak=3e-3, warmup_steps=max(args.steps // 10, 1),
                        total_steps=args.steps),
        device=device,
    )
    print(f"training {cfg.name} ({cfg.n_params/1e6:.1f}M params) on mesh "
          f"{dict(mesh.shape)} for {args.steps} steps "
          f"(resumes from {args.workdir} if checkpoints exist)")
    result = trainer.run()
    for h in result["history"][:: max(len(result["history"]) // 10, 1)]:
        print(f"  step {h['step']:5d} loss {h['loss']:.4f} "
              f"gnorm {h['grad_norm']:.3f} lr {h['lr']:.2e} {h['dt']*1e3:.0f}ms")
    print(f"final loss: {result['final_loss']:.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
