"""End-to-end training example: train a ~100M-class LM for a few hundred
steps on the synthetic Markov-Zipf stream, with checkpointing and fault
tolerance. Runs on the card; `--device cpu` runs the plain PyTorch versions.

    PYTHONPATH=src python -m repro_torch.examples.train_lm --steps 300 [--arch qwen2.5-3b]

The arch's reduced ~100M variant (float32) is used, as in the JAX
package's `examples/train_lm.py`, which takes the same arguments and
prints the same summary. paligemma's and seamless's stub frontends get
seeded inputs beside the tokens (`data.tokens.stub_inputs`).
"""

import argparse

import numpy as np

from repro_torch.configs import ARCHS
from repro_torch.data.tokens import DataConfig
from repro_torch.models.config import reduced
from repro_torch.models.model_zoo import get_model
from repro_torch.train import optimizer as opt
from repro_torch.train.trainer import Trainer, TrainerConfig


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2.5-3b", choices=sorted(ARCHS))
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--ckpt-dir", default="build/train_lm_ckpt")
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    # ~100M-class variant of the chosen family (use --batch/--seq to trade
    # speed; a quick setting is --steps 120 --batch 4 --seq 128)
    cfg = reduced(ARCHS[args.arch], n_layers=12, d_model=768, d_ff=2048,
                  vocab=32768, n_heads=12, n_kv_heads=4, head_dim=64)
    model = get_model(cfg)
    n_params = cfg.param_count
    print(f"arch={cfg.name} family={cfg.family} params≈{n_params/1e6:.0f}M")

    trainer = Trainer(
        model,
        opt.OptimizerConfig(lr=6e-4, warmup_steps=30, total_steps=args.steps),
        TrainerConfig(total_steps=args.steps, checkpoint_every=100,
                      checkpoint_dir=args.ckpt_dir, log_every=20,
                      compress_grads=args.compress_grads),
        DataConfig(vocab=cfg.vocab, seq_len=args.seq, global_batch=args.batch),
        device=args.device,
    )
    out = trainer.run(resume=True)
    hist = out["history"]
    print(f"\nsteps run: {len(hist)}  restarts: {out['restarts']}")
    print(f"loss: first5={np.mean([h['loss'] for h in hist[:5]]):.3f} "
          f"last5={np.mean([h['loss'] for h in hist[-5:]]):.3f}")
    print(f"median step: {np.median([h['time'] for h in hist[3:]])*1e3:.0f} ms")
    return out


if __name__ == "__main__":
    main()
