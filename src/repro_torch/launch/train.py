"""Training launcher: a port of the JAX package's ``launch/train.py`` (the
same options, plus ``--device``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \\
        --smoke --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \\
        --steps 100 --ckpt /path/to/ckpt        # on the card

``--smoke`` trains the reduced config. ``--model-axis`` > 1 asks for the
reference's sharded run, which needs several cards: it raises (ROADMAP §1
item 1).
"""
from __future__ import annotations

import argparse

from repro_torch.configs import get_config, list_archs, smoke_config
from repro_torch.train import AdamWConfig, TrainConfig, train
from repro_torch.train.grad_compress import make_int8_compressor


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=list_archs())
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU end-to-end)")
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--global-batch", type=int, default=4)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--compress-grads", action="store_true",
                    help="int8 gradient compression w/ error feedback")
    ap.add_argument("--model-axis", type=int, default=1)
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (the kernels) or 'cpu' (the plain path)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = smoke_config(cfg)
    if args.model_axis > 1:
        raise NotImplementedError(
            f"--model-axis {args.model_axis} shards the model over several "
            f"cards; the port runs on one (ROADMAP §1 item 1: multi-card)")

    out = train(
        cfg,
        TrainConfig(
            steps=args.steps, log_every=max(1, args.steps // 20),
            checkpoint_every=max(2, args.steps // 4),
            checkpoint_dir=args.ckpt,
            global_batch=args.global_batch, seq_len=args.seq_len,
            optimizer=AdamWConfig(learning_rate=args.lr,
                                  warmup_steps=max(1, args.steps // 10),
                                  total_steps=args.steps)),
        device=args.device,
        grad_transform=(make_int8_compressor(cfg) if args.compress_grads
                        else None))
    print(f"done: final_loss={out['final_loss']:.4f} "
          f"mean_step={out['mean_step_ms']:.0f}ms")


if __name__ == "__main__":
    main()
