"""Training launcher: a port of the JAX package's ``launch/train.py`` (the
same options, plus ``--device``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \\
        --smoke --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \\
        --steps 100 --ckpt /path/to/ckpt        # on the card

``--smoke`` trains the reduced config. Under ``torchrun`` (one process a
rank) it trains on the mesh (world // model_axis, model_axis) ("data",
"model"), with NCCL on the card or gloo on the CPU (by ``--device``); the
ranks of a ``model`` group split each block's compute between them
(``dist.tensor_parallel``: heads, MLP columns, experts, the vocabulary):

    torchrun --nproc-per-node 2 -m repro_torch.launch.train \
        --arch qwen3-0.6b --smoke --device cpu --model-axis 2

``--model-axis`` > 1 without a distributed environment raises and says
how to launch.
"""
from __future__ import annotations

import argparse
import os

import torch
import torch.distributed as dist

from repro_torch.configs import get_config, list_archs, smoke_config
from repro_torch.launch.mesh import init_distributed, make_local_mesh
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
    ap.add_argument("--fsdp", action="store_true",
                    help="also shard parameters over the data axis")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = smoke_config(cfg)
    mesh = None
    if args.model_axis > 1 or int(os.environ.get("WORLD_SIZE", "1")) > 1:
        init_distributed(backend="gloo" if args.device == "cpu"
                         else "nccl")
        if args.device != "cpu" and "LOCAL_RANK" in os.environ:
            torch.cuda.set_device(int(os.environ["LOCAL_RANK"]))
        mesh = make_local_mesh(model_axis=args.model_axis,
                               device=None if args.device == "cuda"
                               else args.device)
        if mesh.rank == 0:
            print(mesh.describe())

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
        device=args.device, mesh=mesh, fsdp=args.fsdp,
        grad_transform=(make_int8_compressor(cfg) if args.compress_grads
                        else None))
    if mesh is None or mesh.rank == 0:
        print(f"done: final_loss={out['final_loss']:.4f} "
              f"mean_step={out['mean_step_ms']:.0f}ms")
    if mesh is not None:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
