"""Training substrate: optimizer, loop, gradient compression (a port of the
JAX package's ``repro.train``)."""
from repro_torch.train.grad_compress import make_int8_compressor
from repro_torch.train.optimizer import AdamW, AdamWConfig, lr_schedule
from repro_torch.train.train_loop import TrainConfig, train

__all__ = ["AdamW", "AdamWConfig", "TrainConfig", "lr_schedule",
           "make_int8_compressor", "train"]
