"""Model API: ``build_model(cfg)`` → ``ModelBundle``, for every family of
the JAX package's ``models/model_api.py``: the decoder-only ones (dense,
MoE, SSM, hybrid, VLM) and enc-dec (whisper).

  init(seed=0)                       → params (an ``LM`` or ``EncDec`` on
                                        the device)
  init_cache(batch, max_seq)         → decode caches (decoder-only: one
                                        dict per layer; enc-dec also takes
                                        ``params=`` and ``enc_out=``)
  decode(params, tokens, caches)     → (logits (B, V), caches, updated in
                                        place)
  prefill(params, batch)             → last-token logits (B, V)
  loss(params, batch)               → (scalar loss, {"nll", "aux"}; enc-dec
                                        {"nll"}), differentiable
  input_specs(shape)                 → {name: (shape, dtype)} of a batch

The reference's functions are pure and jitted; these run eagerly on the
bundle's device (``device=None`` means CUDA). ``input_specs`` gives the
reference's batch stand-ins (tokens, labels, VLM patches, enc-dec frames)
as (shape, torch dtype) pairs, and ``fill_inputs`` makes a batch of them
from an explicit generator (the census, ``launch/census.py``, runs one);
the reference's ``cache_specs`` has no counterpart, since the census
allocates the caches it runs.

The loss is the reference's, copied and not fixed: the chunked
cross-entropy reads the logits from the embedding table
(``params["embed"]["table"]`` there, ``params.embed`` here) for every
family, tied or not, so an untied ``lm_head`` gets no gradient in training.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig, ShapeSpec
from repro_torch.device import resolve_device
from repro_torch.dist import tensor_parallel as tp
from repro_torch.models import encdec, transformer


@dataclasses.dataclass
class ModelBundle:
    cfg: ArchConfig
    device: torch.device
    init: Callable
    loss: Callable
    init_cache: Callable
    decode: Callable
    prefill: Callable
    input_specs: Callable


def build_model(cfg: ArchConfig, *, device=None) -> ModelBundle:
    device = resolve_device(device)
    if cfg.enc_dec:
        return _build_encdec(cfg, device)
    return _build_lm(cfg, device)


# ---------------------------------------------------------------------------
# loss: chunked cross-entropy (vocab logits never fully materialized)
# ---------------------------------------------------------------------------
def _chunk_nll(h: torch.Tensor, table: torch.Tensor, y: torch.Tensor,
               vocab: int):
    """One chunk: (summed NLL over valid labels, count of valid labels),
    both float32 scalars. Where the ``vocab`` entries split over ``model``
    (``table`` whole, or the rank's rows of it) each rank takes its
    columns of the logits, and the row max, the sum of exponentials and
    the target logit take one all-reduce each."""
    valid = (y >= 0).to(torch.float32)
    m, j = tp.split(vocab, "vocab")
    if m == 1:
        logits = h.to(torch.float32) @ table.to(torch.float32).T  # (B,c,V)
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, y.clamp_min(0)[..., None])[..., 0]
        return ((lse - gold) * valid).sum(), valid.sum()
    part = tp.take(table, 0, m, j, vocab)
    logits = tp.copy_in(h, m).to(torch.float32) @ part.to(torch.float32).T
    top = tp.all_reduce(logits.detach().amax(-1), "max")
    sumexp = tp.reduce_out(torch.exp(logits - top[..., None]).sum(-1), m)
    lse = top + torch.log(sumexp)
    local = y.clamp_min(0) - j * (vocab // m)
    hit = (local >= 0) & (local < part.shape[0])
    gold = torch.gather(logits, -1, torch.where(hit, local, 0)[..., None])
    gold = tp.reduce_out(gold[..., 0] * hit.to(torch.float32), m)
    return ((lse - gold) * valid).sum(), valid.sum()


def chunked_xent(hidden: torch.Tensor, table: torch.Tensor,
                 labels: torch.Tensor, chunk: int = 2048,
                 vocab: int | None = None) -> torch.Tensor:
    """hidden (B, S, d) × table (V, d) × labels (B, S) → mean NLL over the
    labels ≥ 0 (float32 scalar), as the reference's ``chunked_xent``: S is
    padded to a multiple of ``chunk`` with label −1, and the (B, chunk, V)
    float32 logits exist one chunk at a time. Where a graph is built each
    chunk is checkpointed, so its logits are recomputed in the backward
    pass instead of kept (the reference's ``lax.scan`` body)."""
    b, s, d = hidden.shape
    chunk = min(chunk, s)
    if s % chunk:
        pad = chunk - s % chunk
        hidden = torch.nn.functional.pad(hidden, (0, 0, 0, pad))
        labels = torch.nn.functional.pad(labels, (0, pad), value=-1)
        s += pad
    remat = torch.is_grad_enabled() and (hidden.requires_grad
                                         or table.requires_grad)
    tot = torch.zeros((), dtype=torch.float32, device=hidden.device)
    cnt = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for c0 in range(0, s, chunk):
        args = (hidden[:, c0:c0 + chunk], table, labels[:, c0:c0 + chunk],
                vocab)
        nll, n = (checkpoint(tp.captured(_chunk_nll), *args,
                             use_reentrant=False)
                  if remat else _chunk_nll(*args))
        tot, cnt = tot + nll, cnt + n
    return tot / torch.clamp_min(cnt, 1.0)


def fill_inputs(specs: dict, vocab: int, generator: torch.Generator,
                device=None) -> dict:
    """A batch for ``input_specs``' stand-ins, drawn from ``generator`` (a
    CPU generator, so a seed gives the same batch on every device):
    integer specs uniform over the vocabulary, floating ones standard
    normal; moved to ``device`` (None: CUDA)."""
    device = resolve_device(device)
    out = {}
    for name, (shape, dtype) in specs.items():
        if dtype.is_floating_point:
            x = torch.randn(shape, generator=generator).to(dtype)
        else:
            x = torch.randint(0, vocab, shape, generator=generator,
                              dtype=dtype)
        out[name] = x.to(device)
    return out


def _labels(batch: dict, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(batch["labels"], dtype=torch.long, device=device)


def _build_lm(cfg: ArchConfig, device: torch.device) -> ModelBundle:
    is_vlm = cfg.family == "vlm"

    def init(seed: int = 0):
        return transformer.init_lm(cfg, seed, device)

    def loss(params, batch):
        """Mean next-token NLL over the tokens plus the MoE aux loss (VLM:
        over the token suffix only, after the patches)."""
        patches = batch.get("patches") if is_vlm else None
        hidden, aux = transformer.forward(params, batch["tokens"],
                                          patch_embeds=patches)
        if is_vlm:
            hidden = hidden[:, patches.shape[1]:]
        nll = chunked_xent(hidden[:, :-1], params.embed,
                           _labels(batch, device)[:, 1:], vocab=cfg.vocab)
        return nll + aux, {"nll": nll, "aux": aux}

    def init_cache(batch, max_seq, seq_shards=None):
        return transformer.init_cache(cfg, batch, max_seq, device,
                                      seq_shards)

    def decode(params, tokens, caches):
        return transformer.decode_step(params, tokens, caches)

    def prefill(params, batch):
        """Inference prefill: forward over the prompt (VLM: the patches,
        then the tokens) → last-token logits. (The caches of a prompt are
        built by decode steps, as the serving engine builds them.)"""
        hidden, _ = transformer.forward(params, batch["tokens"],
                                        patch_embeds=batch.get("patches"))
        return transformer.lm_logits(params, hidden[:, -1:])[:, 0]

    def input_specs(shape: ShapeSpec) -> dict:
        b, s = shape.global_batch, shape.seq_len
        if shape.kind == "decode":
            specs = {"tokens": ((b, 1), torch.int32)}
        elif shape.kind == "prefill":
            specs = {"tokens": ((b, s), torch.int32)}
        else:
            specs = {"tokens": ((b, s), torch.int32),
                     "labels": ((b, s), torch.int32)}
        if is_vlm and shape.kind != "decode":
            enc = cfg.encoder
            fdim = enc.frontend_dim or cfg.d_model
            specs["patches"] = ((b, enc.n_patches, fdim), torch.bfloat16)
        return specs

    return ModelBundle(cfg, device, init, loss, init_cache, decode, prefill,
                       input_specs)


def _build_encdec(cfg: ArchConfig, device: torch.device) -> ModelBundle:
    def init(seed: int = 0):
        return encdec.init_encdec(cfg, seed, device)

    def loss(params, batch):
        """Mean next-token NLL of the decoder over the encoded frames (the
        reference's enc-dec loss has no aux term and no remat)."""
        enc_out = encdec.encode(params, batch["frames"])
        hidden = encdec.decode_train(params, batch["tokens"], enc_out)
        nll = chunked_xent(hidden[:, :-1], params.embed,
                           _labels(batch, device)[:, 1:], vocab=cfg.vocab)
        return nll, {"nll": nll}

    def init_cache(batch, max_seq, params=None, enc_out=None,
                   seq_shards=None):
        if params is None:
            raise ValueError("enc-dec cache needs params (cross-attn K/V)")
        return encdec.init_decode_cache(
            params, batch, max_seq, enc_out,
            None if seq_shards is None else seq_shards(max_seq))

    def decode(params, tokens, caches):
        return encdec.decode_step(params, tokens, caches)

    def prefill(params, batch):
        """Audio prefill: encode the frames, run the decoder over the
        tokens → last-token logits."""
        enc_out = encdec.encode(params, batch["frames"])
        hidden = encdec.decode_train(params, batch["tokens"], enc_out)
        return encdec.logits(params, hidden[:, -1:])[:, 0]

    def input_specs(shape: ShapeSpec) -> dict:
        b, s = shape.global_batch, shape.seq_len
        enc = cfg.encoder
        if shape.kind == "decode":
            return {"tokens": ((b, 1), torch.int32)}
        specs = {
            "frames": ((b, enc.n_frames, cfg.d_model), torch.bfloat16),
            "tokens": ((b, min(s, cfg.max_position)), torch.int32),
        }
        if shape.kind == "train":
            specs["labels"] = ((b, min(s, cfg.max_position)), torch.int32)
        return specs

    return ModelBundle(cfg, device, init, loss, init_cache, decode, prefill,
                       input_specs)
