"""Whisper-style encoder-decoder (audio backbone; the conv frontend is a
stub).

Encoder: precomputed frame embeddings ``audio_embed`` (B, S, d) plus
sinusoidal positions, through ``n_enc_layers`` bidirectional blocks,
then ``enc_norm``.  Decoder: token embeddings plus learned positions
(``pos_embed``, float32 (max_positions, d)), through ``n_layers``
blocks of causal self-attention and cross attention over the encoder
output, then ``final_norm`` and the tied unembedding.

Parameters keep the reference's layout (``embed_p``, ``pos_embed``,
``enc_units`` and ``dec_units`` stacked on a leading unit dim with one
block ``b0`` each, ``enc_norm``, ``final_norm``), so ``params_from_jax``
carries the reference's weights over unchanged; a prefill cache is
``{"units": {"b0": {"attn": ..., "xattn": ...}}}`` stacked the same
way.  The reference's encoder and decoder scans have no remat, and
neither has this module.  DTensor parameters are gathered as in
``models.lm``: each unit's where the stack takes it, the rest where an
entry point starts; the encoder's, decoder's and cross attention, the
MLPs, the embedding and the head divide their products over "model"
as there.  Prefill attention goes through the
flash-attention kernel (bidirectional, causal and cross), training
through the blockwise attention by autograd.  In the reference's flash
mode (``REPRO_ATTN_IMPL=flash``) the encoder's and the decoder's
streams are each rank's rows of their sequence where "model" divides
it (``models.lm.seq_stream``: the blocks' ``seq``; the cross sub-block
attends to the whole encoder output), gathered whole before their
final norms (ROADMAP D15c-2b).
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ATTN, ENC_ATTN, ModelConfig
from repro_torch.core.xla_math import exp32, log32
from repro_torch.models import blocks as B
from repro_torch.models.common import (
    act_dtype,
    apply_norm,
    cross_entropy,
    embed_apply,
    embed_init,
    logits_apply,
    norm_init,
)
from repro_torch.distributed.sharding import constrain
from repro_torch.distributed import tensor_parallel as TP
from repro_torch.models.lm import (_index, _stack, outer_params, seq_stream,
                                   unit_params)

#: The stacked entries of the parameter tree.
_STACKED = ("enc_units", "dec_units")


def sinusoids(length: int, channels: int, device=None) -> torch.Tensor:
    """Whisper's sinusoidal position embedding, (length, channels)
    float32.  The timescales take XLA's float32 ``log`` and ``exp``
    (``core.xla_math``), so they equal the reference's bit for bit: a
    one-ulp timescale moves ``sin`` at position 1500 by ~1e-4."""
    log_timescale = log32(torch.tensor(10000.0, device=device)) / (
        channels // 2 - 1)
    inv = exp32(-log_timescale * torch.arange(
        channels // 2, dtype=torch.float32, device=device))
    t = torch.arange(length, dtype=torch.float32, device=device)[:, None] \
        * inv[None, :]
    return torch.cat([torch.sin(t), torch.cos(t)], dim=1)


def encdec_init(cfg: ModelConfig, generator: torch.Generator) -> dict:
    """Seeded float32 parameters on the generator's device."""
    dev = generator.device
    pos = torch.empty((cfg.max_positions, cfg.d_model), dtype=torch.float32,
                      device=dev).normal_(0.0, 0.01, generator=generator)
    return {
        "embed_p": embed_init(generator, cfg),
        "pos_embed": pos,
        "enc_units": _stack([{"b0": B.block_init(generator, cfg, ENC_ATTN,
                                                 False)}
                             for _ in range(cfg.n_enc_layers)]),
        "enc_norm": norm_init(cfg, cfg.d_model, dev),
        "dec_units": _stack([{"b0": B.block_init(generator, cfg, ATTN, False,
                                                 cross=True)}
                             for _ in range(cfg.unit_count())]),
        "final_norm": norm_init(cfg, cfg.d_model, dev),
    }


def _arange(n: int, device) -> torch.Tensor:
    return torch.arange(n, dtype=torch.int32, device=device)


def encode(cfg: ModelConfig, params, audio_embed, train: bool = False):
    """audio_embed (B, S, d) stub-frontend output -> (B, S, d) in the
    activation dtype; ``train`` takes the blockwise attention."""
    S = audio_embed.shape[1]
    x = audio_embed.to(act_dtype(cfg))
    x = x + sinusoids(S, cfg.d_model, x.device).to(x.dtype)[None]
    x = constrain(x, ("batch", None, None))
    positions = _arange(S, x.device)
    seq = seq_stream(cfg, S)
    if seq:
        x = TP.scatter_seq(x)
    for u in range(cfg.n_enc_layers):
        p = unit_params(cfg, params["enc_units"], u)["b0"]
        if train:
            x, _ = B.block_train(cfg, ENC_ATTN, p, x, positions, seq=seq)
        else:
            x, _ = B.block_fullseq(cfg, ENC_ATTN, p, x, positions, seq=seq)
    if seq:
        x = TP.gather_from_model(x, 1)
    return apply_norm(cfg, params["enc_norm"], x)


def _decoder_fullseq(cfg: ModelConfig, params, tokens, enc_out,
                     train: bool = False):
    """-> (x after ``final_norm``, the stacked prefill cache, or None in
    training)."""
    T = tokens.shape[1]
    positions = _arange(T, tokens.device)
    x = embed_apply(cfg, params["embed_p"], tokens)
    x = x + params["pos_embed"][:T].to(x.dtype)[None]
    x = constrain(x, ("batch", None, None))
    enc_positions = _arange(enc_out.shape[1], enc_out.device)
    seq = seq_stream(cfg, T)
    if seq:
        x = TP.scatter_seq(x)
    caches = []
    for u in range(cfg.unit_count()):
        p = unit_params(cfg, params["dec_units"], u)["b0"]
        if train:
            x, _ = B.block_train(cfg, ATTN, p, x, positions, enc_out,
                                 enc_positions, seq=seq)
        else:
            x, c = B.block_fullseq(cfg, ATTN, p, x, positions, enc_out,
                                   enc_positions, seq=seq)
            caches.append({"b0": c})
    if seq:
        x = TP.gather_from_model(x, 1)
    x = apply_norm(cfg, params["final_norm"], x)
    return x, (None if train else _stack(caches))


def train_loss(cfg: ModelConfig, params, batch):
    """batch {"audio_embed": (B, S, d), "tokens", "labels": (B, T) int}
    -> scalar float32 mean next-token cross-entropy, differentiable in
    ``params``."""
    params = outer_params(cfg, params, _STACKED)
    enc_out = encode(cfg, params, batch["audio_embed"], train=True)
    x, _ = _decoder_fullseq(cfg, params, batch["tokens"], enc_out, train=True)
    logits = logits_apply(cfg, params["embed_p"], x)
    return cross_entropy(logits[:, :-1], batch["labels"][:, 1:],
                         vocab=cfg.vocab)


def prefill(cfg: ModelConfig, params, batch):
    """batch {"tokens": (B, T) int, "audio_embed": (B, S, d)} -> (the
    last position's float32 logits (B, 1, V), cache)."""
    params = outer_params(cfg, params, _STACKED)
    enc_out = encode(cfg, params, batch["audio_embed"])
    x, caches = _decoder_fullseq(cfg, params, batch["tokens"], enc_out)
    return logits_apply(cfg, params["embed_p"], x[:, -1:]), {"units": caches}


def decode_step(cfg: ModelConfig, params, batch):
    """batch {"token": (B, 1), "pos": int, "cache": nested dict}.  The
    learned position is row ``pos`` clamped to the table, as the
    reference's ``dynamic_slice_in_dim`` reads it."""
    pos = int(batch["pos"])
    params = outer_params(cfg, params, _STACKED)
    x = embed_apply(cfg, params["embed_p"], batch["token"])
    row = min(max(pos, 0), params["pos_embed"].shape[0] - 1)
    x = x + params["pos_embed"][row].to(x.dtype)
    caches = []
    for u in range(cfg.unit_count()):
        p = unit_params(cfg, params["dec_units"], u)["b0"]
        c = _index(batch["cache"]["units"], u)["b0"]
        x, c = B.block_decode(cfg, ATTN, p, x, c, pos)
        caches.append({"b0": c})
    x = apply_norm(cfg, params["final_norm"], x)
    return logits_apply(cfg, params["embed_p"], x), {"units": _stack(caches)}
