"""Whisper-style encoder-decoder (the audio family), the JAX package's
``models/encdec.py``.

The conv1d x 2 mel frontend is a stub in both packages: the model takes
precomputed frame embeddings (B, S_frames, d_model).  The backbone is
exact: bidirectional encoder layers with sinusoidal positions, then
causal decoder layers with learned positions, self-attention,
cross-attention to the encoder's output and a gelu MLP; the head is the
embedding, transposed (there is no ``lm_head``).

The encoder's self-attention goes through the flash wrapper when it
serves (``prefill``: the kernel for CUDA tensors), and through
``chunked_attention`` under ``loss_fn``, as the port splits the decoder
LM's attention; the JAX package runs its encoder in train mode in both.
Cross-attention is plain PyTorch in every mode, and a prefill's cache is
a pair: the decoder's self-attention caches, updated in place, and the
cross (k, v) of every decoder layer, computed once per request.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from .. import resolve_device
from ..configs.base import ArchConfig
from ..sharding.partition import constrain, replicated_like
from .attention import Attention, attn_axes
from .layers import MLP, RMSNorm, mlp_axes, normal_, rms_norm, \
    softmax_xent, stacked_axes, trunc_normal_

N_DEC_POS = 4096          # learned decoder positions, taken modulo this


def sinusoid_pos(S: int, d: int) -> np.ndarray:
    """(S, d) float32: sines then cosines, computed in float64 as the JAX
    package's numpy function computes them (``d // 2 - 1`` divisor
    included)."""
    pos = np.arange(S)[:, None]
    dim = np.arange(d // 2)[None, :]
    ang = pos / (10000 ** (dim / (d // 2 - 1)))
    return np.concatenate([np.sin(ang), np.cos(ang)], axis=-1
                          ).astype(np.float32)


class EncBlock(nn.Module):
    """Pre-norm bidirectional attention, then the MLP."""

    def __init__(self, cfg: ArchConfig, dtype, device=None):
        super().__init__()
        d = cfg.d_model
        self.ln1 = RMSNorm(d, cfg.norm_eps, device)
        self.attn = Attention(d, cfg.n_heads, cfg.n_kv_heads, cfg.hd, dtype,
                              device)
        self.ln2 = RMSNorm(d, cfg.norm_eps, device)
        self.mlp = MLP(d, cfg.d_ff, cfg.mlp, dtype, device)

    def init(self, generator: torch.Generator) -> None:
        self.attn.init(generator)
        self.mlp.init(generator)

    def forward(self, x, cfg: ArchConfig, mode: str):
        o, _ = self.attn(self.ln1(x), cfg=cfg, mode=mode, causal=False)
        x = x + o
        return x + self.mlp(self.ln2(x))


class DecBlock(nn.Module):
    """Pre-norm causal self-attention (``self``), cross-attention
    (``cross``, its norm ``lnx``), then the MLP: the JAX names."""

    def __init__(self, cfg: ArchConfig, dtype, device=None):
        super().__init__()
        d = cfg.d_model
        attn = lambda: Attention(d, cfg.n_heads, cfg.n_kv_heads,  # noqa: E731
                                 cfg.hd, dtype, device)
        self.ln1 = RMSNorm(d, cfg.norm_eps, device)
        self.self = attn()
        self.lnx = RMSNorm(d, cfg.norm_eps, device)
        self.cross = attn()
        self.ln2 = RMSNorm(d, cfg.norm_eps, device)
        self.mlp = MLP(d, cfg.d_ff, cfg.mlp, dtype, device)

    def init(self, generator: torch.Generator) -> None:
        self.self.init(generator)
        self.cross.init(generator)
        self.mlp.init(generator)

    def forward(self, x, cfg: ArchConfig, mode: str, cache: Optional[Dict],
                pos, ck, cv):
        o, cache = self.self(self.ln1(x), cfg=cfg, mode=mode, cache=cache,
                             pos=pos)
        x = x + o
        o, _ = self.cross(self.lnx(x), cfg=cfg, mode=mode,
                          kv_override=(ck, cv))
        x = x + o
        return x + self.mlp(self.ln2(x)), cache


class EncDecLM(nn.Module):
    def __init__(self, cfg: ArchConfig, device="cuda"):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        self.pdtype = getattr(torch, cfg.param_dtype)
        self.cdtype = getattr(torch, cfg.dtype)
        d = cfg.d_model
        self.enc_blocks = nn.ModuleList(
            EncBlock(cfg, self.pdtype, dev)
            for _ in range(cfg.encoder_layers))
        self.dec_blocks = nn.ModuleList(
            DecBlock(cfg, self.pdtype, dev) for _ in range(cfg.n_layers))
        self.embed = nn.Parameter(torch.empty(cfg.vocab, d,
                                              dtype=self.pdtype, device=dev))
        self.dec_pos = nn.Parameter(torch.empty(N_DEC_POS, d,
                                                dtype=self.pdtype,
                                                device=dev))
        self.enc_norm = RMSNorm(d, cfg.norm_eps, dev)
        self.final_norm = RMSNorm(d, cfg.norm_eps, dev)

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def init(self, generator: torch.Generator) -> "EncDecLM":
        """Random weights from ``generator``, drawn on its device."""
        for blk in (*self.enc_blocks, *self.dec_blocks):
            blk.init(generator)
        trunc_normal_(self.embed, 1.0, generator)
        normal_(self.dec_pos, 0.01, generator)
        return self

    def param_axes(self) -> Dict:
        """Logical axes of the JAX pytree of this model's parameters
        (``enc_blocks`` and ``dec_blocks`` stacked over their layers)."""
        a, m = attn_axes(), mlp_axes(self.cfg.mlp)
        return {
            "enc_blocks": stacked_axes({"ln1": (None,), "attn": a,
                                        "ln2": (None,), "mlp": m}),
            "dec_blocks": stacked_axes({"ln1": (None,), "self": a,
                                        "lnx": (None,), "cross": a,
                                        "ln2": (None,), "mlp": m}),
            "embed": ("vocab", "fsdp"), "dec_pos": (None, "fsdp"),
            "enc_norm": (None,), "final_norm": (None,)}

    def cache_axes(self) -> Dict:
        """Logical axes of the JAX package's self-attention caches,
        stacked over the decoder layers."""
        return {"k": (None, "batch", "kv_seq", "kv_heads", None),
                "v": (None, "batch", "kv_seq", "kv_heads", None),
                "len": (None,)}

    def _remat(self, mode: str) -> bool:
        return self.cfg.remat and mode == "train" and torch.is_grad_enabled()

    # -- encoder --------------------------------------------------------------
    def encode(self, frames, mode: str = "train"):
        """frames: (B, S, d) precomputed embeddings (frontend stub).  mode
        'prefill' sends self-attention to the flash wrapper, 'train' to
        ``chunked_attention``."""
        cfg = self.cfg
        x = frames.to(self.cdtype)
        S = x.shape[1]
        x = x + replicated_like(torch.from_numpy(
            sinusoid_pos(S, cfg.d_model)).to(x.device, self.cdtype)[None], x)
        x = constrain(x, ("batch", "seq", None))
        remat = self._remat(mode)
        for blk in self.enc_blocks:
            if remat:
                x = checkpoint(blk, x, cfg, mode, use_reentrant=False)
            else:
                x = blk(x, cfg, mode)
        return rms_norm(x, self.enc_norm.weight, cfg.norm_eps)

    def cross_kv(self, enc_out) -> List[Tuple[torch.Tensor, torch.Tensor]]:
        """(k, v) of every decoder layer's cross-attention, (B, T, KV, hd)
        each, in the encoder output's dtype."""
        cfg = self.cfg
        B, T, d = enc_out.shape
        shape = (B, T, cfg.n_kv_heads, cfg.hd)
        return [tuple((enc_out @ w.reshape(d, -1).to(enc_out.dtype))
                      .view(shape)
                      for w in (blk.cross.wk, blk.cross.wv))
                for blk in self.dec_blocks]

    # -- decoder --------------------------------------------------------------
    def _decoder(self, tokens, mode: str, cross, caches=None,
                 positions=None):
        cfg = self.cfg
        S = tokens.shape[1]
        x = F.embedding(tokens, self.embed).to(self.cdtype)
        if positions is None:
            positions = replicated_like(
                torch.arange(S, device=x.device)[None, :], x)
        # (1|B, S, d) learned positions broadcast over the batch
        x = x + F.embedding(positions.long() % N_DEC_POS,
                            self.dec_pos).to(self.cdtype)
        x = constrain(x, ("batch", "seq", None))
        remat = self._remat(mode)
        for i, blk in enumerate(self.dec_blocks):
            ck, cv = cross[i]
            if remat:
                x, _ = checkpoint(blk, x, cfg, mode, None, positions, ck, cv,
                                  use_reentrant=False)
            else:
                x, _ = blk(x, cfg, mode,
                           caches[i] if caches is not None else None,
                           positions, ck, cv)
        x = rms_norm(x, self.final_norm.weight, cfg.norm_eps)
        logits = x @ self.embed.T.to(x.dtype)
        return constrain(logits, ("batch", "seq", "vocab")), caches

    # -- public API -----------------------------------------------------------
    def loss_fn(self, batch):
        """Train forward: batch {frames (B,S,d), tokens (B,S), labels
        (B,S)}.  Returns (loss, {"loss", "total_loss"}): the mean token
        cross entropy with z-loss 1e-4 (no loss mask, as in JAX)."""
        if "frames" not in batch:
            raise ValueError(f"{self.cfg.name}: a train batch needs "
                             f"'frames' (B, S, {self.cfg.d_model})")
        enc_out = self.encode(batch["frames"], "train")
        logits, _ = self._decoder(batch["tokens"], "train",
                                  self.cross_kv(enc_out))
        loss = softmax_xent(logits, batch["labels"]).mean()
        return loss, {"loss": loss, "total_loss": loss}

    def forward(self, batch):
        """``loss_fn``, for ``torch.func.functional_call``."""
        return self.loss_fn(batch)

    def init_cache(self, B: int, cache_len: int) -> List[Dict]:
        """Zero self-attention caches, one {"k", "v", "len"} per decoder
        layer, updated in place by prefill and decode."""
        cfg = self.cfg
        shape = (B, cache_len, cfg.n_kv_heads, cfg.hd)
        kw = dict(dtype=self.cdtype, device=self.device)
        return [{"k": torch.zeros(shape, **kw), "v": torch.zeros(shape, **kw),
                 "len": 0} for _ in range(cfg.n_layers)]

    @torch.inference_mode()
    def prefill(self, batch, cache_len: int):
        """Encode {frames (B,S,d)} and run the decoder prompt {tokens (B,
        S')} (a BOS): returns (last_logits (B,1,V), (caches, cross))."""
        if "frames" not in batch:
            raise ValueError(f"{self.cfg.name}: prefill needs 'frames'")
        cross = self.cross_kv(self.encode(batch["frames"], "prefill"))
        tokens = batch["tokens"]
        caches = self.init_cache(tokens.shape[0], cache_len)
        logits, caches = self._decoder(tokens, "prefill", cross, caches)
        return logits[:, -1:], (caches, cross)

    @torch.inference_mode()
    def decode_step(self, tokens, caches, positions):
        """One token for every sequence.  tokens, positions (B, 1); caches
        the (self-attention caches, cross) pair of ``prefill``."""
        self_caches, cross = caches
        logits, self_caches = self._decoder(tokens, "decode", cross,
                                            self_caches, positions)
        return logits, (self_caches, cross)
