"""The T5 encoder stack as a torch module: the math of transformers'
``FlaxT5EncoderModel``, which the JAX package's ``T5TextEncoder`` runs
(FrozenT5Embedder, t5-v1_1-xxl), in f32 as it runs there.

- ``shared``: the token embedding;
- per block, a self-attention layer and a feed-forward layer, each
  ``h + f(layer_norm(h))``: the layer norm is T5's (RMS, no mean, no bias,
  the variance in f32); the attention has no 1/sqrt(d) scaling and a
  softmax in f32; block 0 alone holds the relative position bias, which
  every block reuses with the padding mask added as ``finfo.min`` where
  the mask is 0; the feed-forward is ``wo(act(wi(x)))``, or, gated,
  ``wo(act(wi_0(x)) * wi_1(x))`` (``gated-gelu``: the tanh gelu);
- ``final_layer_norm``.

Module and parameter names are the flax tree's (``encoder.block.{i}.layer.
0.SelfAttention.q``, ``...relative_attention_bias.embedding``, ...; a Dense
``kernel`` (in, out) is a ``weight`` (out, in) here), so
``fluidnexus_torch.convert.t5_encoder_from_numpy`` maps one onto the other.
Dropout is left out: the encoder only runs deterministic.
"""
from __future__ import annotations

import dataclasses
import json
import os

import torch
import torch.nn.functional as F
from torch import nn

_ACT = {
    "relu": F.relu,
    "gelu": lambda x: F.gelu(x, approximate="none"),
    "gelu_new": lambda x: F.gelu(x, approximate="tanh"),
}


@dataclasses.dataclass(frozen=True)
class T5Config:
    """The fields of a transformers ``config.json`` the encoder reads; the
    defaults are t5-v1_1-xxl's."""

    vocab_size: int = 32128
    d_model: int = 4096
    d_kv: int = 64
    d_ff: int = 10240
    num_layers: int = 24
    num_heads: int = 64
    relative_attention_num_buckets: int = 32
    relative_attention_max_distance: int = 128
    layer_norm_epsilon: float = 1e-6
    feed_forward_proj: str = "gated-gelu"
    dense_act_fn: str = ""        # "" = from feed_forward_proj, as transformers derives it
    is_gated_act: bool = None     # None = from feed_forward_proj

    def __post_init__(self):
        parts = self.feed_forward_proj.split("-")
        if len(parts) > 2 or (len(parts) == 2 and parts[0] != "gated"):
            raise ValueError(f"feed_forward_proj {self.feed_forward_proj!r} is not "
                             "'<act>' or 'gated-<act>'")
        if not self.dense_act_fn:
            act = "gelu_new" if self.feed_forward_proj == "gated-gelu" else parts[-1]
            object.__setattr__(self, "dense_act_fn", act)
        if self.is_gated_act is None:
            object.__setattr__(self, "is_gated_act", parts[0] == "gated")
        if self.dense_act_fn not in _ACT:
            raise ValueError(f"activation {self.dense_act_fn!r} is not one of {sorted(_ACT)}")

    @classmethod
    def from_pretrained(cls, model_dir: str) -> "T5Config":
        """The config of a Hugging Face T5 directory (``config.json``); keys
        the encoder does not read are ignored."""
        with open(os.path.join(model_dir, "config.json")) as f:
            raw = json.load(f)
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in raw.items() if k in names})


def relative_position_bucket(relative_position: torch.Tensor, num_buckets: int = 32,
                             max_distance: int = 128) -> torch.Tensor:
    """The bidirectional bucket of each (key - query) offset: half the
    buckets for each sign; in each half, exact buckets below ``num_buckets //
    4``, then log-spaced ones up to ``max_distance``, beyond which all share
    the last. In f32, in transformers' Flax order of operations."""
    half = num_buckets // 2
    buckets = (relative_position > 0).to(torch.int32) * half
    pos = relative_position.abs()
    max_exact = half // 2
    large = max_exact + (torch.log(pos.to(torch.float32) / max_exact)
                         / torch.log(torch.tensor(max_distance / max_exact, dtype=torch.float32,
                                                  device=pos.device))
                         * (half - max_exact))
    large = torch.clamp(large, max=half - 1)
    return (buckets + torch.where(pos < max_exact, pos.to(torch.float32), large)).to(torch.int32)


class Embed(nn.Module):
    """flax ``nn.Embed``: one ``embedding`` (num, features) table."""

    def __init__(self, num: int, features: int):
        super().__init__()
        self.embedding = nn.Parameter(torch.empty(num, features))

    def forward(self, ids):
        return F.embedding(ids, self.embedding)


class T5LayerNorm(nn.Module):
    def __init__(self, d: int, eps: float):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(d))
        self.eps = eps

    def forward(self, x):
        variance = x.to(torch.float32).pow(2).mean(-1, keepdim=True)
        return self.weight * (x / torch.sqrt(variance + self.eps))


class T5Attention(nn.Module):
    def __init__(self, cfg: T5Config, has_relative_attention_bias: bool):
        super().__init__()
        inner = cfg.num_heads * cfg.d_kv
        self.cfg = cfg
        self.q = nn.Linear(cfg.d_model, inner, bias=False)
        self.k = nn.Linear(cfg.d_model, inner, bias=False)
        self.v = nn.Linear(cfg.d_model, inner, bias=False)
        self.o = nn.Linear(inner, cfg.d_model, bias=False)
        if has_relative_attention_bias:
            self.relative_attention_bias = Embed(cfg.relative_attention_num_buckets, cfg.num_heads)

    def compute_bias(self, length: int, device) -> torch.Tensor:
        """(1, heads, L, L) learned bias of each (query, key) offset."""
        pos = torch.arange(length, dtype=torch.int32, device=device)
        rel = pos[None, :] - pos[:, None]
        buckets = relative_position_bucket(rel, self.cfg.relative_attention_num_buckets,
                                           self.cfg.relative_attention_max_distance)
        return self.relative_attention_bias(buckets).permute(2, 0, 1)[None]

    def forward(self, x, position_bias):
        b, n, _ = x.shape
        h, d = self.cfg.num_heads, self.cfg.d_kv
        q = self.q(x).view(b, n, h, d)
        k = self.k(x).view(b, n, h, d)
        v = self.v(x).view(b, n, h, d)
        scores = torch.einsum("bqhd,bkhd->bhqk", q, k) + position_bias
        weights = torch.softmax(scores, dim=-1)
        out = torch.einsum("bhqk,bkhd->bqhd", weights, v).reshape(b, n, h * d)
        return self.o(out)


class T5LayerSelfAttention(nn.Module):
    def __init__(self, cfg: T5Config, has_relative_attention_bias: bool):
        super().__init__()
        self.SelfAttention = T5Attention(cfg, has_relative_attention_bias)
        self.layer_norm = T5LayerNorm(cfg.d_model, cfg.layer_norm_epsilon)

    def forward(self, x, position_bias):
        return x + self.SelfAttention(self.layer_norm(x), position_bias)


class T5DenseActDense(nn.Module):
    def __init__(self, cfg: T5Config):
        super().__init__()
        if cfg.is_gated_act:
            self.wi_0 = nn.Linear(cfg.d_model, cfg.d_ff, bias=False)
            self.wi_1 = nn.Linear(cfg.d_model, cfg.d_ff, bias=False)
        else:
            self.wi = nn.Linear(cfg.d_model, cfg.d_ff, bias=False)
        self.wo = nn.Linear(cfg.d_ff, cfg.d_model, bias=False)
        self.act = _ACT[cfg.dense_act_fn]
        self.gated = cfg.is_gated_act

    def forward(self, x):
        if self.gated:
            return self.wo(self.act(self.wi_0(x)) * self.wi_1(x))
        return self.wo(self.act(self.wi(x)))


class T5LayerFF(nn.Module):
    def __init__(self, cfg: T5Config):
        super().__init__()
        self.DenseReluDense = T5DenseActDense(cfg)
        self.layer_norm = T5LayerNorm(cfg.d_model, cfg.layer_norm_epsilon)

    def forward(self, x):
        return x + self.DenseReluDense(self.layer_norm(x))


class T5Block(nn.Module):
    def __init__(self, cfg: T5Config, has_relative_attention_bias: bool):
        super().__init__()
        self.layer = nn.ModuleList([T5LayerSelfAttention(cfg, has_relative_attention_bias),
                                    T5LayerFF(cfg)])

    def forward(self, x, position_bias):
        return self.layer[1](self.layer[0](x, position_bias))


class T5Stack(nn.Module):
    def __init__(self, cfg: T5Config):
        super().__init__()
        self.block = nn.ModuleList([T5Block(cfg, i == 0) for i in range(cfg.num_layers)])
        self.final_layer_norm = T5LayerNorm(cfg.d_model, cfg.layer_norm_epsilon)


class T5Encoder(nn.Module):
    """``FlaxT5EncoderModel``'s forward: (B, L) token ids and their 0/1
    attention mask -> ``last_hidden_state`` (B, L, d_model)."""

    def __init__(self, cfg: T5Config):
        super().__init__()
        self.cfg = cfg
        self.shared = Embed(cfg.vocab_size, cfg.d_model)
        self.encoder = T5Stack(cfg)

    def forward(self, input_ids: torch.Tensor, attention_mask: torch.Tensor) -> torch.Tensor:
        x = self.shared(input_ids)
        attn = self.encoder.block[0].layer[0].SelfAttention
        mask = torch.where(attention_mask[:, None, None, :] > 0, 0.0,
                           torch.finfo(torch.float32).min).to(torch.float32)
        position_bias = attn.compute_bias(input_ids.shape[1], x.device) + mask
        for block in self.encoder.block:
            x = block(x, position_bias)
        return self.encoder.final_layer_norm(x)

