"""Text conditioning for the video DiT (counterpart of
``fluidnexus_tpu/diffusion/video/conditioner.py``).

Only the hash pseudo-encoder is ported: ``HashTextEncoder`` gives stable
pseudo-embeddings from token hashes, with no language model behind them. The
T5-XXL encoder waits until its weights ship with the repository.
``apply_ucg`` drops whole text embeddings for classifier-free guidance
training.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Optional

import numpy as np
import torch

from fluidnexus_torch import resolve_device


@dataclasses.dataclass
class HashTextEncoder:
    """Deterministic pseudo-T5: token -> seeded gaussian row. Stable across
    processes and equal to the JAX package's; NOT a language model."""

    max_length: int = 226
    hidden: int = 4096

    def __call__(self, texts, device="cuda"):
        out = np.zeros((len(texts), self.max_length, self.hidden), np.float32)
        for i, text in enumerate(texts):
            words = str(text).split()[: self.max_length]
            for j, w in enumerate(words):
                seed = int.from_bytes(hashlib.sha256(w.encode()).digest()[:4], "little")
                out[i, j] = np.random.default_rng(seed).normal(size=self.hidden, scale=0.02)
        return torch.as_tensor(out, device=resolve_device(device))


def make_text_encoder(model_dir: Optional[str] = None, max_length: int = 226,
                      hidden: int = 4096, allow_fake: bool = False):
    """The hash stand-in, with explicit opt-in (``allow_fake``, the CLIs'
    --allow_fake_conditioning / --tiny). A ``model_dir`` raises: the T5
    encoder is not ported yet."""
    if model_dir:
        raise NotImplementedError(
            f"T5 not ported yet: cannot load {model_dir!r}; pass --allow_fake_conditioning "
            "to run with hash pseudo-embeddings")
    if not allow_fake:
        raise RuntimeError(
            "no T5 weights configured, and the T5 encoder is not ported yet: pass "
            "--allow_fake_conditioning to accept hash pseudo-embeddings (test/smoke only: "
            "outputs will NOT follow the prompt)")
    return HashTextEncoder(max_length, hidden)


def _bernoulli(p, shape, generator, device):
    """True with probability ``p`` (the conditioner's only draw)."""
    return torch.rand(tuple(shape), generator=generator, device=device) < p


def apply_ucg(text_emb, rng: torch.Generator, ucg_rate: float = 0.1):
    """Zero whole-sample embeddings with probability ``ucg_rate``
    (GeneralConditioner's ucg)."""
    keep = _bernoulli(1.0 - ucg_rate, (text_emb.shape[0],), rng, text_emb.device)
    return text_emb * keep[:, None, None].to(text_emb.dtype)
