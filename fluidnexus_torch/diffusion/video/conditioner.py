"""Text conditioning for the video DiT (counterpart of
``fluidnexus_tpu/diffusion/video/conditioner.py``): FrozenT5Embedder
(t5-v1_1-xxl, 226 tokens) and its ucg.

Two encoders:
  - ``T5TextEncoder``: the port's own T5 encoder stack (``t5.T5Encoder``, f32)
    over the Hugging Face Flax directory the JAX package reads
    (``config.json`` and ``flax_model.msgpack`` or its sharded index, read by
    ``utils/flax_msgpack``), tokenized by transformers' ``AutoTokenizer``
    from the same directory, imported when an encoder is made;
  - ``HashTextEncoder``: stable pseudo-embeddings from token hashes, with no
    language model behind them (tests and smoke runs, by explicit opt-in).
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


class T5TextEncoder:
    """FrozenT5Embedder over a Hugging Face Flax T5 directory: prompts
    tokenized to ``max_length`` (truncated, padded to the length), encoded
    with their attention mask; returns ``last_hidden_state`` (B, max_length,
    d_model) f32. The encoder lives on ``device``; a call returns its output
    there, or on the call's ``device``."""

    def __init__(self, model_dir: str, max_length: int = 226, device="cuda"):
        from transformers import AutoTokenizer

        from fluidnexus_torch.convert import t5_encoder_from_numpy
        from fluidnexus_torch.diffusion.video.t5 import T5Config
        from fluidnexus_torch.utils.flax_msgpack import load_flax_checkpoint

        self.model_dir, self.max_length = model_dir, max_length
        self.device = resolve_device(device)
        self.tokenizer = AutoTokenizer.from_pretrained(model_dir)
        self.model = t5_encoder_from_numpy(load_flax_checkpoint(model_dir),
                                           T5Config.from_pretrained(model_dir), self.device)

    def __call__(self, texts, device=None):
        batch = self.tokenizer(list(texts), truncation=True, max_length=self.max_length,
                               padding="max_length", return_tensors="np")
        ids = torch.as_tensor(batch["input_ids"], device=self.device)
        mask = torch.as_tensor(batch["attention_mask"], device=self.device)
        with torch.no_grad():
            out = self.model(ids, mask)
        return out if device is None else out.to(resolve_device(device))


def make_text_encoder(model_dir: Optional[str] = None, max_length: int = 226,
                      hidden: int = 4096, allow_fake: bool = False, device="cuda"):
    """The T5 encoder of ``model_dir`` on ``device``, or, with explicit
    opt-in (``allow_fake``, the CLIs' --allow_fake_conditioning / --tiny),
    the hash stand-in: where ``model_dir`` does not load it prints why and
    falls back; with no ``model_dir`` it is the stand-in. Without the
    opt-in either case raises RuntimeError naming the flag."""
    if model_dir:
        try:
            return T5TextEncoder(model_dir, max_length, device)
        except Exception as e:  # missing weights / tokenizer
            if not allow_fake:
                raise RuntimeError(
                    f"T5 weights at {model_dir!r} are unusable ({e}). Point --t5_dir at a "
                    "Hugging Face Flax t5-v1_1-xxl directory, or pass "
                    "--allow_fake_conditioning to run with hash pseudo-embeddings (test/smoke "
                    "only: outputs will NOT follow the prompt)") from e
            print(f"[conditioner] T5 unavailable ({e}); using hash fallback")
    elif not allow_fake:
        raise RuntimeError(
            "no T5 weights configured: pass --t5_dir <Hugging Face Flax t5-v1_1-xxl dir>, or "
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
