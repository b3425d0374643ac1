"""Serving launcher: batched greedy decode with a decode cache (a KV cache for
the dense, moe and vlm families, the SSM state and conv buffer for the ssm
family, both for the hybrid).

Prefill a prompt batch, then decode greedily for N steps.  A vlm's prompt
(paligemma-3b) is its seeded patch embeddings (the stubbed vision tower's
output) followed by text tokens; its positions count the patches.  The
encoder-only hubert-xlarge has no decode step, so ``serve`` refuses it: its
path is ``repro_torch.models.forward`` on a batch of ``frames``.  Runs on the
card unless ``--device cpu`` is given; with no card it raises rather than
fall back.

  PYTHONPATH=src python -m repro_torch.launch.serve --tokens 16
  PYTHONPATH=src python -m repro_torch.launch.serve --full --batch 8
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-1.3b --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-1.3b --full --batch 8
  PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-2.7b --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-2.7b --full --batch 8
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-moe-a2.7b --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-moe-a2.7b --full --batch 8
  PYTHONPATH=src python -m repro_torch.launch.serve --arch mixtral-8x22b --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch paligemma-3b --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch paligemma-3b --full --batch 8

``--arch`` takes every registered architecture; at full width qwen2-72b and
deepseek-67b (about 140 GB of bf16 weights) and mixtral-8x22b (281 GB) do not
fit one 80 GB card.
"""

from __future__ import annotations

import argparse
import time
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.configs import ARCHS, InputShape, get_config, get_smoke, skip_reason
from repro_torch.devices import resolve_device
from repro_torch.models import init_params, prefill
from repro_torch.models.config import ModelConfig
from repro_torch.train.coded import make_serve_step


@dataclass(frozen=True)
class ServeResult:
    tokens: np.ndarray   # (batch, tokens) int32 greedy tokens
    prefill_s: float     # prompt prefill, host clock to a device sync
    total_s: float       # prefill + every decode step

    @property
    def tokens_per_s(self) -> float:
        return self.tokens.size / self.total_s

    @property
    def decode_tokens_per_s(self) -> float:
        """Tokens of the decode steps alone (the prefill's first token excluded)."""
        b, n = self.tokens.shape
        return b * (n - 1) / (self.total_s - self.prefill_s)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def request(cfg: ModelConfig, *, batch: int, prompt_len: int, seed: int = 0,
            device="cuda") -> dict:
    """The seeded random prompt batch of ``serve``: ``prompt_len`` positions.

    For a vlm (``vision_stub``) these are its P patch embeddings,
    ``prefix_embeds`` (batch, P, d) drawn as standard normals, then
    prompt_len - P text tokens; the tokens are drawn first.  A prompt of no
    more than P positions raises, as ``skip_reason`` skips such a shape.
    """
    dev = resolve_device(device)
    P = cfg.prefix_len
    if P and prompt_len <= P:
        shape = InputShape("prompt", prompt_len, batch, "prefill")
        raise ValueError(f"{cfg.name}: prompt_len {prompt_len} counts the {P} prefix "
                         f"positions: {skip_reason(cfg, shape)}")
    rng = np.random.default_rng(seed)
    out = {"tokens": torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (batch, prompt_len - P)).astype(np.int32)).to(dev)}
    if P:
        out["prefix_embeds"] = torch.from_numpy(
            rng.standard_normal((batch, P, cfg.d_model)).astype(np.float32)).to(dev)
    return out


def serve(cfg: ModelConfig, params, *, batch: int = 4, prompt_len: int = 8,
          tokens: int = 16, max_seq: int = 64, seed: int = 0,
          device="cuda") -> ServeResult:
    """Prefill a seeded random prompt batch (:func:`request`) and decode
    ``tokens`` greedy tokens; decoding starts at position ``prompt_len``."""
    dev = resolve_device(device)
    if not cfg.has_decode:
        raise ValueError(f"{cfg.name} is encoder-only: no decode step")
    if prompt_len + tokens - 1 > max_seq:
        raise ValueError(f"prompt {prompt_len} + {tokens} tokens exceed max_seq {max_seq}")
    prompt = request(cfg, batch=batch, prompt_len=prompt_len, seed=seed, device=dev)
    step = make_serve_step(cfg)
    with torch.inference_mode():
        _sync(dev)
        t0 = time.perf_counter()
        logits, cache = prefill(params, cfg, prompt, max_seq=max_seq)
        token = logits[:, -1].argmax(dim=-1)[:, None].to(torch.int32)
        _sync(dev)
        t_pre = time.perf_counter() - t0
        out = [token]
        for i in range(tokens - 1):
            logits, cache = step(params, cache, token, prompt_len + i)
            token = logits.argmax(dim=-1)[:, None].to(torch.int32)
            out.append(token)
        seqs = torch.cat(out, dim=1).cpu().numpy()  # waits for the device
        total = time.perf_counter() - t0
    return ServeResult(seqs, t_pre, total)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-0.5b", choices=ARCHS)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--tokens", type=int, default=16)
    ap.add_argument("--max-seq", type=int, default=0,
                    help="cache positions (0: the prompt's and the new tokens')")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--full", action="store_true",
                    help="the full-width config instead of the smoke one")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args()

    cfg = get_config(args.arch) if args.full else get_smoke(args.arch)
    dev = resolve_device(args.device)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(args.seed))
    # 8 text tokens, after a vlm's patch positions
    prompt_len = 8 + cfg.prefix_len
    res = serve(cfg, params, batch=args.batch, prompt_len=prompt_len, tokens=args.tokens,
                max_seq=args.max_seq or prompt_len + args.tokens, seed=args.seed, device=dev)
    print(f"prefill {prompt_len} positions in {res.prefill_s:.2f}s; decoded "
          f"{args.tokens} x {args.batch} seqs in {res.total_s:.2f}s "
          f"({res.tokens_per_s:.1f} tok/s) on {dev}")
    print("sequences:\n", res.tokens)


if __name__ == "__main__":
    main()
