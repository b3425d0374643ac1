"""Serving launcher: batched greedy decode with a decode cache (a KV cache for
the dense and moe families, the SSM state and conv buffer for the ssm family,
both for the hybrid).

Prefill a prompt batch, then decode greedily for N steps.  Runs on the card
unless ``--device cpu`` is given; with no card it raises rather than fall
back.

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

from repro_torch.configs import ARCHS, get_config, get_smoke
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


def serve(cfg: ModelConfig, params, *, batch: int = 4, prompt_len: int = 8,
          tokens: int = 16, max_seq: int = 64, seed: int = 0,
          device="cuda") -> ServeResult:
    """Prefill a seeded random prompt batch and decode ``tokens`` greedy tokens."""
    dev = resolve_device(device)
    if not cfg.has_decode:
        raise ValueError(f"{cfg.name} is encoder-only: no decode step")
    if prompt_len + tokens - 1 > max_seq:
        raise ValueError(f"prompt {prompt_len} + {tokens} tokens exceed max_seq {max_seq}")
    rng = np.random.default_rng(seed)
    prompt = torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (batch, prompt_len)).astype(np.int32)
    ).to(dev)
    step = make_serve_step(cfg)
    with torch.inference_mode():
        _sync(dev)
        t0 = time.perf_counter()
        logits, cache = prefill(params, cfg, {"tokens": prompt}, max_seq=max_seq)
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
    ap.add_argument("--max-seq", type=int, default=64)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--full", action="store_true",
                    help="the full-width config instead of the smoke one")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args()

    cfg = get_config(args.arch) if args.full else get_smoke(args.arch)
    dev = resolve_device(args.device)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(args.seed))
    prompt_len = 8
    res = serve(cfg, params, batch=args.batch, prompt_len=prompt_len, tokens=args.tokens,
                max_seq=args.max_seq, seed=args.seed, device=dev)
    print(f"prefill {prompt_len} tokens in {res.prefill_s:.2f}s; decoded "
          f"{args.tokens} x {args.batch} seqs in {res.total_s:.2f}s "
          f"({res.tokens_per_s:.1f} tok/s) on {dev}")
    print("sequences:\n", res.tokens)


if __name__ == "__main__":
    main()
