#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

  python3 chip_smoke.py

Phases, one or more printed lines each; any failure exits non-zero:
  1. device   -- card name, count, and nvidia-smi's name and power limit;
  2. build    -- nvcc builds every kernel from ``src/repro_torch/kernels/csrc``;
  3. rmsnorm  -- the kernel against its plain PyTorch version on the card;
  4. attention-- the kernel against its plain PyTorch version on the card;
  5. slice    -- full-width qwen2-0.5b serving through ``serve()`` (prefill of
                 8 x 500 prompt tokens, 31 greedy decode steps), with the
                 kernels' launch counts read around that run; then a float32
                 teacher-forced run through the kernels and through the plain
                 versions, whose logits must agree;
                 A profiled prefill and decode step give the device's busy
                 time by kernel category and its idle share;
  6. timings  -- each kernel, its plain version and the nearest PyTorch
                 library call at the slice's shapes: device time from the
                 profiler (CUDA events per call beside it), and the least time
                 the card could take (published H100 peaks).
The line before the last is nvidia-smi's name and power limit again; the
last line is ``{"ok": true, "device": {...}}``.

Needs a CUDA device and the repository's sources; it imports nothing of JAX
or of the JAX package.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# Published peaks of one H100 SXM at its 700 W limit (NVIDIA data sheet, dense).
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bf16_tensor": 989e12, "f32": 67e12}

ARCH = "qwen2-0.5b"
BATCH, PROMPT_LEN, NEW_TOKENS = 8, 500, 32
MAX_SEQ = PROMPT_LEN + NEW_TOKENS
LOGIT_TOL = 2e-3          # tests/test_prefill.py's prefill/decode tolerance
RMSNORM_TOL = {"float32": 1e-5, "bfloat16": 3e-2}   # tests/test_kernels.py
ATTN_TOL = {"float32": 2e-4, "bfloat16": 3e-2}       # tests/test_kernels.py


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def say(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def ptxas_summary(log: str) -> list[str]:
    """One line per compiled kernel: its registers, shared memory and spills."""
    lines, name, spill = [], None, ""
    for raw in log.splitlines():
        if "Compiling entry function" in raw:
            name = raw.split("'")[1]
        elif "spill" in raw:
            spill = raw.strip()
        elif "Used" in raw and name:
            lines.append(f"{name[:70]}: {raw.split(':', 1)[1].strip()}; {spill}")
            name, spill = None, ""
    return lines


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device: torch.cuda.is_available() is false")
    sys.path.insert(0, str(ROOT / "src"))
    try:
        import torch.nn.functional as F

        from repro_torch.configs import get_config
        from repro_torch.kernels import _build
        from repro_torch.kernels.flash_attention.flash_attention import flash_attention as fa_kernel
        from repro_torch.kernels.flash_attention import ref as fa_ref
        from repro_torch.kernels.rmsnorm import ref as rn_ref
        from repro_torch.kernels.rmsnorm.rmsnorm import rmsnorm as rn_kernel
        from repro_torch.launch.serve import serve
        from repro_torch.models import decode_step, init_params, prefill
    except ImportError as e:
        fail(f"cannot import the port from {ROOT / 'src'}: {e}")

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()

    # 1. device
    kind, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    smi = nvidia_smi()
    say("device", f"{kind}; count {count}; nvidia-smi: {smi}; torch {torch.__version__} "
                  f"cuda {torch.version.cuda}")

    # 2. build
    info = _build.build()
    say("build", f"{info.path.relative_to(ROOT)} in {info.seconds:.1f} s")
    for line in ptxas_summary(info.ptxas_log):
        say("build", line)

    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    errs: dict[str, float] = {}

    def compare(phase, name, got, want, tol):
        err = (got.float() - want.float()).abs().max().item()
        ok = torch.allclose(got.float(), want.float(), rtol=tol, atol=tol)
        say(phase, f"{name}: max_abs_err {err:.3e} (tol {tol:g}) {'ok' if ok else 'MISMATCH'}")
        if not ok:
            fail(f"{phase} {name}: kernel disagrees with the plain version")
        return err

    # 3. rmsnorm kernel vs plain
    for rows, d in [(BATCH * PROMPT_LEN, 896), (BATCH, 896), (130, 640), (1, 8192)]:
        for dtype in (torch.float32, torch.bfloat16):
            x = randn(rows, d, dtype=dtype)
            for gdtype in sorted({torch.float32, dtype}, key=str):
                g = randn(d, dtype=gdtype)
                tol = RMSNORM_TOL[str(dtype).split(".")[1]]
                err = compare("rmsnorm", f"({rows}, {d}) {dtype} gamma {gdtype}",
                              rn_kernel(x, g), rn_ref.rmsnorm(x, g), tol)
                if (rows, d, dtype, gdtype) == (BATCH * PROMPT_LEN, 896, torch.bfloat16,
                                                torch.bfloat16):
                    errs["rmsnorm"] = err
    torch.cuda.synchronize()

    # 4. attention kernel vs plain
    def heads_view(b, h, s, dh, dtype):
        """(b, h, s, dh) view of a (b, s, h, dh) buffer, as the model passes it."""
        return randn(b, s, h, dh, dtype=dtype).transpose(1, 2)

    cases = [  # b, hq, hkv, sq, sk, dh, causal, window, valid_k, dtype, strided
        (BATCH, 14, 2, PROMPT_LEN, PROMPT_LEN, 64, True, 0, None, torch.float32, True),
        (BATCH, 14, 2, PROMPT_LEN, PROMPT_LEN, 64, True, 0, None, torch.bfloat16, True),
    ]
    for b, hq, hkv, sq, sk, dh in [(1, 4, 2, 256, 256, 64), (2, 8, 8, 128, 128, 32),
                                   (1, 8, 1, 128, 256, 64), (1, 4, 4, 384, 384, 128)]:
        for causal in (True, False):
            cases.append((b, hq, hkv, sq, sk, dh, causal, 0, None, torch.float32, False))
    for window in (32, 96, 200):
        cases.append((1, 4, 2, 256, 256, 64, True, window, None, torch.float32, False))
    cases += [
        (1, 2, 2, 200, 200, 64, False, 0, None, torch.float32, False),
        (1, 4, 2, 256, 256, 64, False, 0, 200, torch.float32, False),
        (1, 4, 2, 128, 128, 64, True, 0, None, torch.bfloat16, False),
        (1, 14, 2, 200, 200, 64, True, 0, None, torch.float32, True),
    ]
    for b, hq, hkv, sq, sk, dh, causal, window, valid_k, dtype, strided in cases:
        if strided:
            q, k, v = (heads_view(b, hq, sq, dh, dtype), heads_view(b, hkv, sk, dh, dtype),
                       heads_view(b, hkv, sk, dh, dtype))
        else:
            q, k, v = (randn(b, hq, sq, dh, dtype=dtype), randn(b, hkv, sk, dh, dtype=dtype),
                       randn(b, hkv, sk, dh, dtype=dtype))
        kw = dict(causal=causal, window=window, valid_k=valid_k)
        err = compare(
            "attention",
            f"q {tuple(q.shape)} kv {tuple(k.shape)} {dtype} {kw}{' strided' if strided else ''}",
            fa_kernel(q, k, v, **kw), fa_ref.attention(q, k, v, **kw),
            ATTN_TOL[str(dtype).split(".")[1]],
        )
        if (b, sq, dtype) == (BATCH, PROMPT_LEN, torch.bfloat16):
            errs["flash_attention"] = err
    torch.cuda.synchronize()

    # 5. slice: full-width serving through the port's entry point
    cfg = get_config(ARCH)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    say("slice", f"{ARCH}: {cfg.num_layers} layers, d {cfg.d_model}, "
                 f"{cfg.param_count()} params in {cfg.dtype}")
    serve(cfg, params, batch=BATCH, prompt_len=16, tokens=4, max_seq=32, device=dev)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa_kernel.launches = 0
    rn_kernel.launches = 0
    res = serve(cfg, params, batch=BATCH, prompt_len=PROMPT_LEN, tokens=NEW_TOKENS,
                max_seq=MAX_SEQ, seed=0, device=dev)
    launches = {"flash_attention": fa_kernel.launches, "rmsnorm": rn_kernel.launches}
    peak_mem = torch.cuda.max_memory_allocated()
    want = {"flash_attention": cfg.num_layers,
            "rmsnorm": (2 * cfg.num_layers + 1) * NEW_TOKENS}
    say("slice", f"launches {launches} (expected {want})")
    if launches != want:
        fail(f"slice: kernel launches {launches}, expected {want}")
    toks = res.tokens
    if toks.shape != (BATCH, NEW_TOKENS) or toks.min() < 0 or toks.max() >= cfg.vocab_size:
        fail(f"slice: bad tokens, shape {toks.shape}, range [{toks.min()}, {toks.max()}]")
    say("slice", f"bf16 serve: prefill {BATCH}x{PROMPT_LEN} in {res.prefill_s * 1e3:.3f} ms; "
                 f"{NEW_TOKENS - 1} decode steps at {res.decode_tokens_per_s:.1f} tok/s; "
                 f"total {res.total_s * 1e3:.3f} ms; max_memory_allocated {peak_mem} B")
    say("slice", f"first sequence: {toks[0].tolist()}")

    # where the device time goes: one prefill and one decode step, profiled
    prompt = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT_LEN), generator=gen,
                           device=dev, dtype=torch.int32)
    _, cache = prefill(params, cfg, {"tokens": prompt}, max_seq=MAX_SEQ)
    _breakdown("profile prefill",
               _device_events(lambda: prefill(params, cfg, {"tokens": prompt}, max_seq=MAX_SEQ)),
               res.prefill_s * 1e3)
    token = prompt[:, -1:]
    _breakdown("profile decode step",
               _device_events(lambda: decode_step(params, cfg, cache, token, PROMPT_LEN)),
               (res.total_s - res.prefill_s) / (NEW_TOKENS - 1) * 1e3)
    del params, cache

    # float32, teacher-forced on the kernel path's tokens: kernels vs plain
    cfg32 = cfg.replace(dtype="float32")
    p32 = init_params(cfg32, torch.Generator(device=dev).manual_seed(0))
    prompt = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT_LEN), generator=gen,
                           device=dev, dtype=torch.int32)
    worst = 0.0
    with torch.inference_mode():
        k_logits, k_cache = prefill(p32, cfg32, {"tokens": prompt}, max_seq=MAX_SEQ)
        p_logits, p_cache = prefill(p32, cfg32, {"tokens": prompt}, max_seq=MAX_SEQ, plain=True)
        worst = max(worst, _logit_check("prefill", k_logits, p_logits))
        token = k_logits[:, -1].argmax(-1)[:, None].to(torch.int32)
        del k_logits, p_logits
        for i in range(NEW_TOKENS - 1):
            k_logits, k_cache = decode_step(p32, cfg32, k_cache, token, PROMPT_LEN + i)
            p_logits, p_cache = decode_step(p32, cfg32, p_cache, token, PROMPT_LEN + i,
                                            plain=True)
            worst = max(worst, _logit_check(f"decode {i}", k_logits, p_logits, quiet=True))
            token = k_logits.argmax(-1)[:, None].to(torch.int32)
    say("slice", f"f32 teacher-forced logits, kernels vs plain: prefill and "
                 f"{NEW_TOKENS - 1} decode steps within {LOGIT_TOL:g} (max_abs_err {worst:.3e})")
    del p32, k_cache, p_cache
    torch.cuda.empty_cache()

    # 6. timings at the slice's shapes (bf16, as served)
    rows = []
    x = randn(BATCH * PROMPT_LEN, cfg.d_model, dtype=torch.bfloat16)
    g = randn(cfg.d_model, dtype=torch.bfloat16)
    rn_bytes = 2 * x.numel() * x.element_size() + g.numel() * g.element_size()
    rn_ops = 4 * x.numel()  # square, sum, scale, gamma: f32 arithmetic on CUDA cores
    rows.append(_timed(
        "rmsnorm", "src/repro_torch/kernels/csrc/rmsnorm.cu",
        "src/repro/kernels/rmsnorm/rmsnorm.py:22", tuple(x.shape),
        lambda: rn_kernel(x, g), lambda: rn_ref.rmsnorm(x, g),
        lambda: F.rms_norm(x, (cfg.d_model,), weight=g, eps=1e-6),
        rn_bytes, rn_ops, "f32", iters=500,
    ))
    xd = randn(BATCH, cfg.d_model, dtype=torch.bfloat16)
    say("timings", f"rmsnorm at the decode shape {tuple(xd.shape)}: device "
                   f"{_device_ms(lambda: rn_kernel(xd, g), 500)} ms, per call "
                   f"{_cuda_ms(lambda: rn_kernel(xd, g), 500):.5f} ms")

    hq, hkv, dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_
    q = heads_view(BATCH, hq, PROMPT_LEN, dh, torch.bfloat16)
    k = heads_view(BATCH, hkv, PROMPT_LEN, dh, torch.bfloat16)
    v = heads_view(BATCH, hkv, PROMPT_LEN, dh, torch.bfloat16)
    pairs = BATCH * hq * PROMPT_LEN * (PROMPT_LEN + 1) // 2  # causal (q, k) pairs
    fa_bytes = sum(t.numel() * t.element_size() for t in (q, k, v, q))
    fa_ops = 4 * dh * pairs  # q.k and p.v, a multiply and an add each
    rows.append(_timed(
        "flash_attention", "src/repro_torch/kernels/csrc/flash_attention.cu",
        "src/repro/kernels/flash_attention/flash_attention.py:45", tuple(q.shape),
        lambda: fa_kernel(q, k, v, causal=True), lambda: fa_ref.attention(q, k, v, causal=True),
        lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True, enable_gqa=True),
        fa_bytes, fa_ops, "bf16_tensor", iters=100,
    ))
    for r in rows:
        r["launches"] = launches[r["name"]]
        r["max_abs_err"] = errs[r["name"]]
        say("timings", f"{r['name']} {r['shape']} ({r['timing']}): kernel {r['ms']:.5f} ms, "
                       f"plain {r['plain_ms']:.5f} ms, library {r['library_ms']:.5f} ms, bound "
                       f"{r['bound_ms']:.5f} ms by {r['bound_by']}; per call with host "
                       f"overhead: kernel {r['call_ms']:.5f}, plain {r['plain_call_ms']:.5f}, "
                       f"library {r['library_call_ms']:.5f} ms")
    say("done", f"{time.perf_counter() - t_start:.1f} s")

    print(json.dumps({"kernels": rows}))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}))


def _logit_check(name, got, want, quiet=False) -> float:
    import torch

    if not torch.isfinite(got).all():
        fail(f"slice {name}: non-finite logits")
    err = (got - want).abs().max().item()
    if not torch.allclose(got, want, rtol=LOGIT_TOL, atol=LOGIT_TOL):
        fail(f"slice {name}: kernel-path logits differ from the plain path by {err:.3e}")
    if not quiet:
        say("slice", f"f32 {name} logits {tuple(got.shape)}: max_abs_err {err:.3e}")
    return err


def _cuda_ms(fn, iters: int) -> float:
    """Per-call time between CUDA events around ``iters`` back-to-back calls.

    When a call's host work (Python, launch) outlasts its device work, this
    is the host's rate, not the device's.
    """
    import torch

    for _ in range(10):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _device_events(fn):
    """(name, microseconds) of every device activity the profiler records in fn()."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [(e.name, e.time_range.elapsed_us()) for e in prof.events()
            if e.device_type == DeviceType.CUDA]


def _device_ms(fn, iters: int) -> float | None:
    """Device time per call: the profiler's device activity over ``iters``
    calls, divided by ``iters``; host overhead excluded.  None when the
    profiler records no device time."""
    for _ in range(10):
        fn()

    def run():
        for _ in range(iters):
            fn()

    us = sum(t for _, t in _device_events(run))
    return us / iters / 1e3 if us > 0 else None


def _category(name: str) -> str:
    if "attn_fwd_kernel" in name:
        return "flash_attention kernel"
    if "rmsnorm_kernel" in name:
        return "rmsnorm kernel"
    if any(w in name.lower() for w in ("gemm", "gemv", "xmma", "cutlass", "nvjet", "splitk")):
        return "matmul (cuBLAS)"
    return "other (elementwise, copies, softmax, argmax)"


def _breakdown(phase: str, events, wall_ms: float) -> None:
    busy = sum(t for _, t in events) / 1e3
    say(phase, f"device busy {busy:.3f} ms of {wall_ms:.3f} ms wall (idle share "
               f"{max(0.0, 1 - busy / wall_ms):.3f}); {len(events)} device activities")
    cats: dict[str, float] = {}
    for name, t in events:
        cats[_category(name)] = cats.get(_category(name), 0.0) + t / 1e3
    for cat, ms in sorted(cats.items(), key=lambda kv: -kv[1]):
        say(phase, f"  {cat}: {ms:.3f} ms ({ms / busy:.3f} of busy)")


def _timed(name, source, replaces, shape, kernel, plain, library, n_bytes, n_ops, op_type,
           iters):
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_ops / PEAK_OPS_PER_S[op_type] * 1e3
    row = {"name": name, "route": "cuda", "source": source, "replaces": replaces,
           "launches": None, "max_abs_err": None}
    for key, fn in (("ms", kernel), ("plain_ms", plain), ("library_ms", library)):
        row[key] = _device_ms(fn, iters)
        row[key.replace("ms", "call_ms")] = _cuda_ms(fn, iters)
    if row["ms"] is None:  # no device time from the profiler: fall back to events
        for key in ("ms", "plain_ms", "library_ms"):
            row[key] = row[key.replace("ms", "call_ms")]
    row.update({
        "bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "timing": "profiler device time" if row["ms"] != row["call_ms"] else "cuda events",
        "shape": list(shape), "bytes": n_bytes, "ops": n_ops,
    })
    return row


if __name__ == "__main__":
    main()
