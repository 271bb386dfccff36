"""Serving: batched prefill + greedy decode loop (the counterpart of
``repro.launch.serve``).

Prefills a batch of prompts (the packed-LM pipeline's tokens, as the
reference's ``make_batch`` gives them, after its VLM patch prefix or
beside its enc-dec frames), then steps the decode loop, greedy-sampling
one token per request per step against the cache.  Every family of the
model zoo serves; on the card each decode step's causal attention (GQA,
MLA, the enc-dec decoder's self-attention) is the ``gqa_decode`` kernel.

    python -m repro_torch.launch.serve --arch qwen3-4b            # GPU, full width
    python -m repro_torch.launch.serve --arch mixtral-8x7b --smoke --device cpu

With ``window == 0`` the attention caches hold prompt_len + gen_len
positions, the slots past the prompt at position -1 (the reference grows
its prefill cache to that size).  With ``window > 0`` they are not grown:
they have min(prompt_len, window) slots, so with prompt_len < window the
effective window is prompt_len, as in the reference.  The recurrent states
(RWKV, Mamba) have no length.  The prompt length counts a VLM's patch
positions (internvl2: 256 of them), so decoding starts at position
prompt_len there too.

Whole at full width, mixtral-8x7b (93 GB of bf16 weights) and
jamba-1.5-large-398b (~800 GB) do not fit on one 80 GB card; from Python,
serve a config with fewer layers (``dataclasses.replace(cfg, n_layers=8)``
for mixtral; for jamba also a shorter superblock,
``ssm=dataclasses.replace(cfg.ssm, attn_every_n=2)`` with n_layers=2).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time

import torch

from repro_torch.configs import ARCH_IDS, get_config, smoke_variant
from repro_torch.device import resolve_device, synchronize
from repro_torch.launch.train import make_batch
from repro_torch.models.model_zoo import build


@dataclasses.dataclass
class ServeResult:
    tokens: torch.Tensor         # (batch, gen_len) int32, on the CPU
    logits: torch.Tensor         # (batch, V) float32 of the last step, CPU
    prefill_ms: float            # prefill + first greedy token
    first_decode_ms: float       # the first decode step (cold)
    decode_ms_per_step: float    # mean of the later steps (warm)
    tokens_per_s: float          # batch * (gen_len - 1) / decode time
    device: str


def serve(cfg, batch: int = 4, prompt_len: int = 32, gen_len: int = 16,
          window: int = 0, seed: int = 0, device=None, params=None,
          verbose: bool = True) -> ServeResult:
    """Serve `batch` prompts of `prompt_len` tokens for `gen_len` greedy
    tokens each.  `device` None means CUDA (raises where there is none);
    `params` takes weights made elsewhere (a `Transformer` or an `EncDec`,
    for instance from ``repro_torch.carry.model_params_from_reference``; it
    is moved to `device` in place), else random weights are drawn from
    `seed`."""
    if gen_len < 1:
        raise ValueError(f"gen_len must be >= 1, got {gen_len}")
    dev = resolve_device(device)
    model = build(cfg)
    params = (model.init_params(seed, dev) if params is None
              else params.to(dev))
    b = make_batch(cfg, batch, prompt_len, seed)
    prompt = {key: b[key].to(dev) for key in ("tokens", "patch_embeds",
                                               "frames") if key in b}
    max_seq = prompt_len + gen_len
    start = b["tokens"].shape[1] + (cfg.n_prefix_patches or 0)

    synchronize(dev)
    t0 = time.perf_counter()
    logits, cache = model.prefill(params, prompt, window=window,
                                  cache_len=max_seq if window == 0 else None)
    tokens = logits.argmax(dim=-1)[:, None].to(torch.int32)
    synchronize(dev)
    prefill_s = time.perf_counter() - t0

    out = [tokens]
    first_s = 0.0
    t0 = time.perf_counter()
    for i in range(gen_len - 1):
        logits, cache = model.decode_step(params, cache, tokens, start + i,
                                          window=window)
        tokens = logits.argmax(dim=-1)[:, None].to(torch.int32)
        out.append(tokens)
        if i == 0:
            synchronize(dev)
            first_s = time.perf_counter() - t0
    synchronize(dev)
    decode_s = time.perf_counter() - t0
    steps = gen_len - 1
    warm = (decode_s - first_s) / (steps - 1) if steps > 1 else first_s
    res = ServeResult(
        tokens=torch.cat(out, dim=1).cpu(), logits=logits.float().cpu(),
        prefill_ms=prefill_s * 1e3, first_decode_ms=first_s * 1e3,
        decode_ms_per_step=warm * 1e3,
        tokens_per_s=batch * steps / decode_s if steps else 0.0,
        device=str(dev))
    if verbose:
        print(f"generated {tuple(res.tokens.shape)} tokens on {dev}: "
              f"prefill {res.prefill_ms:.1f} ms, decode "
              f"{res.decode_ms_per_step:.3f} ms/step, "
              f"{res.tokens_per_s:.1f} tok/s")
    return res


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen3-4b", choices=ARCH_IDS)
    ap.add_argument("--smoke", action="store_true",
                    help="the reduced smoke variant (2 layers, float32)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen-len", type=int, default=16)
    ap.add_argument("--device", default=None,
                    help="default: cuda; 'cpu' runs the plain versions")
    args = ap.parse_args(argv)
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = smoke_variant(cfg)
    res = serve(cfg, batch=args.batch, prompt_len=args.prompt_len,
                gen_len=args.gen_len, device=args.device)
    print(json.dumps({"arch": cfg.name, "smoke": args.smoke,
                      "device": res.device, "tokens": res.tokens.tolist(),
                      "prefill_ms": res.prefill_ms,
                      "decode_ms_per_step": res.decode_ms_per_step,
                      "tokens_per_s": res.tokens_per_s}))


if __name__ == "__main__":
    main()
