"""Serving driver: batched prefill + decode loop (CLI).

  python -m repro_torch.launch.serve --arch qwen1.5-4b --smoke --batch 4 \
      --prompt-len 32 --gen 16 --device cpu

Serves a batch of synthetic prompts: one prefill step builds the KV caches,
then greedy decode streams tokens.  As in the reference, the prefill's
caches are not used: the prompt is replayed token by token through fresh
zero decode caches, then ``--gen`` tokens are generated (for whisper those
caches include zero cross-attention K/V, so decoding ignores the encoder).
Weights come from ``init_params`` on a generator on ``--device`` seeded
with ``--seed``; prompts (and frames / patches) from a CPU generator seeded
with ``--seed + 1``.  Times are taken after ``torch.cuda.synchronize()``
on the card.
"""

from __future__ import annotations

import argparse
import sys
import time

import torch

from repro_torch import check_device
from repro_torch.configs import get_smoke, get_spec
from repro_torch.models import init_params, make_decode_step, make_prefill_step
from repro_torch.models.steps import cache_len, zeros_caches


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    ap.add_argument("--arch", default="qwen1.5-4b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (default cuda)")
    return ap


def make_batch(spec, batch: int, prompt_len: int, generator, device):
    """Synthetic prompts (and frames / patches) as the reference's CLI
    shapes them, drawn from ``generator`` (CPU) and moved to ``device``."""
    B, S = batch, prompt_len
    out = {"tokens": torch.randint(0, spec.vocab, (B, S), generator=generator,
                                   dtype=torch.int32)}
    if spec.family == "encdec":
        out["frames"] = torch.randn((B, S, spec.frontend_dim),
                                    generator=generator).to(torch.bfloat16)
    if spec.family == "vlm":
        out = {
            "patches": torch.randn((B, spec.n_prefix_tokens, spec.frontend_dim),
                                   generator=generator).to(torch.bfloat16),
            "tokens": out["tokens"][:, : max(S - spec.n_prefix_tokens, 1)],
        }
    return {k: v.to(device) for k, v in out.items()}


def run(args) -> dict:
    """Serve one batch -> {spec, prefill logits, generated ids (B, gen),
    prefill / replay / generation seconds, decode steps}."""
    dev = check_device(args.device)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    spec = get_smoke(args.arch) if args.smoke else get_spec(args.arch)
    print(f"[serve] arch={spec.name} params={spec.param_count():,}")
    params = init_params(spec, torch.Generator(device=dev).manual_seed(args.seed),
                         device=dev)

    B, S = args.batch, args.prompt_len
    batch = make_batch(spec, B, S, torch.Generator().manual_seed(args.seed + 1), dev)
    prefill = make_prefill_step(spec, kv_chunk=min(S, 128))
    decode = make_decode_step(spec)

    sync()
    t0 = time.perf_counter()
    logits, prefill_caches = prefill(params, batch)
    sync()
    t_prefill = time.perf_counter() - t0
    del prefill_caches  # unused, as in the reference: free them first

    # fresh fixed-size decode cache (prompt replay then generation)
    total = S + args.gen + 1
    caches = zeros_caches(spec, B, cache_len(spec, total), device=dev)
    toks = batch["tokens"]
    out_tokens = []
    sync()
    t0 = time.perf_counter()
    pos = 0
    for i in range(toks.shape[1]):          # replay prompt through the cache
        tok, caches = decode(params, caches, toks[:, i:i + 1], pos)
        pos += 1
    sync()
    t_replay = time.perf_counter() - t0
    for _ in range(args.gen):               # generate
        tok, caches = decode(params, caches, tok, pos)
        out_tokens.append(tok[:, 0])
        pos += 1
    sync()
    t_decode = time.perf_counter() - t0
    gen = torch.stack(out_tokens, 1).cpu() if out_tokens \
        else torch.zeros((B, 0), dtype=torch.int32)
    return {"spec": spec, "logits": logits, "gen": gen, "t_prefill": t_prefill,
            "t_replay": t_replay, "t_decode": t_decode, "steps": pos,
            "batch": B, "prompt_len": S}


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    r = run(args)
    B, S, steps = r["batch"], r["prompt_len"], r["steps"]
    t_prefill, t_decode = r["t_prefill"], r["t_decode"]
    t_gen = t_decode - r["t_replay"]
    print(f"[serve] prefill {B}x{S}: {t_prefill*1e3:.1f}ms   "
          f"decode {steps} steps: {t_decode*1e3:.1f}ms "
          f"({t_decode/steps*1e3:.1f}ms/tok)")
    if args.gen:
        print(f"[serve] generate {B}x{args.gen}: {t_gen*1e3:.1f}ms, "
              f"{B * args.gen / t_gen:.1f} tokens/s")
    gen = r["gen"]
    print(f"[serve] sample generations (token ids): {gen[:2, :8].tolist()}")
    if gen.numel() and int(gen.max()) >= r["spec"].vocab:
        raise AssertionError("sampled a padded-vocab token")
    print("[serve] ok")
    return 0


if __name__ == "__main__":
    sys.exit(main())
