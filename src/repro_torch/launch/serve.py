"""Serving launcher of the port: batched prefill, then a greedy or sampled
decode loop, for any decoder ``--arch`` (after the JAX package's
``launch/serve.py``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-2.7b --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-moe-a2.7b --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-2.7b --preset full

The multimodal archs (encdec, vlm) are refused, as the reference's launcher
refuses them: they are served through their model entry points
(``models.encdec.prefill``/``decode``, ``models.lm.prefill``/``decode`` with
``patch_embeds``).

Weights are random, drawn from ``--seed`` on the device, and every matmul
weight is stored in the compute dtype as its layer is drawn
(``lm.init_params``).
Prompts come from ``--seed + 1`` and sampling from ``--seed + 2``, each an
explicit ``torch.Generator``.  The decode loop keeps the tokens on the
device; the host waits only at the end of prefill and of the loop, to time
them.
"""
from __future__ import annotations

import argparse
import time
from typing import NamedTuple, Optional

import torch

from ..configs import ARCHS, get_arch
from ..device import make_generator, resolve_device
from ..models import lm
from ..models.config import ModelConfig

__all__ = ["ServeResult", "generate", "main"]


class ServeResult(NamedTuple):
    ids: torch.Tensor              # (batch, gen) generated token ids, on the CPU
    prefill_logits: torch.Tensor   # (batch, 1, V) logits of the prompt's last position
    last_logits: torch.Tensor      # (batch, 1, V) logits of the last step
    prefill_ms: float
    decode_ms_per_token: float     # per decode step (one token for each sequence)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def generate(params, prompts: torch.Tensor, cfg: ModelConfig, gen_len: int,
             temperature: float = 0.0,
             generator: Optional[torch.Generator] = None) -> ServeResult:
    """Prefill ``prompts`` (B, S) and generate ``gen_len`` tokens per sequence:
    the first by argmax over the prefill logits, the rest by decode steps,
    greedy or sampled at ``temperature`` from ``generator``."""
    B, S = prompts.shape
    dev = prompts.device
    t0 = time.perf_counter()
    logits, cache = lm.prefill(params, {"tokens": prompts}, cfg, max_len=S + gen_len)
    _sync(dev)
    prefill_ms = (time.perf_counter() - t0) * 1e3
    prefill_logits = logits

    tok = logits[:, -1].argmax(dim=-1, keepdim=True)
    out = [tok]
    t0 = time.perf_counter()
    for i in range(gen_len - 1):
        logits, cache = lm.decode(params, cache, tok, S + i, cfg)
        if temperature > 0:
            probs = torch.softmax(logits[:, -1].float() / temperature, dim=-1)
            tok = torch.multinomial(probs, 1, generator=generator)
        else:
            tok = logits[:, -1].argmax(dim=-1, keepdim=True)
        out.append(tok)
    _sync(dev)
    decode_ms = (time.perf_counter() - t0) * 1e3 / max(gen_len - 1, 1)
    return ServeResult(torch.cat(out, dim=1).cpu(), prefill_logits, logits, prefill_ms,
                       decode_ms)


def main(argv=None) -> ServeResult:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True, choices=sorted(ARCHS))
    ap.add_argument("--preset", choices=["cpu-small", "full"], default="cpu-small")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    arch = get_arch(args.arch)
    cfg = arch.smoke if args.preset == "cpu-small" else arch.config
    if cfg.family in ("encdec", "vlm"):
        raise SystemExit(f"{args.arch} is {cfg.family}: serve it through its model entry "
                         f"points (models.encdec, models.lm with patch_embeds)")
    dev = resolve_device(args.device)
    params = lm.init_params(make_generator(args.seed, dev), cfg)
    prompts = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len),
                            generator=make_generator(args.seed + 1, dev), device=dev)
    res = generate(params, prompts, cfg, args.gen, args.temperature,
                   make_generator(args.seed + 2, dev))
    print(f"{cfg.name} on {dev}: prefill {res.prefill_ms:.1f} ms for "
          f"{args.batch}x{args.prompt_len} tokens")
    print(f"decode : {res.decode_ms_per_token:.1f} ms/token "
          f"({args.batch * 1e3 / max(res.decode_ms_per_token, 1e-9):.1f} tok/s batch)")
    print("sampled token ids:", res.ids[0][:16].tolist())
    return res


if __name__ == "__main__":
    main()
