"""Batched serving demo of the PyTorch port: prefill a batch of prompts token
by token into the KV/state cache, then decode continuations greedily — the
same ``serve_step`` the dry-run's decode_32k/long_500k cells count and time.
The port's counterpart of ``examples/serve_lm.py``; it imports only
``repro_torch``.

Run:  PYTHONPATH=src python examples/serve_lm_torch.py [--arch recurrentgemma-2b] [--device cpu]
(the architecture is reduced to its smoke variant; the card by default).
"""
import argparse

import torch

from repro_torch.configs.base import get_arch
from repro_torch.launch.mesh import resolve_device
from repro_torch.models import model as M
from repro_torch.train.step import make_serve_step


def serve(params, cfg, prompts: torch.Tensor, gen_len: int) -> torch.Tensor:
    """Greedy continuation of ``prompts`` [B, L] (on the parameters'
    device): the prompt through the decode path token by token (filling
    the cache), then ``gen_len - 1`` greedy steps.  Returns the generated
    tokens [B, gen_len]: the prediction after the prompt, then each step's."""
    b, prompt_len = prompts.shape
    total = prompt_len + gen_len
    cache = M.init_cache(cfg, b, total, prompts.device)
    step = make_serve_step(cfg)
    tok = None
    for t in range(prompt_len):
        tok, cache = step(params, cache, prompts[:, t:t + 1], t)
    generated = [tok]
    for t in range(prompt_len, total - 1):
        tok, cache = step(params, cache, tok[:, None], t)
        generated.append(tok)
    return torch.stack(generated, dim=1)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=12)
    ap.add_argument("--gen-len", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default cuda)")
    args = ap.parse_args(argv)

    cfg = get_arch(args.arch).reduced()
    if not cfg.has_decode():
        raise SystemExit(f"{cfg.name}: encoder-only archs cannot decode")
    dev = resolve_device(args.device)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = M.init_params(cfg, dev, generator=gen)
    prompts = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len),
                            generator=gen, device=dev)
    gen_toks = serve(params, cfg, prompts, args.gen_len)
    print(f"arch={cfg.name} batch={args.batch} "
          f"prompt={args.prompt_len} generated={gen_toks.shape[1]} tokens")
    for i in range(args.batch):
        print(f"  req{i}: prompt={prompts[i].tolist()[:6]}... "
              f"-> {gen_toks[i].tolist()[:10]}...")
    print(f"serve ok: cache-backed batched decode ran end to end on {dev}")
    return prompts, gen_toks


if __name__ == "__main__":
    main()
