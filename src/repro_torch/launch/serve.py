"""Serving launcher: batched greedy decode with the KV/state cache.

    python -m repro_torch.launch.serve --arch recurrentgemma-2b \
        --batch 4 --prompt-len 12 --gen-len 24 [--full] [--device cpu] [--seed 0]

Random weights and prompts from ``--seed``.  The prompt goes in token by
token through ``serve_step`` (as in the reference's launcher), then greedy
decode.  Every architecture with a decode step serves; an encoder-only one
(hubert-xlarge) is refused with the reference's reason, "encoder-only: no
decode step".  Runs on the CUDA device by default (``--device cpu`` to run
on the CPU); ``--reduced`` (the default) is the tiny same-topology
configuration, ``--full`` the published one.  Prints tokens/s beside the
device's name.
"""
from __future__ import annotations

import argparse
import time


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=12)
    ap.add_argument("--gen-len", type=int, default=24)
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default cuda)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch

    from repro_torch.configs.base import SHAPES, cell_is_runnable, get_arch
    from repro_torch.launch.mesh import resolve_device
    from repro_torch.models import model as M
    from repro_torch.train.step import make_serve_step

    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    runnable, why = cell_is_runnable(cfg, SHAPES["decode_32k"])
    if not runnable:
        raise SystemExit(f"{cfg.name}: {why}")
    dev = resolve_device(args.device)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = M.init_params(cfg, dev, generator=gen)
    total = args.prompt_len + args.gen_len
    cache = M.init_cache(cfg, args.batch, total, dev)
    prompts = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len),
                            generator=gen, device=dev)
    step = make_serve_step(cfg)
    tok = None
    t0 = time.perf_counter()
    for t in range(args.prompt_len):
        tok, cache = step(params, cache, prompts[:, t:t + 1], t)
    gen_toks = [tok]
    for t in range(args.prompt_len, total - 1):
        tok, cache = step(params, cache, tok[:, None], t)
        gen_toks.append(tok)
    out = torch.stack(gen_toks, dim=1).cpu()   # waits for the device
    dt = time.perf_counter() - t0
    n = args.batch * (len(gen_toks) + args.prompt_len)
    where = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
             else "cpu")
    print(f"{cfg.name}: {n} tokens through serve_step in {dt:.3f}s "
          f"({n / dt:.1f} tok/s on {where}); batch {args.batch}, prompt "
          f"{args.prompt_len}, generated {out.shape[1]} per sequence")
    print(f"first sequence's generated ids: {out[0].tolist()}")
    return out


if __name__ == "__main__":
    main()
