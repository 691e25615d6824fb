"""Generation CLI and tokens-per-second benchmark (PyTorch counterpart of
``aqlm_tpu.cli.generate``), and ``--device`` (default ``cuda``; ``cpu`` runs
the plain versions).

    python -m aqlm_tpu_torch.cli.generate MODEL_DIR --mode codes \\
        --prompt 1,2,3 --max_new_tokens 128 --benchmark

Prompts are comma-separated ids, or text when a tokenizer sits in the local
model directory. ``--benchmark`` prints ``<N tokens per second>``; the last
line is a JSON object: ``tokens_per_second``, ``new_tokens`` and, with a
tokenizer, ``text``. The first engine step (the prompt's prefill and the
first token) is left out of the timing, as in ``aqlm_tpu``.

``--draft_model`` (same formats as MODEL_DIR; ``--draft_mode`` defaults to
``--mode``) decodes speculatively with ``SpeculativeDecoder``, ``--spec_k``
proposals a round: one warm-up round, then a timed run on a fresh decoder;
its JSON line adds ``acceptance``. A 1x8 requant draft of the checkpoint
itself (``cli.convert --to requant --scheme 1x8``) is the usual draft.
``--no_compile_cache`` is accepted and does nothing: it switches off
``aqlm_tpu``'s XLA compilation cache, and the port compiles nothing per
shape.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np

from aqlm_tpu_torch.cli.common import dtype_from_str, load_tokenizer, resolve_model
from aqlm_tpu_torch.device import resolve_device
from aqlm_tpu_torch.serve import Engine, SamplingParams, ServeConfig, SpeculativeDecoder


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("model_path")
    p.add_argument("--prompt", type=str, default=None,
                   help="text (needs a tokenizer) or comma-separated ids")
    p.add_argument("--max_new_tokens", type=int, default=128)
    p.add_argument("--temperature", type=float, default=0.0)
    p.add_argument("--top_p", type=float, default=1.0)
    p.add_argument("--top_k", type=int, default=0)
    p.add_argument("--max_batch", type=int, default=1)
    p.add_argument("--max_len", type=int, default=2048)
    p.add_argument("--kv_int8", action="store_true")
    p.add_argument("--mode", choices=["reference", "codes", "int8", "int4"], default="int8")
    p.add_argument("--dtype", choices=["auto", "float32", "bfloat16"], default="bfloat16")
    p.add_argument("--benchmark", action="store_true",
                   help="print tokens/s like the reference generate benchmark")
    p.add_argument("--draft_model", type=str, default=None,
                   help="draft model for speculative decoding (same formats as model_path)")
    p.add_argument("--draft_mode", choices=["reference", "codes", "int8", "int4"], default=None,
                   help="runtime mode of the draft model (defaults to --mode)")
    p.add_argument("--spec_k", type=int, default=4, help="draft tokens proposed per verify")
    p.add_argument("--no_compile_cache", action="store_true", help="accepted; nothing to cache")
    p.add_argument("--device", default="cuda", help="cuda (the kernels) or cpu (plain versions)")
    return p


def _generate_speculative(args, params, cfg, prompt_ids, tokenizer, dev) -> dict:
    dparams, dcfg, _ = resolve_model(args.draft_model, dtype=dtype_from_str(args.dtype),
                                     mode=args.draft_mode or args.mode, device=dev)
    kw = dict(k=args.spec_k, max_len=args.max_len, kv_quantized=args.kv_int8,
              temperature=args.temperature, top_p=args.top_p, top_k=args.top_k, device=dev)
    # a warm-up round, then the timed run on a fresh decoder
    SpeculativeDecoder(params, cfg, dparams, dcfg, **kw).generate(
        prompt_ids, min(args.spec_k + 2, args.max_new_tokens))
    dec = SpeculativeDecoder(params, cfg, dparams, dcfg, **kw)
    del params, dparams
    _sync(dev)
    t0 = time.time()
    tokens, stats = dec.generate(prompt_ids, args.max_new_tokens)
    _sync(dev)
    tps = len(tokens) / max(time.time() - t0, 1e-9)
    if args.benchmark:
        print(f"<{tps:.2f} tokens per second>")
    out = {"tokens_per_second": round(tps, 2), "new_tokens": len(tokens),
           "acceptance": round(stats["acceptance"], 4)}
    if tokenizer is not None and tokens:
        out["text"] = tokenizer.decode(tokens)
    print(json.dumps(out))
    return {**out, "tokens": [int(t) for t in tokens], "stats": stats}


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    dev = resolve_device(args.device)
    params, cfg, _ = resolve_model(args.model_path, dtype=dtype_from_str(args.dtype),
                                   mode=args.mode, device=dev)
    tokenizer = load_tokenizer(args.model_path)
    if args.prompt is None:
        prompt_ids = np.arange(16, dtype=np.int64) % cfg.vocab_size
    elif all(c.isdigit() or c == "," for c in args.prompt):
        prompt_ids = np.asarray([int(t) for t in args.prompt.split(",")], np.int64)
    elif tokenizer is None:
        raise ValueError("a text prompt needs a tokenizer in the model directory")
    else:
        prompt_ids = np.asarray(tokenizer(args.prompt).input_ids, np.int64)
    if args.draft_model is not None:
        return _generate_speculative(args, params, cfg, prompt_ids, tokenizer, dev)

    bucket = 1 << max(5, int(np.ceil(np.log2(len(prompt_ids) + 1))))
    engine = Engine(params, cfg, ServeConfig(
        max_batch=args.max_batch, max_len=args.max_len, prefill_buckets=(bucket, args.max_len),
        kv_quantized=args.kv_int8, top_k=args.top_k), device=dev)
    del params
    sampling = SamplingParams(
        temperature=args.temperature, top_p=args.top_p, max_new_tokens=args.max_new_tokens,
        eos_token_id=getattr(tokenizer, "eos_token_id", None) if tokenizer else None)

    rid = engine.submit(prompt_ids, sampling)
    engine.step()  # the prefill and first token, left out of the timing
    _sync(dev)
    t0 = time.time()
    n = 1
    while engine._active or engine._pending:
        if engine.step():
            n += 1
    _sync(dev)
    dt = time.time() - t0
    tokens = engine.get_request(rid).generated
    if args.benchmark:
        print(f"<{(n - 1) / dt:.2f} tokens per second>")
    out = {"tokens_per_second": round((n - 1) / max(dt, 1e-9), 2), "new_tokens": n}
    if tokenizer is not None and tokens:
        out["text"] = tokenizer.decode(tokens)
    print(json.dumps(out))
    return {**out, "tokens": [int(t) for t in tokens]}


def _sync(dev) -> None:
    if dev.type == "cuda":
        import torch

        torch.cuda.synchronize(dev)


if __name__ == "__main__":
    main()
