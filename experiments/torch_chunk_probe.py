"""Decode tok/s of chip_smoke.py's int8_short engine at decode_chunk 1 and 8,
in turns within one process, and where a step's time goes.

    python3 experiments/torch_chunk_probe.py [ROUNDS]

One Llama-2-7B int8 engine (int8 lm_head, ServeConfig(max_batch=4,
max_len=512, kv_quantized=True), random weights from seed 0) serves prompts
of int8_short's lengths (64, 150, 270, 380 tokens, fresh ids each run, 64
new tokens, greedy). Between runs only ``engine.serve.decode_chunk``
changes, in the order 1, 8, 8, 1 per round, each with chip_smoke's sync
counter off and on. Per run: decode tok/s over the steps that admitted
nothing, and per decode forward the host's time (from entering
``Engine._decode_chunk`` to its return, before the tokens are read back)
beside the wall time of the step. Prints one JSON line per run and a
summary line of medians; needs one CUDA card.
"""
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from aqlm_tpu_torch.serve import Engine, SamplingParams, ServeConfig  # noqa: E402


def main() -> int:
    rounds = int(sys.argv[1]) if len(sys.argv) > 1 else 2
    dev = torch.device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    cfg = cs.model_config("llama2_7b")
    params = cs.run_params(dev, "int8", cfg, seed=0)
    serve = ServeConfig(max_batch=4, max_len=512, kv_quantized=True, lm_head_int8=True)
    engine = Engine(params, cfg, serve)
    del params
    rng = np.random.default_rng(0)
    steps, host_times = [], []
    inner_step, inner_chunk = engine.step, engine._decode_chunk

    def timed_step():
        n_pending = len(engine._pending)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        emitted = inner_step()
        torch.cuda.synchronize()
        n_tok = sum(len(v) if isinstance(v, list) else 1 for v in emitted.values())
        steps.append((time.perf_counter() - t0, len(engine._pending) == n_pending, n_tok))
        return emitted

    def timed_chunk(*args):
        t0 = time.perf_counter()
        out = inner_chunk(*args)
        host_times.append((time.perf_counter() - t0, args[5]))  # (host s, forwards)
        return out

    engine.step, engine._decode_chunk = timed_step, timed_chunk
    engine.generate([rng.integers(0, cfg.vocab_size, 64)], SamplingParams(max_new_tokens=10))
    runs = []
    for _ in range(rounds):
        for chunk in (1, 8, 8, 1):
            for counted in (False, True):
                engine.serve = dataclasses.replace(serve, decode_chunk=chunk)
                if counted:
                    engine._decode_chunk = lambda *a: cs.count_syncs(timed_chunk, *a)[0]
                else:
                    engine._decode_chunk = timed_chunk
                steps.clear()
                host_times.clear()
                prompts = [rng.integers(0, cfg.vocab_size, n) for n in cs.SHORT_LENGTHS]
                engine.generate(prompts, SamplingParams(max_new_tokens=64))
                decode = [s for s in steps if s[1] and s[2] > 0]
                fwd = sum(n for _, n in host_times[-len(decode):])
                rec = {"decode_chunk": chunk, "sync_counter": counted,
                       "decode_tok_s": sum(s[2] for s in decode) / sum(s[0] for s in decode),
                       "wall_ms_per_forward": 1e3 * sum(s[0] for s in decode) / fwd,
                       "host_ms_per_forward": 1e3 * sum(t for t, _ in host_times[-len(decode):]) / fwd}
                runs.append(rec)
                print(json.dumps(rec), flush=True)
    summary = {}
    for chunk in (1, 8):
        for counted in (False, True):
            sel = [r for r in runs if r["decode_chunk"] == chunk and r["sync_counter"] == counted]
            summary[f"chunk{chunk}_{'counted' if counted else 'plain'}"] = {
                k: statistics.median(r[k] for r in sel)
                for k in ("decode_tok_s", "wall_ms_per_forward", "host_ms_per_forward")}
    print(json.dumps({"summary": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
