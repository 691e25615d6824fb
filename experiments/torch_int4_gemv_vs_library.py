"""Time the int4 (W4A16) decode GEMV beside ``torch._weight_int4pack_mm`` over
several rounds, to show how far apart the two lie against their own spread.

    python3 experiments/torch_int4_gemv_vs_library.py [ROUNDS] [OUT_JSON]

At chip_smoke.INT4_PROJS (Llama-2-7B's fused qkv, o, fused gate/up and down)
and rows 1, 2, 4 and 8, each round times the kernel and the library call
once each with chip_smoke.time_ms (a CUDA graph of 50 calls over 8 stacked
layers, median of 3 replays), the kernel first in even rounds and the
library first in odd ones. Each shape's record holds both lists of times,
their medians, minima and maxima, and a verdict: "faster" where the
kernel's slowest round beats the library's fastest, "slower" where its
fastest loses to the library's slowest, else "tied". Prints the card's name
and power limit and one JSON line per shape; writes all of them to OUT_JSON
(default chiprun_out/int4_gemv_vs_library.json). ROUNDS defaults to 9.
"""
import json
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import torch  # noqa: E402

from chip_smoke import INT4_PROJS, N_LAYERS_TIMED, _int4_library, compare, time_ms  # noqa: E402
from aqlm_tpu_torch.ops import int4_matmul as i4  # noqa: E402

ROUNDS = int(sys.argv[1]) if len(sys.argv) > 1 else 9
OUT_JSON = sys.argv[2] if len(sys.argv) > 2 else os.path.join("chiprun_out",
                                                               "int4_gemv_vs_library.json")
ROWS = (1, 2, 4, 8)


def summary(ts):
    return {"median": statistics.median(ts), "min": min(ts), "max": max(ts)}


def main() -> int:
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    gen = torch.Generator(device=dev).manual_seed(0)
    L = N_LAYERS_TIMED
    records, bad = [], 0
    with torch.inference_mode():
        for name, out_f, in_f in INT4_PROJS:
            packs = [i4.quantize_int4(torch.randn((out_f, in_f), generator=gen, device=dev)
                                      * in_f ** -0.5) for _ in range(L)]
            w4, gs = torch.stack([p[0] for p in packs]), torch.stack([p[1] for p in packs])
            lib = [_int4_library(w4[i], gs[i], in_f) for i in range(L)]
            del packs
            for rows in ROWS:
                x = torch.randn((L, rows, in_f), generator=gen, device=dev).to(torch.bfloat16)
                run = lambda i=0: i4.launch(x[i % L], w4[i % L], gs[i % L])
                library = lambda i=0: torch._weight_int4pack_mm(x[i % L], lib[i % L][0], i4.GROUP,
                                                                lib[i % L][1])
                ok = compare(run(0), i4.plain(x[0], w4[0], gs[0]))["ok"]
                t = {"kernel": [], "library": []}
                for r in range(ROUNDS):
                    for which in (("kernel", "library") if r % 2 == 0 else ("library", "kernel")):
                        t[which].append(time_ms(run if which == "kernel" else library, 50))
                k, b = summary(t["kernel"]), summary(t["library"])
                verdict = ("faster" if k["max"] < b["min"] else
                           "slower" if k["min"] > b["max"] else "tied")
                rec = {"proj": name, "rows": rows, "ok": ok, "rounds": ROUNDS,
                       "kernel_ms": t["kernel"], "library_ms": t["library"], "kernel": k,
                       "library": b, "median_ratio": k["median"] / b["median"],
                       "verdict": verdict, "card": smi}
                records.append(rec)
                bad += not ok
                print(json.dumps({key: v for key, v in rec.items()
                                  if key not in ("kernel_ms", "library_ms")}), flush=True)
            del w4, gs, lib
            torch.cuda.empty_cache()
    os.makedirs(os.path.dirname(OUT_JSON) or ".", exist_ok=True)
    with open(OUT_JSON, "w") as f:
        json.dump(records, f, indent=1)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
