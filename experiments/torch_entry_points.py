#!/usr/bin/env python3
"""chip_smoke.py's entry-point phases alone, on one NVIDIA GPU: the
checkpoints (a canonical Llama-2-7B in 2x8 and its int8 convert, and 2-layer
cuts), ``unstacked_decode``, ``evaluate`` and ``cli_serve`` (with
``cli.generate --benchmark``). Builds the kernels first; prints each record
and writes them to chiprun_out/entry_points.json. Exits non-zero if a phase
fails its checks.

    python3 experiments/torch_entry_points.py      # from the root of a checkout
"""

import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def main() -> int:
    from aqlm_tpu_torch.ops import _build

    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    _, build_s = _build.library()
    records = [{"nvidia_smi": smi, "kernel_build_s": build_s}]
    os.makedirs("build", exist_ok=True)
    root = tempfile.mkdtemp(prefix="entry_checkpoints_", dir="build")
    ok = True
    try:
        for name, fn in (("entry_checkpoints", lambda: cs.write_entry_checkpoints(dev, root)),
                         ("unstacked_decode", None), ("evaluate", None), ("cli_serve", None)):
            t0 = time.perf_counter()
            if name == "entry_checkpoints":
                ckpts = rec = fn()
            elif name == "unstacked_decode":
                rec = cs.unstacked_decode(dev, ckpts["paths"])
            elif name == "evaluate":
                rec = cs.evaluate_run(dev, ckpts["paths"])
            else:
                rec = cs.cli_serve_run(dev, ckpts["paths"])
            rec = {"phase": name, **rec, "seconds": time.perf_counter() - t0}
            records.append(rec)
            print(json.dumps(rec), flush=True)
            ok = ok and rec.get("ok", True)
    finally:
        shutil.rmtree(root, ignore_errors=True)
        os.makedirs("chiprun_out", exist_ok=True)
        with open(os.path.join("chiprun_out", "entry_points.json"), "w") as f:
            json.dump(records, f, indent=1)
    print(json.dumps({"ok": ok, "seconds": {r["phase"]: r["seconds"] for r in records[1:]}}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
