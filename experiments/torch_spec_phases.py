#!/usr/bin/env python3
"""chip_smoke.py's speculative-decoding work alone, on one NVIDIA GPU: the
kernels built, the ``spec`` phase, the calibration and ``convert`` (whose
requant is README's recipe's draft), and the entry checkpoints with
``cli_serve`` (both servers, both generate runs). Prints each record and
writes them to chiprun_out/spec_phases.json; exits non-zero if a phase
fails its checks.

    python3 experiments/torch_spec_phases.py [PHASE ...]   # from a checkout's root

PHASE names some of spec, convert, cli_serve (default: all).
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
    wanted = set(sys.argv[1:]) or {"spec", "convert", "cli_serve"}
    ok = True
    os.makedirs("build", exist_ok=True)
    root = tempfile.mkdtemp(prefix="spec_entry_", dir="build")

    def run(name, fn):
        nonlocal ok
        cs.starting(name)
        t0 = time.perf_counter()
        rec = {**fn(), "seconds": time.perf_counter() - t0}
        records.append(rec)
        print(json.dumps(rec), flush=True)
        ok = ok and rec["ok"]

    try:
        if "spec" in wanted:
            run("spec", lambda: cs.spec_run(dev))
        if "convert" in wanted:
            run("calibration", lambda: cs.calibration_run(dev))
            run("convert", lambda: cs.convert_run(dev))
        if "cli_serve" in wanted:
            ckpts = cs.write_entry_checkpoints(dev, root)
            run("cli_serve", lambda: cs.cli_serve_run(dev, ckpts["paths"]))
    finally:
        for path in (cs.CALIB_DIR, cs.CONVERT_DIR, root):
            shutil.rmtree(path, ignore_errors=True)
        os.makedirs("chiprun_out", exist_ok=True)
        with open(os.path.join("chiprun_out", "spec_phases.json"), "w") as f:
            json.dump(records, f, indent=1)
    print(json.dumps({"ok": ok, "seconds": {r.get("phase", "build"): r.get("seconds")
                                            for r in records[1:]}}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
