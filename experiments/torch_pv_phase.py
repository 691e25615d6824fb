#!/usr/bin/env python3
"""chip_smoke.py's PV-tuning phase alone, on one NVIDIA GPU: the kernels
built, B13's and B14's checks (their times feed the phase's kernel share),
the calibration run (its checkpoint is the student), then ``pv_run``.
Prints each record and writes them to chiprun_out/pv_phase.json; exits
non-zero if a phase fails its checks.

    python3 experiments/torch_pv_phase.py      # from the root of a checkout
"""

import json
import os
import shutil
import subprocess
import sys
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
    failures = []
    ok = True
    try:
        t0 = time.perf_counter()
        with torch.inference_mode():
            cs.check_calib(torch.Generator(device=dev).manual_seed(0), dev, failures)
        records.append({"phase": "check_calib", "failures": len(failures),
                        "seconds": time.perf_counter() - t0})
        for name, fn in (("calibration", cs.calibration_run), ("pv", cs.pv_run)):
            t0 = time.perf_counter()
            rec = {**fn(dev), "seconds": time.perf_counter() - t0}
            records.append(rec)
            print(json.dumps(rec), flush=True)
            ok = ok and rec["ok"]
            if not rec["ok"]:
                break
    finally:
        shutil.rmtree(cs.CALIB_DIR, ignore_errors=True)
        shutil.rmtree(cs.PV_DIR, ignore_errors=True)
        os.makedirs("chiprun_out", exist_ok=True)
        with open(os.path.join("chiprun_out", "pv_phase.json"), "w") as f:
            json.dump(records + [r for r in cs.RECORDS if r.get("kernel") in
                                 ("dequantize_onehot", "cb_grad_segment")], f, indent=1)
    ok = ok and not failures
    print(json.dumps({"ok": ok, "seconds": {r["phase"]: r["seconds"] for r in records[1:]}}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
