#!/usr/bin/env python3
"""chip_smoke.py's PV-tuning and converter phases alone, on one NVIDIA GPU:
the kernels built, B13's and B14's checks with the scanned student's forms
(their times feed the phases' kernel shares), the calibration run (its
checkpoint is the student and the requant's source), ``pv``, ``pv_scan``,
``pv_scan_depth`` and ``convert``. Prints each record and writes them to
chiprun_out/pv_phases.json; exits non-zero if a phase fails its checks.

    python3 experiments/torch_pv_phases.py [PHASE ...]   # from a checkout's root

PHASE names some of pv, pv_scan, pv_scan_depth, convert (default: all; the
calibration runs whenever pv, pv_scan or convert does, and pv_scan needs pv).
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
            gen = torch.Generator(device=dev).manual_seed(0)
            cs.check_calib(gen, dev, failures)
            cs.check_manual_proj(gen, dev, failures)
        records.append({"phase": "checks", "failures": len(failures),
                        "seconds": time.perf_counter() - t0})
        print(json.dumps(records[-1]), flush=True)
        pv_codes = {}
        phases = (("calibration", cs.calibration_run),
                  ("pv", lambda d: cs.pv_run(d, pv_codes)),
                  ("pv_scan", lambda d: cs.pv_scan_run(d, records[-1], pv_codes)),
                  ("pv_scan_depth", cs.pv_scan_depth_run),
                  ("convert", cs.convert_run))
        wanted = set(sys.argv[1:]) or {name for name, _ in phases}
        if "pv_scan" in wanted:
            wanted.add("pv")
        if wanted & {"pv", "convert"}:
            wanted.add("calibration")
        for name, fn in phases:
            if name not in wanted:
                continue
            cs.starting(name)
            t0 = time.perf_counter()
            rec = {**fn(dev), "seconds": time.perf_counter() - t0}
            records.append(rec)
            print(json.dumps(rec), flush=True)
            ok = ok and rec["ok"]
    finally:
        for path in (cs.CALIB_DIR, cs.PV_DIR, cs.CONVERT_DIR):
            shutil.rmtree(path, ignore_errors=True)
        os.makedirs("chiprun_out", exist_ok=True)
        with open(os.path.join("chiprun_out", "pv_phases.json"), "w") as f:
            json.dump(records + [r for r in cs.RECORDS if r.get("kernel") in
                                 ("dequantize_onehot", "cb_grad_segment")], f, indent=1)
    ok = ok and not failures
    print(json.dumps({"ok": ok, "failures": len(failures),
                      "seconds": {r["phase"]: r["seconds"] for r in records[1:]}}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
