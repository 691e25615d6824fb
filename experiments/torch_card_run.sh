#!/usr/bin/env bash
# The port's card tests, then chip_smoke.py, on one NVIDIA GPU. The whole
# output of both goes to OUTDIR (default: chiprun_out of the directory it is
# started from); stdout gets the card's nvidia-smi line, the pytest summary
# line and chip_smoke's last lines. Exits non-zero if either fails.
#
#   bash experiments/torch_card_run.sh [OUTDIR]
#
# Run it from the root of a checkout (or of an unpacked `git archive`); the
# tests run with --noconftest, since tests/conftest.py imports JAX.
set -u
out=$(realpath -m "${1:-chiprun_out}")
mkdir -p "$out"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader

python -m pytest --noconftest tests/test_torch_cuda.py -q -p no:cacheprovider \
    > "$out/cuda_tests.txt" 2>&1
tests_rc=$?
echo "card tests (rc $tests_rc): $(tail -n 1 "$out/cuda_tests.txt")"

python3 chip_smoke.py 2> "$out/smoke_stderr.txt" > "$out/smoke_log.txt"
smoke_rc=$?
if [ "$(realpath -m chiprun_out)" != "$out" ]; then
    cp chiprun_out/chip_smoke.json chiprun_out/ptxas.txt "$out/" 2>/dev/null
fi
echo "chip_smoke.py rc $smoke_rc; its last lines:"
tail -n 4 "$out/smoke_log.txt"
[ "$tests_rc" -eq 0 ] && [ "$smoke_rc" -eq 0 ]
