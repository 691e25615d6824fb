"""Compare two ptxas reports of the port's kernels, instance by instance.

    python3 experiments/ptxas_compare.py chiprun_out/ptxas_probe.txt
    python3 experiments/ptxas_compare.py NEW_ptxas.txt OLD_ptxas.txt

With two reports (chip_smoke.py's ``chiprun_out/ptxas.txt`` of two
checkouts, or experiments/torch_k1_b10_ab.py's ``ptxas_new.txt`` and
``ptxas_parent.txt``), every source's instances are matched by name and
template arguments, and each difference is printed with the count that
match; the groups of instances a change must leave alone are also counted
apart: int8_matmul.cu's decode GEMV (``int8_gemv_kernel``) and B10's three
kernels, int4_matmul.cu's decode GEMV (``int4_gemv_kernel``) and prefill
GEMM (``int4_gemm_kernel``), flash_decode.cu's split-KV kernels.

Reads a report written by experiments/torch_codes_probe.py (sections
``== <source>.o.log`` of this checkout and ``== parent <source>.cu rc 0`` of
another) and, for lut_gemv.cu and gather_prefill.cu, prints each kernel
instance whose registers, spills or stack differ from the other checkout's,
each instance the other has not got, and the count that match. An instance
is matched by its template arguments, less the expert flag (K1's fourth,
0 for the dense instances) and K2's output type (bf16 in the other).
Needs ``c++filt``.
"""
import re
import subprocess
import sys


def parse(text):
    out, cur = {}, None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            cur = m.group(1)
            continue
        for pat, key in ((r"Used (\d+) registers", "regs"), (r"(\d+) bytes stack frame", "stack"),
                         (r"(\d+) bytes spill stores, (\d+) bytes spill loads", "spill")):
            m = re.search(pat, line)
            if m and cur:
                out.setdefault(cur, {})[key] = tuple(int(g) for g in m.groups())
    return out


def key(mangled):
    name = subprocess.run(["c++filt", mangled], capture_output=True, text=True).stdout.strip()
    m = re.search(r"::(\w+)(<[^()]*>)?\(", name)
    return m.group(1) + (m.group(2) or "")


def sections_of(path):
    return {s.splitlines()[0]: parse(s) for s in re.split(r"^== ", open(path).read(), flags=re.M)
            if s.strip()}


def compare(name, new, old):
    same = 0
    for k, v in sorted(new.items()):
        o = old.get(k)
        if o is None:
            print("new ", k, v)
        elif o != v:
            print("DIFF", k, v, "was", o)
        else:
            same += 1
    for k in sorted(set(old) - set(new)):
        print("gone", k, old[k])
    print(f"{name}: {same} of {len(new)} instances unchanged (the other has {len(old)})")


# (source, group): name prefixes of the instances counted apart
GROUPS = {("int8_matmul", "decode GEMV"): ("int8_gemv_kernel<",),
          ("int8_matmul", "B10"): ("int8_gemv_t_kernel<", "int8_scale_g_kernel",
                                   "int8_gemm_t_kernel<"),
          ("int4_matmul", "decode GEMV"): ("int4_gemv_kernel<",),
          ("int4_matmul", "prefill GEMM"): ("int4_gemm_kernel<",),
          ("flash_decode", "split-KV"): ("flash_decode_split_kernel<",
                                         "flash_decode_combine_kernel<")}


def main_two(path_new, path_old):
    a, b = sections_of(path_new), sections_of(path_old)
    for src in sorted(set(a) | set(b)):
        new = {key(k): v for k, v in a.get(src, {}).items()}
        old = {key(k): v for k, v in b.get(src, {}).items()}
        compare(src, new, old)
        for (stem, group), prefixes in GROUPS.items():
            if src.startswith(stem):
                inst = [k for k in old if k.startswith(prefixes)]
                same = sum(new.get(k) == old[k] for k in inst)
                print(f"{src}: {group} instances: {same} of {len(inst)} unchanged")


def main(path):
    sections = sections_of(path)
    for src, to_old in (("lut_gemv", lambda k: k.replace(", 0>", ">")),
                        ("gather_prefill", lambda k: k.replace("<__nv_bfloat16>", ""))):
        new = {key(k): v for k, v in sections[f"{src}.o.log"].items()}
        old = {key(k): v for k, v in sections[f"parent {src}.cu rc 0"].items()}
        same = 0
        for k, v in sorted(new.items()):
            o = old.get(to_old(k))
            if o is None:
                print("new ", k, v)
            elif o != v:
                print("DIFF", k, v, "was", o)
            else:
                same += 1
        print(f"{src}: {same} of the other's {len(old)} instances unchanged")


if __name__ == "__main__":
    if len(sys.argv) == 2:
        main(sys.argv[1])
    else:
        main_two(sys.argv[1], sys.argv[2])
