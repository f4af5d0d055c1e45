"""Check the port's cost analysis (repro_torch.roofline.op_analysis)
against hand-computable cases: one matmul, a loop of 7 matmuls, and a
lower bound on the bytes.

    PYTHONPATH=src python scripts/torch_check_op_analysis.py [--device cpu]

Exits non-zero if a count is off. Runs on the card unless --device cpu.
"""
import argparse
import sys

import torch

from repro_torch.device import resolve_device
from repro_torch.roofline.op_analysis import analyze


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    dev = resolve_device(ap.parse_args(argv).device)
    ok = True

    # case 1: single matmul
    m, k, n = 128, 256, 512
    a = torch.randn((m, k), device=dev)
    b = torch.randn((k, n), device=dev)
    r = analyze(torch.matmul, a, b)
    exp = 2 * m * k * n
    print("matmul flops", r["flops"], "expected", exp, "ok", r["flops"] == exp)
    ok &= r["flops"] == exp

    # case 2: a loop of 7 matmuls
    L = 7
    x = torch.randn((m, m), device=dev)
    ws = torch.randn((L, m, m), device=dev)

    def looped(x, ws):
        for w in ws:
            x = x @ w
        return x
    r2 = analyze(looped, x, ws)
    exp2 = L * 2 * m * m * m
    print("loop flops", r2["flops"], "expected", exp2, "ok",
          r2["flops"] == exp2)
    ok &= r2["flops"] == exp2

    # case 3: the bytes of case 1 cover its operands and output
    low = (m * k + k * n + m * n) * 4
    print("bytes case1:", r["bytes"], ">=", low, "ok", r["bytes"] >= low)
    ok &= r["bytes"] >= low
    print("collectives:", r["collective_total"], "(one device)")
    ok &= r["collective_total"] == 0
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
