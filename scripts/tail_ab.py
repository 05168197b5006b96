#!/usr/bin/env python3
"""One side of an A/B of the fused encoder tail (rows 13-14) past T = 64 on
one NVIDIA GPU: run it from the root of each checkout in turn, in one
process per run, on the same card (parent, change, change, parent), and
compare the lines it prints.

    python3 scripts/tail_ab.py LABEL [--no-plain]

It prints one line, ``AB {json}``, with:
  - ``card``: the card's name and power limit (nvidia-smi);
  - ``cases``: rows 13 (fused_tail_fwd) and 14 (fused_tail_bwd) at CASES,
    20 heads of 20, Q = 200, on chip_smoke.py's inputs (tail_inputs, the
    seeds of its kernel-fused-tail-long phase): the ms of each row (CUDA
    events), of its plain version (unless --no-plain), a hash of every
    output (out; dqkv, dw1, db1, dw2, db2), the launches per regime, and
    against the plain versions the elements of out and dqkv that differ
    at all (``n_differ``) and that lie outside the smoke's tolerance
    (``n_outside``);
  - ``pins``: in f32, the hashes of the six outputs at PINS on the card
    tests' inputs (tests/test_torch_kernel_gpu.py ``_tail_inputs``, seed
    11, the dropout seed 77), which that file pins.
It uses the checkout's own package and chip_smoke.py, so it runs on older
checkouts too. Without CUDA it exits 1.
"""

import hashlib
import importlib.util
import json
import os
import subprocess
import sys

sys.path.insert(0, os.getcwd())

# (dtype, N, T, masked, dropout, seed): the user encoder over 512-news
# histories in training (bf16 and f32, dropout 0.2) and in serving (f32,
# 64 users, dropout off), and one position past the rows the per-row
# kernels kept in shared memory; the seeds are the smoke's (TAIL_LONG).
CASES = (("bfloat16", 128, 512, True, True, 11),
         ("float32", 128, 512, True, True, 11),
         ("float32", 64, 512, True, False, 13),
         ("bfloat16", 128, 87, True, True, 10),
         ("float32", 128, 87, True, True, 10))
# (N, T, masked, dropout) of the card tests' pinned f32 hashes past T = 64.
PINS = ((4, 512, True, True), (3, 87, False, False), (32, 1000, False, False))


def _hash(x):
    import torch

    bits = x.contiguous().view(
        torch.int16 if x.dtype == torch.bfloat16 else torch.int32)
    return hashlib.sha256(bits.cpu().numpy().tobytes()).hexdigest()[:16]


def _regimes(kernels):
    return {k: kernels.regime_counts(f"fused_tail_{k}")
            for k in ("fwd", "bwd")}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("tail_ab: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from newsrecommendation_tpu_torch.ops import (
        experimental_fused_encoder as fe,
    )
    from newsrecommendation_tpu_torch.ops import kernels

    label = sys.argv[1] if len(sys.argv) > 1 else "run"
    plain = "--no-plain" not in sys.argv
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=False).stdout.strip()
    out = {"label": label, "card": card, "cases": {}, "pins": {}}
    kernels.build(["fused_tail_fwd", "fused_tail_bwd"])

    for dtype, n, t, masked, dropout, seed in CASES:
        qkv, mask, pool, g = cs.tail_inputs(n, t, 20, 20, 200, dtype, masked,
                                            seed)
        sd = torch.tensor([1234567 + seed], dtype=torch.int32, device="cuda")
        args = (qkv, mask, *pool, sd, 20, 0.2, not dropout)
        bargs = (*args[:7], g, *args[7:])
        kernels.reset_launch_counts()
        got = [fe.fused_tail_fwd(*args), *fe.fused_tail_bwd(*bargs)]
        torch.cuda.synchronize()
        case = {"regimes": _regimes(kernels),
                "hashes": [_hash(x) for x in got]}
        ref = [fe.fused_tail_fwd_reference(*args),
               *fe.fused_tail_bwd_reference(*bargs)]
        (f_rtol, f_atol), (b_rtol, b_atol) = cs.TRAIN_TOL[dtype]
        case["n_differ"] = {"out": cs.n_differ(got[0], ref[0]),
                            "dqkv": cs.n_differ(got[1], ref[1])}
        case["n_outside"] = {
            "out": cs.n_outside(got[0], ref[0], f_rtol, f_atol),
            "dqkv": cs.n_outside(got[1], ref[1], b_rtol, b_atol)}
        del got, ref
        iters = 5
        case["fwd_ms"] = cs.time_ms(lambda: fe.fused_tail_fwd(*args), iters)
        case["bwd_ms"] = cs.time_ms(lambda: fe.fused_tail_bwd(*bargs), iters)
        if plain:
            case["fwd_plain_ms"] = cs.time_ms(
                lambda: fe.fused_tail_fwd_reference(*args), 2, 1)
            case["bwd_plain_ms"] = cs.time_ms(
                lambda: fe.fused_tail_bwd_reference(*bargs), 2, 1)
        name = (f"{dtype} {n}x{t}{'m' if masked else ''}"
                f"{' drop' if dropout else ''}")
        out["cases"][name] = case
        print(f"  {name} {json.dumps(case)}", file=sys.stderr, flush=True)

    # by path: an installed package named "tests" may shadow the folder
    spec = importlib.util.spec_from_file_location(
        "tail_ab_card_tests", os.path.join("tests", "test_torch_kernel_gpu.py"))
    card_tests = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(card_tests)
    _tail_inputs = card_tests._tail_inputs
    sd = torch.tensor([77], dtype=torch.int32, device="cuda")
    for n, t, masked, dropout in PINS:
        qkv, mask, pool, g = _tail_inputs(n, t, 20, 20, 200, "float32",
                                          seed=11)
        args = (qkv, mask if masked else None, *pool, sd, 20, 0.2,
                not dropout)
        kernels.reset_launch_counts()
        got = [fe.fused_tail_fwd(*args),
               *fe.fused_tail_bwd(*args[:7], g, *args[7:])]
        out["pins"][f"{n}x{t}{'m' if masked else ''}"
                    f"{' drop' if dropout else ''}"] = {
            "hashes": [_hash(x) for x in got],
            "regimes": _regimes(kernels)}
    print("AB " + json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
